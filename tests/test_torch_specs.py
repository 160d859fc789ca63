"""The port's sharding specs (``repro_torch.sharding.specs``) and abstract
trees (``Model.param_specs/input_specs/cache_specs``,
``optimizer.init_abstract``) against the JAX package's.

Specs are compared entry by entry with the reference's ``PartitionSpec``s
for every leaf of every arch's full-size parameter, batch and cache trees,
under every applicable plan on the two TPU meshes (``plan_tpu``) and the two
GPU meshes (``plan_gpu``; the JAX package has no GPU planner, so the
reference renders the port's plan, rebuilt field by field as its own
``ShardingPlan``).  The abstract trees must have the reference's shapes and
dtypes leaf for leaf.  No device, no process group: a spec is arithmetic on
shapes and the mesh's axis sizes.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import SHAPES as JSHAPES  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.sharding import plan as jplan  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
from repro.training import optimizer as joptim  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import SHAPES, build_model, shape_applicable  # noqa: E402
from repro_torch.sharding import (GPU_MULTI_NODE, GPU_NODE,  # noqa: E402
                                  MULTI_POD, SINGLE_POD, plan_gpu, plan_tpu,
                                  specs)
from repro_torch.training import optimizer as optim  # noqa: E402
from repro_torch.training import tree  # noqa: E402

MESHES = {"single_pod": SINGLE_POD, "multi_pod": MULTI_POD,
          "gpu_node": GPU_NODE, "gpu_multi_node": GPU_MULTI_NODE}
TPU_MESHES = ("single_pod", "multi_pod")


def _jmesh(desc):
    """What the reference's ``sanitize`` reads of a Mesh: its axis names
    and device grid shape."""
    return types.SimpleNamespace(axis_names=desc.axes,
                                 devices=np.empty(desc.shape))


def _jplan(plan):
    """The port's plan as the reference's ``ShardingPlan``."""
    fields = {f.name: getattr(plan, f.name)
              for f in dataclasses.fields(jplan.ShardingPlan)}
    fields["mesh"] = jplan.MeshDesc(plan.mesh.axes, plan.mesh.shape)
    return jplan.ShardingPlan(**fields)


def _plans(aid: str, mesh_name: str):
    """Every applicable shape's plan, and the full-size model, on a mesh."""
    cfg = get_config(aid)
    model = build_model(cfg)
    planner = plan_tpu if mesh_name in TPU_MESHES else plan_gpu
    out = []
    for sname, shape in SHAPES.items():
        if shape_applicable(cfg, shape)[0]:
            out.append((sname, planner(model, shape, MESHES[mesh_name])))
    return model, out


def _paths(tree_, prefix=()):
    """(path, leaf) of a nested dict, in ``jax.tree.leaves`` order."""
    if isinstance(tree_, dict):
        return [pl for k in sorted(tree_)
                for pl in _paths(tree_[k], prefix + (k,))]
    return [(prefix, tree_)]


def _entries(spec) -> tuple:
    return tuple(tuple(spec))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("aid", ARCH_IDS)
def test_specs_equal_the_references(aid, mesh_name):
    """param_pspec, sanitize, batch_pspec, cache_pspec and the logits spec,
    entry by entry, for every leaf under every applicable plan."""
    desc = MESHES[mesh_name]
    jm = _jmesh(desc)
    model, plans = _plans(aid, mesh_name)
    jmodel = jbuild_model(jget_config(aid))
    params = _paths(model.param_specs())
    jleaves = jax.tree_util.tree_flatten_with_path(
        jmodel.param_specs(jnp.float32))[0]
    assert [p for p, _ in params] == [
        tuple(k.key for k in path) for path, _ in jleaves]
    checked = 0
    for sname, plan in plans:
        jp = _jplan(plan)
        for (path, leaf), (jpath, jleaf) in zip(params, jleaves):
            want = jspecs.param_pspec(jpath, jleaf, jp)
            got = specs.param_pspec(path, leaf, plan)
            assert _entries(got) == _entries(want), (sname, path)
            shape = tuple(leaf.shape)
            assert _entries(specs.sanitize(desc, got, shape)) == _entries(
                jspecs.sanitize(jm, want, shape)), (sname, path)
            checked += 1
        for k, v in model.input_specs(SHAPES[sname]).items():
            jv = jmodel.input_specs(JSHAPES[sname])[k]
            want = jspecs.batch_pspec(k, jv, jp)
            assert _entries(specs.batch_pspec(k, v, plan)) == _entries(want)
            assert _entries(specs.sanitize(desc, specs.batch_pspec(
                k, v, plan), tuple(v.shape))) == _entries(
                jspecs.sanitize(jm, want, tuple(jv.shape)))
        cache = _paths(model.cache_specs(SHAPES[sname]))
        jcache = jax.tree_util.tree_flatten_with_path(
            jmodel.cache_specs(JSHAPES[sname]))[0]
        for (path, leaf), (jpath, jleaf) in zip(cache, jcache):
            want = jspecs.cache_pspec(jpath, jleaf, jp)
            got = specs.cache_pspec(path, leaf, plan)
            assert _entries(got) == _entries(want), (sname, path)
            assert _entries(specs.sanitize(desc, got, tuple(leaf.shape))) \
                == _entries(jspecs.sanitize(jm, want, tuple(leaf.shape)))
        lshape = (SHAPES[sname].global_batch, 1, model.cfg.vocab)
        jls = jspecs.logits_sharding(
            jax.sharding.AbstractMesh(desc.shape, desc.axes), jp)
        assert _entries(specs.logits_pspec(desc, plan)) == _entries(jls.spec)
        assert _entries(specs.logits_pspec(desc, plan, lshape)) == _entries(
            jspecs.sanitize(jm, jls.spec, lshape))
    assert checked == len(params) * len(plans) > 0


def _shapes_dtypes(t):
    return [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for x in tree.leaves(t)]


def _jshapes_dtypes(t):
    return [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(t)]


@pytest.mark.parametrize("aid", ARCH_IDS)
def test_abstract_trees_have_the_references_shapes(aid):
    """param_specs (fp32 and bf16), input_specs and cache_specs of every
    shape, and init_abstract (with and without master copies) are meta
    tensors with the reference's shapes and dtypes, leaf for leaf."""
    model, jmodel = build_model(get_config(aid)), jbuild_model(
        jget_config(aid))
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        ps, jps = model.param_specs(dt), jmodel.param_specs(jdt)
        assert all(x.is_meta for x in tree.leaves(ps))
        assert _shapes_dtypes(ps) == _jshapes_dtypes(jps)
    for sname, shape in SHAPES.items():
        got, want = model.input_specs(shape), jmodel.input_specs(
            JSHAPES[sname])
        assert list(got) == list(want)
        assert _shapes_dtypes(got) == _jshapes_dtypes(want)
        assert _shapes_dtypes(model.cache_specs(shape)) == _jshapes_dtypes(
            jmodel.cache_specs(JSHAPES[sname]))
    ps, jps = model.param_specs(), jmodel.param_specs(jnp.float32)
    for master in (False, True):
        for sd, jsd in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            st = optim.init_abstract(ps, sd, master=master)
            jst = joptim.init_abstract(jps, jsd, master=master)
            assert st.step.is_meta and st.step.dtype == torch.int32
            assert _shapes_dtypes(st) == _jshapes_dtypes(jst)


def test_placements_follow_the_spec():
    """A spec's DTensor placements: Shard on each named axis, an entry of
    several axes on every one of them (in the mesh's order), Replicate
    elsewhere; the local shape divides the named dims."""
    from torch.distributed.tensor import Replicate, Shard
    desc = GPU_MULTI_NODE
    sp = specs.Spec(None, ("data", "model"), "pod")
    assert specs.placements(desc, sp) == (Shard(2), Shard(1), Shard(1))
    assert specs.placements(desc, specs.Spec()) == (Replicate(),) * 3
    assert specs.local_shape(desc, sp, (3, 16, 4)) == (3, 2, 2)
    with pytest.raises(NotImplementedError):
        specs.placements(desc, specs.Spec(("model", "data")))
