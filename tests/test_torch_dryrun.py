"""The port's dry-run (``repro_torch.launch.dryrun``) on the CPU: the
collective-bytes sum on a recorded sequence, in the manner of
tests/test_dryrun_tools.py's HLO parser test; ``run_cell`` at the fake
world of ``GPU_NODE`` (8 ranks) and ``GPU_MULTI_NODE`` (16) for reduced
configurations, whose argument bytes must be the sum of one rank's shards
and whose FLOPs per GPU must agree with the analytic ``step_flops``; the
GPipe pipeline under ``force_global="model"``; training under ``tp_axes``
(``dp_tp``, ``dp_tp_fsdp``, qwen3's ``dp_tp_ep``); the tensor-parallel
serving cells (a decode cell over its cache, a prefill cell), a decode
cell under a forced ``P1_pure_dp`` with its cache among the arguments; the
serving cells beside a sequence split or over two axes (``ctx_tp``,
``ctx_tp_ep``, ``tp_all`` at B = 1, ``seq_tp``); and a layout the port has
no step for (``ctx_tp`` training) recorded ``not_ported``.  No process
group outlives a cell.
"""

import dataclasses
import logging

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import SHAPES, build_model  # noqa: E402
from repro_torch.sharding import GPU_MULTI_NODE, GPU_NODE, plan_gpu  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402
from repro_torch.training import tree  # noqa: E402

logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
    logging.ERROR)

RECORDS = [
    ("_c10d_functional::all_gather_into_tensor", [((512, 256),
                                                    torch.float32)]),
    ("_c10d_functional::all_reduce", [((64, 64), torch.bfloat16)]),
    ("_c10d_functional::reduce_scatter_tensor", [((32,), torch.float32)]),
    ("_c10d_functional::all_to_all_single", [((4, 8), torch.float32),
                                             ((4, 8), torch.float32)]),
    ("c10d::recv_", [((16, 2), torch.int32)]),
    ("_c10d_functional::wait_tensor", [((999, 999), torch.float32)]),
    ("aten::mm", [((999, 999), torch.float32)]),
]


def test_collective_bytes_sum():
    out = dryrun.collective_bytes(RECORDS)
    assert out["all-gather"] == 512 * 256 * 4
    assert out["all-reduce"] == 64 * 64 * 2
    assert out["reduce-scatter"] == 32 * 4
    assert out["all-to-all"] == 2 * 4 * 8 * 4
    assert out["collective-permute"] == 16 * 2 * 4
    assert out["total"] == sum(v for k, v in out.items() if k != "total")
    assert dryrun.collective_bytes(RECORDS[-2:])["total"] == 0


def _nbytes(shape, dtype) -> int:
    n = 1
    for s in shape:
        n *= s
    return n * torch.empty((), dtype=dtype).element_size()


def _shard_bytes(model, shape, plan, mesh) -> int:
    """One rank's parameters, AdamW state and batch, from the plan's specs
    alone."""
    master = plan.param_dtype == "bfloat16"
    pdt = torch.bfloat16 if master else torch.float32
    sdt = torch.bfloat16 if plan.opt_dtype == "bfloat16" else torch.float32
    params = model.param_specs(pdt)

    def leaf_bytes(path, p):
        spec = specs.sanitize(mesh, specs.param_pspec(path, p, plan),
                              tuple(p.shape))
        local = specs.local_shape(mesh, spec, tuple(p.shape))
        return (_nbytes(local, p.dtype) + 2 * _nbytes(local, sdt)
                + (_nbytes(local, torch.float32) if master else 0))
    total = sum(tree.leaves(specs.tree_map_with_path(leaf_bytes, params)))
    batch = model.input_specs(shape)
    for k, v in specs.batch_specs_tree(mesh, batch, plan).items():
        total += _nbytes(specs.local_shape(mesh, v, tuple(batch[k].shape)),
                         batch[k].dtype)
    return total + 4                              # the int32 step


CELLS = [("gemma-2b", False), ("qwen3-moe-30b-a3b", False),
         ("gemma-2b", True)]


@pytest.mark.parametrize("aid,multi_node", CELLS)
def test_train_cell_at_fake_world(aid, multi_node):
    cfg = get_config(aid).reduced()
    desc = GPU_MULTI_NODE if multi_node else GPU_NODE
    rec = dryrun.run_cell(aid, "train_4k", multi_node, out_dir=None,
                          cfg=cfg)
    assert rec["status"] == "ok", rec
    model, shape = build_model(cfg), SHAPES["train_4k"]
    plan = plan_gpu(model, shape, desc)
    assert rec["plan"]["layout"] == plan.local_layout
    assert rec["memory"]["argument_bytes"] == _shard_bytes(
        model, shape, plan, desc)
    assert rec["memory"]["peak_per_device"] >= rec["memory"][
        "argument_bytes"]
    # FLOPs per GPU against the useful FLOPs of one GPU's share: remat runs
    # the forward twice (4/3 of 6ND) and the chunked CE recomputes its
    # logits; nothing runs three times
    useful = model.step_flops(shape) / desc.total_chips
    assert 4 / 3 * 0.97 * useful <= rec["cost"]["flops"] <= 2.5 * useful
    assert rec["cost"]["attention_flops"] > 0
    coll = rec["collectives"]
    assert coll["total"] == sum(v for k, v in coll.items() if k != "total")
    assert coll.get("all-reduce", 0) + coll.get("reduce-scatter", 0) > 0
    if plan.moe_impl.startswith("ep_a2a"):
        assert coll["all-to-all"] > 0
    if plan.seq_axes or plan.fsdp_axes:
        assert coll["all-gather"] > 0


def test_pipeline_cell_at_fake_world():
    """``force_global="model"`` on two nodes: the GPipe step over ``pod``,
    its activations crossing as point-to-point collective-permutes."""
    cfg = dataclasses.replace(get_config("gemma-2b").reduced(), n_layers=4)
    rec = dryrun.run_cell("gemma-2b", "train_4k", True, out_dir=None,
                          cfg=cfg, force_global="model")
    assert rec["status"] == "ok", rec
    assert rec["plan"]["pipeline_stages"] == 2
    assert rec["collectives"]["collective-permute"] > 0


TP_TRAIN_CELLS = [("gemma-2b", "dp_tp"), ("gemma-2b", "dp_tp_fsdp"),
                  ("qwen3-moe-30b-a3b", "dp_tp_ep")]


@pytest.mark.parametrize("aid,layout", TP_TRAIN_CELLS)
def test_tensor_parallel_train_cell_at_fake_world(aid, layout):
    """Training under ``tp_axes`` (only ``--layout`` reaches it) traces:
    every weight split over ``model`` stays split, the arguments are one
    rank's shards, and the gradients cross back through the crossings'
    backward (the all-gathers' reduce-scatters) and all-reduces."""
    cfg = get_config(aid).reduced()
    rec = dryrun.run_cell(aid, "train_4k", False, out_dir=None, cfg=cfg,
                          force_layout=layout)
    assert rec["status"] == "ok", rec
    assert rec["plan"]["tp_axes"] == ("model",)
    assert rec["plan"]["layout"] == layout
    model, shape = build_model(cfg), SHAPES["train_4k"]
    plan = plan_gpu(model, shape, GPU_NODE, force_layout=layout)
    assert rec["memory"]["argument_bytes"] == _shard_bytes(
        model, shape, plan, GPU_NODE)
    assert rec["memory"]["peak_per_device"] >= rec["memory"][
        "argument_bytes"]
    assert rec["cost"]["flops"] > 0 and rec["cost"]["attention_flops"] > 0
    coll = rec["collectives"]
    assert coll["reduce-scatter"] > 0 and coll["all-reduce"] > 0, coll
    if plan.moe_impl.startswith("ep_a2a"):
        assert coll["all-to-all"] > 0
    assert "[OK]" in dryrun.line(rec)


def test_tensor_parallel_beside_a_sequence_split_is_not_ported():
    """``ctx_tp`` (the sequence over ``data``, tensors over ``model``) has
    no train step: the dry-run records it ``not_ported`` and the step
    refuses it.  ``plan_gpu`` offers it for decode only, so the plan is
    built here."""
    from repro_torch.sharding import MeshDesc, ShardingPlan, spmd
    from repro_torch.training import optimizer as optim
    plan = ShardingPlan(arch="gemma-2b", shape="train_4k",
                        mesh=MeshDesc(("data", "model"), (1, 8)),
                        global_mode="data", local_layout="ctx_tp",
                        batch_axes=(), seq_axes=("data",),
                        tp_axes=("model",))
    why = dryrun.not_ported(plan, SHAPES["train_4k"])
    assert why is not None and "sequence split" in why
    with pytest.raises(NotImplementedError, match="ctx_tp"):
        spmd.make_sharded_train_step(
            build_model(get_config("gemma-2b").reduced()),
            optim.OptConfig(), plan, None)


def _serving_bytes(model, shape, plan, mesh) -> int:
    """One rank's bf16 parameters, decode cache and batch, from the plan's
    specs alone."""
    def local_bytes(spec, leaf):
        return _nbytes(specs.local_shape(mesh, spec, tuple(leaf.shape)),
                       leaf.dtype)
    params = model.param_specs(torch.bfloat16)
    total = sum(tree.leaves(specs.tree_map_with_path(
        lambda path, p: local_bytes(specs.sanitize(
            mesh, specs.param_pspec(path, p, plan), tuple(p.shape)), p),
        params)))
    if shape.kind == "decode":
        cache = model.cache_specs(shape)
        sp = specs.cache_specs_tree(mesh, cache, plan)
        total += sum(local_bytes(sp[k], v) for k, v in cache.items())
    batch = model.input_specs(shape)
    for k, v in specs.batch_specs_tree(mesh, batch, plan).items():
        total += local_bytes(v, batch[k])
    return total


SERVING_CELLS = [("gemma-2b", "decode_32k", None),
                 ("mistral-large-123b", "prefill_32k", "dp_tp"),
                 ("gemma-2b", "decode_32k", "P1_pure_dp")]


@pytest.mark.parametrize("aid,shape_name,layout", SERVING_CELLS)
def test_serving_cell_at_fake_world(aid, shape_name, layout):
    """The tensor-parallel serving steps trace: gemma-2b's decode_32k as
    ``plan_gpu`` plans it (``dp_tp``: its one KV head puts the cache's
    sequence over ``model``), mistral-large-123b's prefill_32k under
    ``dp_tp`` (at full size ``plan_gpu`` picks it), and a decode cell under
    a forced ``P1_pure_dp``, which traces ``apply_decode`` over the cache
    too.  The arguments are one rank's shards, the cache's included."""
    cfg = get_config(aid).reduced()
    rec = dryrun.run_cell(aid, shape_name, False, out_dir=None, cfg=cfg,
                          force_layout=layout)
    assert rec["status"] == "ok", rec
    model, shape = build_model(cfg), SHAPES[shape_name]
    plan = plan_gpu(model, shape, GPU_NODE, force_layout=layout)
    assert rec["plan"]["layout"] == plan.local_layout
    assert rec["memory"]["argument_bytes"] == _serving_bytes(
        model, shape, plan, GPU_NODE)
    assert rec["memory"]["peak_per_device"] >= rec["memory"][
        "argument_bytes"]
    assert rec["cost"]["attention_flops"] > 0
    coll = rec["collectives"]
    if plan.tp_axes:
        assert plan.local_layout.startswith("dp_tp")
        assert coll["all-reduce"] > 0
    else:
        assert coll["total"] == 0
    if shape.kind == "decode":
        cache = model.cache_specs(shape)
        sp = specs.cache_specs_tree(GPU_NODE, cache, plan)
        cache_bytes = sum(_nbytes(specs.local_shape(
            GPU_NODE, sp[k], tuple(v.shape)), v.dtype)
            for k, v in cache.items())
        assert rec["memory"]["argument_bytes"] > cache_bytes > 0


def test_inapplicable_cell_is_skipped():
    rec = dryrun.run_cell("gemma-2b", "long_500k", False, out_dir=None)
    assert rec["status"] == "skipped"


SPLIT_SERVING_CELLS = [("gemma-2b", "decode_32k", "ctx_tp"),
                       ("mixtral-8x7b", "decode_32k", "ctx_tp_ep"),
                       ("mamba2-780m", "long_500k", "tp_all"),
                       ("gemma-2b", "prefill_b4", "seq_tp")]


@pytest.mark.parametrize("aid,shape_name,layout", SPLIT_SERVING_CELLS)
def test_serving_cell_beside_a_sequence_split_or_over_two_axes(
        aid, shape_name, layout):
    """The serving layouts that put a sequence split beside tensor
    parallelism (``ctx_tp``, its ``_ep`` variant, ``seq_tp`` on a prefill
    of B = 4) or split tensors over two axes (``tp_all`` at B = 1) trace at
    the fake world of ``GPU_NODE``: ``not_ported`` is None, the arguments
    are one rank's shards, the cache's included, and the steps cross the
    tp group."""
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.models.config import ShapeConfig
    cfg = get_config(aid).reduced()
    model = build_model(cfg)
    shape = (ShapeConfig(shape_name, 1024, 4, "prefill")
             if shape_name == "prefill_b4" else SHAPES[shape_name])
    plan = plan_gpu(model, shape, GPU_NODE, force_layout=layout)
    assert plan.local_layout == layout
    assert dryrun.not_ported(plan, shape) is None
    prev = kernel_ops.get_backend()
    kernel_ops.set_backend("blocked")
    try:
        with dryrun.fake_world(GPU_NODE) as mesh:
            rec = dryrun.trace_cell(model, shape, plan, mesh)
    finally:
        kernel_ops.set_backend(prev)
    assert rec["memory"]["argument_bytes"] == _serving_bytes(
        model, shape, plan, GPU_NODE)
    assert rec["memory"]["peak_per_device"] >= rec["memory"][
        "argument_bytes"]
    assert rec["cost"]["attention_flops"] > 0 or cfg.family == "ssm"
    coll = rec["collectives"]
    assert coll["all-reduce"] > 0 and coll["all-gather"] > 0, coll
