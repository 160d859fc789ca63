"""Tensors split over two mesh axes: ``tp_all`` at B = 1 (``tp_axes =
("data", "model")``) on 4 gloo ranks of a (2, 2) mesh, prefill and decode,
against the reference's sharded jit and the port's unsharded steps
(harness and what is held: tests/_sp_serving.py).

Under ``tp_all`` ``sanitize`` drops an axis from any entry the dim does not
divide, so a leaf lies over both axes, over ``data`` alone or whole:

* mamba2-780m: ``w_in``, the conv and the scan's heads over both axes;
* hymba-1.5b and mixtral-8x7b: two KV heads, so the cache's heads lie over
  ``data`` and its sequence over ``model``;
* gemma3-1b: one KV head, the sequence over both axes, four shares merged,
  windowed layers whose far shares run empty;
* mamba2-780m at d_model 48: ``w_in`` (214 columns) and the six SSM heads
  over ``data`` alone, the conv, the norm and ``w_out`` over both; every
  crossing must go over the group of the leaf's own axes.

``test_a_leaf_split_over_data_alone_crosses_over_data`` holds one crossing
directly: a weight of 6 columns split over ``data`` alone has, at (2, 2),
the local shape of one split over ``model`` alone; gathered over its
spec's group it is whole, gathered over ``model``'s it is not.
"""

import pytest

from _sp_serving import check, check_split, plan_of, run_cases, tag

torch = pytest.importorskip("torch")

MESH = (2, 2)
CASES = [(aid, 1, MESH, "tp_all", "tp_all", None) for aid in
         ("mamba2-780m", "hymba-1.5b", "gemma3-1b", "mixtral-8x7b")] + [
    ("mamba2-780m", 1, MESH, "tp_all", "tp_all", {"d_model": 48})]
IDS = [tag(*c) for c in CASES]


def crossing_over_data(rank: int, meshes: dict) -> dict:
    """One column crossing of a (8, 6) weight under ``tp_all`` at (2, 2):
    the group ``TPState`` names for it, and its gather over that group and
    over ``model``'s, against the whole product."""
    from repro_torch.models import layers
    from repro_torch.sharding import ctx as shard_ctx
    from repro_torch.sharding import specs, spmd
    mesh = meshes[MESH]
    tp = spmd.tp_state(mesh, plan_of("mamba2-780m", "tp_all", MESH), {})
    gen = torch.Generator().manual_seed(0)
    x, w = torch.randn(3, 8, generator=gen), torch.randn(8, 6, generator=gen)
    spec = specs.sanitize(mesh, specs.Spec(None, ("data", "model")), (8, 6))
    local = specs.local_slice(mesh, spec, w)
    with shard_ctx.tensor_parallel(tp):
        g = layers._wsplit(local, 6)
        (got,) = layers._cols_to([x @ local], [g], shard_ctx.NO_SPLIT)
        (wrong,) = layers._whole_cols([x @ local], [tp.groups[("model",)]])
    return {"spec": tuple(spec), "axes": g.axes, "local": tuple(local.shape),
            "err": float((got - x @ w).abs().max()),
            "wrong_err": float((wrong - x @ w).abs().max())}


@pytest.fixture(scope="module")
def runs():
    return run_cases(CASES, extra={"crossing": crossing_over_data})


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_steps_equal_the_reference_and_unsharded(runs, case):
    check(runs, case)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_weights_stay_split_and_activations_cross(runs, case):
    check_split(runs, case)


def test_leaves_lie_over_the_axes_their_specs_name(runs):
    """At d_model 48 the layers saw ``w_in`` and the SSM heads' vectors
    split over ``data`` alone, the conv over both axes."""
    seen = runs[1][tag(*CASES[-1])]["got"]["seen"]
    axes = {path[-1]: a for path, a, _, _ in seen}
    assert axes["w_in"] == ("data",), axes
    assert axes["A_log"] == ("data",), axes
    assert axes["conv"] == ("data", "model"), axes


def test_a_leaf_split_over_data_alone_crosses_over_data(runs):
    r = runs[1]["crossing"]
    assert r["spec"] == (None, "data") and r["axes"] == ("data",), r
    assert r["local"] == (8, 3), r
    assert r["err"] < 1e-5, r
    assert r["wrong_err"] > 1e-1, r
