"""The Mamba-2 scan under a sequence split (``layers.mamba_block``,
``layers._ssd_seq_split``): each rank scans its own rows from a zero
state, the ranks' final states and total decays are all-gathered and
folded into the state entering each rank, whose contribution is added to
its output; the conv takes the earlier ranks' last rows as its context.

* The scan alone at (1, 4) (the sequence over ``model``, 4 ranks, at
  chunk-aligned and ragged shares) against the unsharded port's
  ``ops.ssd`` and the reference's ``ssd_chunked`` over the whole sequence;
  one fp32 mixer against the unsharded one.
* mamba2-780m and hymba-1.5b ``seq_tp`` prefill at (2, 2) (the sequence
  over ``data``, heads over ``model``), then ``dp_tp`` decode from that
  cache, against the reference's sharded jit and the unsharded port
  (tests/_sp_serving.py).
* A ``dp_sp_fsdp`` train step's gradients (fp32 compute) within 1e-4 of
  the unsharded port's, leaf by leaf, for both archs.  The reference's
  sharded train step is no oracle (its known failure), so the unsharded
  port is.
"""

import numpy as np
import pytest

from _sp_serving import check, run_cases, tag

torch = pytest.importorskip("torch")

CASES = [(aid, 4, (2, 2), "seq_tp", "dp_tp", None)
         for aid in ("mamba2-780m", "hymba-1.5b")]
IDS = [tag(*c) for c in CASES]
SCAN_MESH = (1, 4)
# (B, T) of the scan alone: 4 chunks of 8 a rank, and 7 rows a rank (the
# chunk padded)
SCAN_SHAPES = ((2, 128), (2, 28))
NH, HD, N, CHUNK = 4, 16, 8, 8
SCAN_TOL = 2e-5           # tests/test_kernels.py's fp32 TOL
GRAD_RTOL = 1e-4
GRAD_B, GRAD_T = 4, 32


def _scan_inputs(b: int, t: int) -> dict:
    rng = np.random.default_rng(7)
    return {"x": rng.standard_normal((b, t, NH, HD)).astype(np.float32),
            "dt": np.log1p(np.exp(rng.standard_normal((b, t, NH))
                                  - 1.0)).astype(np.float32),
            "A": -np.exp(rng.standard_normal(NH) * 0.5).astype(np.float32),
            "B": rng.standard_normal((b, t, N)).astype(np.float32),
            "C": rng.standard_normal((b, t, N)).astype(np.float32),
            "D": rng.standard_normal(NH).astype(np.float32)}


def scan_seq_split(rank: int, meshes: dict) -> dict:
    """The scan over each rank's rows at (1, 4), gathered, beside the
    unsharded ``ops.ssd``; one fp32 mamba2 mixer likewise."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, layers
    from repro_torch.sharding import comm
    from repro_torch.sharding import ctx as shard_ctx
    from repro_torch.sharding.specs import Spec
    mesh = meshes[SCAN_MESH]
    group = mesh.get_group("model")
    act = Spec(None, "model", None)
    out = {}
    for b, t in SCAN_SHAPES:
        a = {k: torch.from_numpy(v) for k, v in _scan_inputs(b, t).items()}
        n = t // 4
        rows = slice(rank * n, (rank + 1) * n)
        with shard_ctx.plan_specs(act, None, mesh=mesh):
            y, h = layers._ssd_seq_split(
                a["x"][:, rows], a["dt"][:, rows], a["A"], a["B"][:, rows],
                a["C"][:, rows], a["D"], CHUNK, None,
                shard_ctx.seq_group())
        y = comm.all_gather(y.movedim(1, 0).contiguous(), group).movedim(0, 1)
        want_y, want_h = ops.ssd(a["x"], a["dt"], a["A"], a["B"], a["C"],
                                 a["D"], chunk=CHUNK)
        out[(b, t)] = {"y": y, "h": h, "want_y": want_y, "want_h": want_h}
    cfg = get_config("mamba2-780m").reduced()
    p = build_model(cfg).init(torch.Generator().manual_seed(0),
                              device="cpu")["layers"]["ssm"]
    p = {k: v[0] for k, v in p.items()}
    x = torch.randn(2, 32, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    compute = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = torch.float32
    try:
        want, wc = layers.mamba_block(cfg, p, x, mode="prefill")
        with shard_ctx.plan_specs(act, None, mesh=mesh):
            got, gc = layers.mamba_block(cfg, p, x[:, rank * 8:rank * 8 + 8],
                                         mode="prefill")
    finally:
        layers.COMPUTE_DTYPE = compute
    got = comm.all_gather(got.movedim(1, 0).contiguous(),
                          group).movedim(0, 1)
    out["mixer"] = {"y": got, "want_y": want, "h": gc["h"],
                    "want_h": wc["h"], "conv": gc["conv"],
                    "want_conv": wc["conv"]}
    return out


def grads_dp_sp_fsdp(rank: int, meshes: dict) -> dict:
    """Each arch's gradients under ``dp_sp_fsdp`` at (2, 2) and unsharded,
    in fp32 compute: the relative error of every leaf."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, layers
    from repro_torch.sharding import MeshDesc, ShardingPlan, specs, spmd
    from repro_torch.training import train_loop, tree
    mesh = meshes[(2, 2)]
    plan = ShardingPlan(arch="t", shape="t",
                        mesh=MeshDesc(("data", "model"), (2, 2)),
                        global_mode="data", local_layout="dp_sp_fsdp",
                        batch_axes=("data",), seq_axes=("model",),
                        tp_axes=(), fsdp_axes=("data", "model"))
    out = {}
    compute = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = torch.float32
    try:
        for aid in ("mamba2-780m", "hymba-1.5b"):
            cfg = get_config(aid).reduced()
            model = build_model(cfg)
            params = model.init(torch.Generator().manual_seed(0),
                                device="cpu")
            rng = np.random.default_rng(11)
            batch = {k: torch.from_numpy(rng.integers(
                0, cfg.vocab, (GRAD_B, GRAD_T)).astype(np.int32))
                for k in ("tokens", "targets")}
            with torch.enable_grad():
                ps = tree.map(lambda q: q.detach().requires_grad_(True),
                              params)
                want = torch.autograd.grad(
                    train_loop.loss_fn(model, ps, batch, remat=False),
                    tree.leaves(ps))
            _, grads = spmd.make_sharded_grad_fn(model, plan, mesh)(
                specs.param_shardings(mesh, params, plan), batch)
            out[aid] = [float(torch.linalg.norm(
                g.full_tensor().double() - w.double())
                / max(float(torch.linalg.norm(w.double())), 1e-30))
                for g, w in zip(tree.leaves(grads), want)]
    finally:
        layers.COMPUTE_DTYPE = compute
    return out


@pytest.fixture(scope="module")
def runs():
    return run_cases(CASES, extra={"scan": scan_seq_split,
                                   "grads": grads_dp_sp_fsdp},
                     meshes=(SCAN_MESH,))


@pytest.mark.parametrize("shape", SCAN_SHAPES,
                         ids=[f"{b}x{t}" for b, t in SCAN_SHAPES])
def test_scan_under_a_sequence_split_equals_the_whole_scan(runs, shape):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    r = runs[1]["scan"][shape]
    np.testing.assert_allclose(r["y"].numpy(), r["want_y"].numpy(),
                               atol=SCAN_TOL, rtol=SCAN_TOL)
    np.testing.assert_allclose(r["h"].numpy(), r["want_h"].numpy(),
                               atol=SCAN_TOL, rtol=SCAN_TOL)
    a = {k: jnp.asarray(v) for k, v in _scan_inputs(*shape).items()}
    jy, jh = jref.ssd_chunked(a["x"], a["dt"], a["A"], a["B"], a["C"],
                              a["D"], chunk=CHUNK)
    np.testing.assert_allclose(r["y"].numpy(), np.asarray(jy),
                               atol=SCAN_TOL, rtol=SCAN_TOL)
    np.testing.assert_allclose(r["h"].numpy(), np.asarray(jh),
                               atol=SCAN_TOL, rtol=SCAN_TOL)


def test_mixer_under_a_sequence_split_equals_the_unsharded_one(runs):
    """The conv's context from the earlier ranks, the scan's state
    exchange; the prompt's state and conv context the whole sequence's on
    every rank."""
    r = runs[1]["scan"]["mixer"]
    for k in ("y", "h", "conv"):
        np.testing.assert_allclose(r[k].numpy(), r[f"want_{k}"].numpy(),
                                   atol=SCAN_TOL, rtol=SCAN_TOL, err_msg=k)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_seq_tp_prefill_equals_the_reference_and_unsharded(runs, case):
    check(runs, case)


@pytest.mark.parametrize("aid", ("mamba2-780m", "hymba-1.5b"))
def test_dp_sp_fsdp_gradients_equal_the_unsharded_port(runs, aid):
    errs = runs[1]["grads"][aid]
    assert errs and max(errs) < GRAD_RTOL, errs

