"""The decode combine kernel's grid and its plain versions, on the CPU.

``decode_attention.combine_plan`` sizes the combine kernel's grid from the
shapes alone, and ``combine_lanes`` walks the kernel's index mapping over
it: every (row, 16-byte column) is written by exactly one lane, the lanes
of a column take every partial exactly once, and the grid covers the SMs
wherever the rows and columns allow, at gemma-2b's serving decode shape,
the merge's shape (B=128 x Hq=8) at 1, 2, 4 and 8 ranks in bf16 and fp32,
and each head dim of the kernels' dispatch list.  The kernel itself runs
only on the card (``chip_smoke.check_decode_combine`` and
``check_merge_ranks`` hold it to the plain versions there, and
``scripts/decode_combine_ab.py`` to another checkout's bit for bit).  Then
``ref.decode_merge`` over the shares of a cache against the JAX package's
``decode_attention_naive`` on the whole cache, on the same numpy-seeded
inputs, at tests/test_kernels.py's tolerances, in the cases
tests/test_torch_decode_split.py lacks: one rank, D = 48 and D = 256, each
with a sequence whose every share is empty.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels._wrap import HEAD_DIMS  # noqa: E402
from test_kernels import TOL as JTOL  # noqa: E402
from test_torch_decode_split import DTYPES, _inputs, _shares  # noqa: E402

# (what, rows, partials, bytes a value): gemma-2b's serving decode (B=4 x
# Hq=8 rows, split_plan's 32 splits of fp32 partials) and the merge of
# B=128 x Hq=8 rows over 1, 2, 4 and 8 ranks' bf16 or fp32 outputs
GRIDS = ([("decode gemma-2b", 4 * 8, da.split_plan(4, 1, 1024, None), 4)]
         + [(f"merge R={r} {name}", 128 * 8, r, size)
            for r in (1, 2, 4, 8)
            for name, size in (("bf16", 2), ("fp32", 4))])


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("what,rows,n,itemsize", GRIDS,
                         ids=[g[0] for g in GRIDS])
def test_combine_plan_covers_each_column_and_partial_once(what, rows, n,
                                                          itemsize, d):
    plan = da.combine_plan(rows, n, d, itemsize)
    nv = d * itemsize // da.VEC_BYTES
    chunk, per_block = plan["chunk"], plan["warps"]
    assert chunk in (1, 2, 4, 8, 16, 32) and nv % chunk == 0
    assert per_block in (1, 2, da.COMBINE_WARPS)
    row, col, first, stride = da.combine_lanes(plan, rows, nv)
    live = row >= 0
    # whole warps past the last row, fewer than a block of them
    assert not live.view(-1, 32).any(1).logical_xor(
        live.view(-1, 32).all(1)).any()
    assert (~live).sum() < per_block * 32
    row, col, first, stride = row[live], col[live], first[live], stride[live]
    assert (col >= 0).all() and (col < nv).all()
    # each (row, column) written once: by its lane with the first partial
    written = torch.zeros(rows * nv, dtype=torch.long)
    written.index_add_(0, (row * nv + col)[first == 0],
                       torch.ones(int((first == 0).sum()), dtype=torch.long))
    assert (written == 1).all()
    # each (row, column, partial) taken by exactly one lane
    taken = torch.zeros(rows * nv * n, dtype=torch.long)
    for k in range(-(-n // int(stride.min()))):
        s = first + k * stride
        on = s < n
        idx = ((row * nv + col) * n + s)[on]
        taken.index_add_(0, idx, torch.ones(idx.numel(), dtype=torch.long))
    assert (taken == 1).all()
    # a lane keeps at most COMBINE_LOADS loads in flight wherever 32 lanes
    # a column would
    if -(-n // 32) <= da.COMBINE_LOADS:
        assert -(-n // (32 // chunk)) <= da.COMBINE_LOADS
    # the grid covers the SMs wherever rows x columns allow
    if rows * nv >= da.SMS:
        assert plan["blocks"] >= da.SMS


@pytest.mark.parametrize("rows,n,d,itemsize", [
    (32, 32, 256, 4),       # gemma-2b's serving decode: 32 rows spread
    (1024, 8, 256, 2),      # the merge of 8 shares: rows packed 4 a block
    (8, 128, 256, 4),       # one sequence, 128 splits
    (1024, 2, 256, 4),      # a share of decode_32k, 2 splits
])
def test_combine_plan_from_shapes(rows, n, d, itemsize):
    """Few rows are spread over narrower runs (more warps) until the grid
    covers the SMs; many rows keep whole 32-column runs and pack 4 warps a
    block."""
    plan = da.combine_plan(rows, n, d, itemsize)
    nv = d * itemsize // da.VEC_BYTES
    assert plan["blocks"] >= da.SMS
    if rows * nv // 32 >= 4 * da.SMS and n <= da.COMBINE_LOADS:
        assert plan["chunk"] == 32 and plan["warps"] == da.COMBINE_WARPS
    if rows * nv // 32 < da.SMS:
        assert plan["chunk"] < min(32, nv)


@pytest.mark.parametrize("d,itemsize", [(20, 2), (10, 4), (2, 2)])
def test_combine_plan_refuses_rows_not_in_16_bytes(d, itemsize):
    with pytest.raises(ValueError, match="16-byte"):
        da.combine_plan(8, 2, d, itemsize)


# (b, s, hq, hkv, d, window, shares, lengths), sequence 0 empty in each:
# one rank (the merge of a world of 1), D = 48, D = 256 at gemma-2b's heads
MERGE_CASES = [
    (3, 64, 8, 1, 32, None, 1, [0, 17, 64]),
    (3, 96, 6, 3, 48, None, 3, [0, 40, 96]),
    (3, 96, 6, 3, 48, 20, 3, [0, 33, 96]),
    (2, 128, 8, 1, 256, None, 4, [0, 100]),
    (2, 128, 8, 1, 256, 16, 4, [0, 100]),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("split", [False, True], ids=["naive", "split"])
@pytest.mark.parametrize("case", MERGE_CASES, ids=range(len(MERGE_CASES)))
def test_merge_of_shares_with_an_empty_sequence(case, split, dtype):
    (q, k, v), (jq, jk, jv), lens = _inputs(case, dtype, 5)
    outs, lses = _shares(case, q, k, v, lens, split)
    assert (lses[0] == ref.NEG_INF).all()       # every share of it empty
    got = ref.decode_merge(outs, lses)
    want = jref.decode_attention_naive(jq, jk, jv, jnp.asarray(lens),
                                       window=case[5])
    tol = JTOL[DTYPES[dtype][1]]
    assert got.shape == q.shape and got.dtype == q.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    assert torch.isfinite(got.float()).all()
    assert not got[0].float().abs().any()
