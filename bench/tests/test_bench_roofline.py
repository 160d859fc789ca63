"""The yardstick's counts against shapes worked by hand."""

import json

import pytest

from bench import roofline, spec


def _conf(name):
    return json.load(open(spec.BENCH / "configs" / f"{name}.json"))


def test_causal_pairs():
    assert roofline.causal_pairs(4, None) == 10          # 1+2+3+4
    assert roofline.causal_pairs(6, 2) == 3 + 4 * 2      # 1+2, then 2 each
    assert roofline.causal_pairs(3, 10) == 6


def test_flash_prefill_by_hand():
    flops, nbytes = roofline.flash_prefill(4, hq=2, hkv=1, hd=8,
                                           window=None)
    assert flops == 4 * 2 * 8 * 10
    # q and o: 4 x 2 x 8 bf16 each; k and v: 4 x 1 x 8 bf16 each; length
    assert nbytes == 2 * (2 * 64 + 2 * 32) + 4


def test_decode_attention_by_hand():
    flops, nbytes = roofline.decode_attention([3, 1, 5], hq=4, hkv=2,
                                              hd=16, window=4)
    valid = 3 + 1 + 4
    assert flops == 4 * 4 * 16 * valid
    assert nbytes == 2 * (valid * 2 * 2 * 16 + 2 * 3 * 4 * 16) + 4 * 3


def test_ssd_by_hand():
    # t = 3 in chunks of 2: chunks of 2 and 1 rows, 3 and 1 causal pairs
    flops, nbytes = roofline.ssd_intra_chunk(3, nh=2, hd=4, n=8, chunk=2)
    one = sum(2 * 8 * p + 2 * 2 * 4 * p + 2 * 2 * c * 8 * 4
              for c, p in ((2, 3), (1, 1)))
    assert flops == 3 * one
    assert nbytes == 4 * (2 * 3 * 2 * 4 + 3 * 2 + 2 * 3 * 8 + 2 * 2 * 8 * 4)


def test_least_seconds_takes_the_larger_bound():
    assert roofline.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 3.35e12) == pytest.approx(1.0)


def test_mixtral_counts_the_routed_experts():
    c = _conf("mixtral-8x7b-l8")
    d, f = 4096, 14336
    per_token_layer = (2 * d * 32 * 128 * 2 + 2 * 2 * d * 8 * 128
                       + 2 * d * 8 + 2 * 2 * 3 * d * f)
    t = 1000
    want = (t * 8 * per_token_layer + 8 * 4 * 32 * 128 * t * (t + 1) / 2
            + 2 * d * 32000)
    assert roofline.prefill_flops(c, t) == pytest.approx(want)
    # about 2 x 0.7 GFLOP of experts a token and layer, not 8 x
    assert 0.7e9 < per_token_layer < 0.9e9
    step = roofline.decode_flops(c, [10, 0, 3])
    assert step == pytest.approx(2 * (8 * per_token_layer + 2 * d * 32000)
                                 + 8 * 4 * 32 * 128 * 13)


def test_mamba2_counts_the_recurrence():
    c = _conf("mamba2-780m")
    d, di, n, nh, hd = 1536, 3072, 128, 48, 64
    per = (2 * d * (2 * di + 2 * n + nh) + 2 * di * d
           + 2 * 4 * (di + 2 * n) + 4 * nh * hd * n)
    assert roofline.decode_flops(c, [5, 7]) == pytest.approx(
        2 * (48 * per + 2 * d * 50280))
    assert roofline.prefill_flops(c, 100) == pytest.approx(
        100 * 48 * per + 2 * d * 50280)
