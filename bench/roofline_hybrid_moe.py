"""The ``hybrid_moe`` family's yardstick (granite-4.0-h-small): each layer's
useful FLOPs by its mixer, and the least bytes of one decode step, beside
``bench/roofline.py``'s peaks and kernel bounds.

FLOPs count what the served tokens need: every layer's projections, the
Mamba-2 conv and its recurrence (4 nh hd n a token: the state update and
the readout), attention's QK^T and PV over the attended keys on the
attention layers alone, the router, the top-k routed experts and the shared
expert, and the head where logits are computed.  The embedding is a
gather.
"""

from __future__ import annotations

from bench import roofline

BF16, FP32 = 2, 4


def _widths(cfg: dict) -> tuple[int, int, int, int, int]:
    """(d_inner, d_state, heads, head_dim, conv channels) of the mixer."""
    s, d = cfg["ssm"], cfg["d_model"]
    di = s["expand"] * d
    return di, s["d_state"], di // s["head_dim"], s["head_dim"], \
        di + 2 * s["d_state"]


def _mamba_flops(cfg: dict) -> float:
    d = cfg["d_model"]
    di, n, nh, hd, conv = _widths(cfg)
    return (2.0 * d * (2 * di + 2 * n + nh) + 2.0 * di * d
            + 2.0 * cfg["ssm"]["conv_width"] * conv + 4.0 * nh * hd * n)


def _attn_flops(cfg: dict) -> float:
    """The projections of one token (the context's are ``_context``)."""
    d, hq, hkv, hd = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                      cfg["head_dim"])
    return 2.0 * d * hq * hd * 2 + 2.0 * 2 * d * hkv * hd


def _moe_flops(cfg: dict) -> float:
    m, d = cfg["moe"], cfg["d_model"]
    return (2.0 * d * m["num_experts"]
            + 6.0 * d * (m["top_k"] * m["d_ff_expert"] + m["d_ff_shared"]))


def per_token_flops(cfg: dict) -> float:
    """Every layer's FLOPs for one token, attention's context aside."""
    mixers = cfg["mixers"]
    return (mixers.count("M") * _mamba_flops(cfg)
            + mixers.count("A") * _attn_flops(cfg)
            + len(mixers) * _moe_flops(cfg))


def _context(cfg: dict, pairs: int) -> float:
    """QK^T and PV over ``pairs`` (query, key) pairs on every attention
    layer."""
    return (cfg["mixers"].count("A") * 4.0 * cfg["n_heads"]
            * cfg["head_dim"] * pairs)


def _head(cfg: dict) -> float:
    return 2.0 * cfg["d_model"] * cfg["vocab"]


def prefill_flops(cfg: dict, t: int) -> float:
    """One prompt of ``t`` tokens: every layer on every token, attention
    over the causal pairs, the head at the last position."""
    return (t * per_token_flops(cfg) + _context(cfg, roofline.causal_pairs(
        t, None)) + _head(cfg))


def decode_flops(cfg: dict, lengths) -> float:
    """One decode step over the occupied rows (``lengths`` > 0, each the
    row's length with its new token): every layer and the head on one
    token a row, attention over each row's keys."""
    rows = [int(n) for n in lengths if n > 0]
    return (len(rows) * (per_token_flops(cfg) + _head(cfg))
            + _context(cfg, sum(rows)))


def decode_bytes(cfg: dict, lengths) -> float:
    """The least bytes of one decode step over the occupied rows: every
    weight read once (bf16; the routed experts min(E, rows · k) of E a
    layer, the tied embedding as the head), the Mamba layers' fp32 state
    and bf16 conv context read and written a row, the attention layers'
    valid bf16 K/V read and the new token's written.  The logits are left
    out."""
    rows = [int(n) for n in lengths if n > 0]
    if not rows:
        return 0.0
    d, v = cfg["d_model"], cfg["vocab"]
    hq, hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    m = cfg["moe"]
    di, n, nh, shd, conv = _widths(cfg)
    cw = cfg["ssm"]["conv_width"]
    na, nm = cfg["mixers"].count("A"), cfg["mixers"].count("M")
    experts = min(m["num_experts"], len(rows) * m["top_k"])
    mamba_w = (d * (2 * di + 2 * n + nh) + (cw + 1) * conv + 3 * nh + di
               + di * d)
    attn_w = 2 * d * hq * hd + 2 * d * hkv * hd
    layer_w = (d * m["num_experts"]
               + 3 * d * (experts * m["d_ff_expert"] + m["d_ff_shared"]))
    weights = BF16 * (len(cfg["mixers"]) * layer_w + nm * mamba_w
                      + na * attn_w + v * d)
    state = nm * len(rows) * 2 * (FP32 * nh * shd * n
                                  + BF16 * (cw - 1) * conv)
    # the keys before each row's new one read, the new one written
    kv = na * BF16 * 2 * hkv * hd * (sum(n - 1 for n in rows) + len(rows))
    return float(weights + state + kv)
