"""The yardstick's arithmetic: the card's peaks, each kernel call's least
work from its shapes, and the useful FLOPs of the tokens a model serves.

Peaks are one NVIDIA H100 SXM's published dense rates (NVIDIA's data sheet,
at its 700 W limit): 989 TFLOP/s bf16, 495 TFLOP/s TF32, 3.35 TB/s of HBM.
A call's least time is the larger of its operations over the peak and its
bytes over the bandwidth.  Bytes count each input read once and each output
written once; operations count what the masks and lengths need, never the
padding or the masked tiles a kernel may compute anyway.
"""

from __future__ import annotations

PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12


def least_seconds(flops: float, nbytes: float, peak: float = PEAK_BF16
                  ) -> float:
    return max(flops / peak, nbytes / PEAK_BYTES)


def _attended(pos: int, window: int | None) -> int:
    """Keys a query at 0-based position ``pos`` sees under a causal mask
    (and a window of ``window`` keys)."""
    return pos + 1 if window is None else min(pos + 1, window)


def causal_pairs(t: int, window: int | None) -> int:
    """(query, key) pairs of a causal prompt of ``t`` tokens."""
    if window is None or window >= t:
        return t * (t + 1) // 2
    return window * (window + 1) // 2 + (t - window) * window


def flash_prefill(t: int, hq: int, hkv: int, hd: int,
                  window: int | None) -> tuple[float, float]:
    """One bf16 flash attention call over one prompt of ``t`` tokens:
    QK^T and PV over the causal pairs; q, k, v read and o written once,
    bf16, and the int32 length."""
    flops = 4.0 * hq * hd * causal_pairs(t, window)
    nbytes = 2.0 * (2 * t * hq * hd + 2 * t * hkv * hd) + 4
    return flops, nbytes


def decode_attention(lengths, hq: int, hkv: int, hd: int,
                     window: int | None) -> tuple[float, float]:
    """One decode attention call (split and combine together) over a cache
    whose rows hold ``lengths`` positions: each row's query against its
    valid keys; the valid bf16 k and v read once, q read and o written
    once, the int32 lengths."""
    b = len(lengths)
    valid = sum(_attended(max(int(n), 1) - 1, window) for n in lengths)
    flops = 4.0 * hq * hd * valid
    nbytes = 2.0 * (valid * 2 * hkv * hd + 2 * b * hq * hd) + 4 * b
    return flops, nbytes


def ssd_intra_chunk(t: int, nh: int, hd: int, n: int, chunk: int
                    ) -> tuple[float, float]:
    """One intra-chunk SSD call over a prompt of ``t`` tokens in chunks of
    ``chunk``.  Per chunk of c rows and p = c(c+1)/2 causal pairs: the
    scores C.B^T (2 n p), the diagonal output over the heads (2 nh hd p)
    and the chunk's states (2 nh c n hd).  The kernel keeps fp32 accuracy
    by three TF32 products per fp32 product (3xTF32), the least that an
    fp32-accurate product costs on the tensor cores, so the operations
    count three times at the TF32 peak (returned already tripled).  Bytes:
    fp32 x.dt (t nh hd), the log-decay cumsum (t nh), B and C (t n each)
    read, y (t nh hd) and the states (chunks nh n hd) written."""
    flops, chunks = 0.0, 0
    for lo in range(0, t, chunk):
        c = min(chunk, t - lo)
        p = c * (c + 1) / 2
        flops += 2 * n * p + 2 * nh * hd * p + 2 * nh * c * n * hd
        chunks += 1
    nbytes = 4.0 * (2 * t * nh * hd + t * nh + 2 * t * n
                    + chunks * nh * n * hd)
    return 3 * flops, nbytes


# ----------------------------------------------------------------- models

def _attn_proj(cfg: dict) -> float:
    d, hq, hkv, hd = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                      cfg["head_dim"])
    return 2.0 * d * hq * hd * 2 + 2.0 * 2 * d * hkv * hd


def _ffn(cfg: dict) -> float:
    m, d = cfg["moe"], cfg["d_model"]
    return 2.0 * d * m["num_experts"] + m["top_k"] * 2.0 * 3 * d * m[
        "d_ff_expert"]


def _mixer(cfg: dict) -> float:
    s, d = cfg["ssm"], cfg["d_model"]
    di, n = s["expand"] * d, s["d_state"]
    nh, hd = di // s["head_dim"], s["head_dim"]
    return (2.0 * d * (2 * di + 2 * n + nh) + 2.0 * di * d
            + 2.0 * s["conv_width"] * (di + 2 * n) + 4.0 * nh * hd * n)


def _per_token(cfg: dict) -> float:
    if cfg["family"] == "moe":
        return _attn_proj(cfg) + _ffn(cfg)
    if cfg["family"] == "ssm":
        return _mixer(cfg)
    raise KeyError(f"no FLOP count for family {cfg['family']!r}")


def _context(cfg: dict, keys: int) -> float:
    """Attention's QK^T and PV FLOPs over ``keys`` (query, key) pairs, all
    layers."""
    if cfg["family"] != "moe":
        return 0.0
    return cfg["n_layers"] * 4.0 * cfg["n_heads"] * cfg["head_dim"] * keys


def prefill_flops(cfg: dict, t: int) -> float:
    """Useful FLOPs of prefilling one prompt of ``t`` tokens: every layer
    on every token (the routed experts only, top-k of them), attention over
    the causal pairs, the head at the one position whose logits are
    computed.  The SSM scan counts its recurrence, 4 nh hd n a token."""
    return (t * cfg["n_layers"] * _per_token(cfg)
            + _context(cfg, causal_pairs(t, cfg.get("sliding_window")))
            + 2.0 * cfg["d_model"] * cfg["vocab"])


def decode_flops(cfg: dict, lengths) -> float:
    """Useful FLOPs of one decode step over the occupied rows (``lengths``
    > 0, each the row's length with the new token): every layer on one
    token a row, attention over the row's keys, the head on every row."""
    rows = [int(n) for n in lengths if n > 0]
    keys = sum(_attended(n - 1, cfg.get("sliding_window")) for n in rows)
    return (len(rows) * (cfg["n_layers"] * _per_token(cfg)
                         + 2.0 * cfg["d_model"] * cfg["vocab"])
            + _context(cfg, keys))
