"""Plain PyTorch versions of the kernels, ported from ``repro.kernels.ref``.

Two tiers per op, as in the JAX package:
  * ``*_naive``   — direct einsum/softmax math (attention) or the sequential
                    recurrence (SSD); the correctness oracle.
  * ``*_blocked`` / ``ssd_chunked`` — the block algorithm the kernels run;
                    numerically equivalent to naive.

``ssd_intra_chunk`` is the plain version of the SSD intra-chunk kernel alone
(the body of the Pallas kernel in ``repro/kernels/ssd_scan.py``);
``ssd_intra_chunk_tf32`` models that kernel's arithmetic (3xTF32 products
over its tiles), ``ssd_intra_chunk_bwd_tf32`` its backward kernel's,
``attention_bwd_split`` the bf16 flash backward kernel's (its tile walk,
bf16 roundings and split sums), and ``decode_attention_split`` the decode
kernels' split algorithm.

``ops`` sends CPU tensors here; CUDA tensors go to the hand-written kernels,
which ``chip_smoke.py`` holds against these functions on the card.

Conventions (throughout the port): q ``(B, Tq, Hq, D)``, k/v
``(B, Tk, Hkv, D)`` with ``Hq % Hkv == 0``; q head ``h`` reads kv head
``h // g``; masked scores are ``NEG_INF = -1e30`` (not ``-inf``); softmax in
fp32; a row whose every key is masked returns 0.  SSD: x ``(b, t, nh, hd)``,
dt ``(b, t, nh)``, A and D ``(nh,)``, B/C ``(b, t, n)``, state
``(b, nh, hd, n)`` in fp32.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _gqa_expand(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B,T,Hq,D) → (B,T,Hkv,G,D) grouped view for GQA einsums."""
    b, t, hq, d = q.shape
    return q.reshape(b, t, n_kv, hq // n_kv, d)


def _as_lengths(lengths, b: int, device) -> torch.Tensor | None:
    if lengths is None:
        return None
    return torch.as_tensor(lengths, device=device).reshape(b)


# --------------------------------------------------------------------------
# Attention — naive oracle
# --------------------------------------------------------------------------

def _scale(d: int, scale: float | None) -> float:
    """The scores' scale: ``scale`` where given, else 1 / sqrt(d)."""
    return 1.0 / math.sqrt(d) if scale is None else scale


def _masked_scores(q: torch.Tensor, k: torch.Tensor, *, causal: bool,
                   window: int | None, q_offset: int, lengths,
                   scale: float | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Scaled fp32 scores (B, Hkv, G, Tq, Tk), NEG_INF where masked, and the
    mask, broadcastable to them."""
    b, tq, hq, d = q.shape
    _, tk, hkv, _ = k.shape
    qg = _gqa_expand(q, hkv)
    scale = _scale(d, scale)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    qpos = q_offset + torch.arange(tq, device=q.device)[:, None]
    kpos = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    lengths = _as_lengths(lengths, b, q.device)
    if lengths is not None:
        mask = mask[None] & (kpos[None] < lengths[:, None, None])
        mask = mask[:, None, None]                       # (b,1,1,tq,tk)
    else:
        mask = mask[None, None, None]
    return torch.where(mask, s, NEG_INF), mask


def attention_naive(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0,
                    lengths: torch.Tensor | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Full-materialisation attention.  ``q_offset`` is the absolute position
    of q[0]; ``lengths`` (B,) masks the KV suffix (per-sequence fill);
    ``scale`` multiplies the scores (1 / sqrt(D) by default)."""
    return attention_lse_naive(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, lengths=lengths,
                               scale=scale)[0]


def attention_lse_naive(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        q_offset: int = 0,
                        lengths: torch.Tensor | None = None,
                        scale: float | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """``attention_naive``'s output and the natural-log log-sum-exp of each
    row's scaled scores over its valid keys, fp32 (B, Hq, Tq); NEG_INF for a
    row with no valid key.  The plain version of the flash kernel's forward
    with its ``lse`` output, which the backward reads."""
    b, tq, hq, d = q.shape
    s, mask = _masked_scores(q, k, causal=causal, window=window,
                             q_offset=q_offset, lengths=lengths, scale=scale)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)         # 0 on masked rows
    l = p.sum(-1, keepdim=True)
    p = p / l.clamp_min(1e-30)                           # fully-masked row → 0
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    lse = torch.where(l > 0, m + torch.log(l), NEG_INF)  # (b,hkv,g,tq,1)
    return (o.reshape(b, tq, hq, d).to(q.dtype),
            lse.reshape(b, hq, tq))


def attention_bwd_naive(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        q_offset: int = 0,
                        lengths: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The FlashAttention-2 backward equations, the plain version of the
    backward kernel.  ``o`` and ``lse`` are the forward's
    (``attention_lse_naive``), ``do`` the output's gradient.  In fp32:
    Δ = rowsum(dO∘O), P = exp(S − lse) (0 where masked), dV = Pᵀ dO,
    dP = dO Vᵀ, dS = P∘(dP − Δ), dQ = dS K·scale and dK = dSᵀ Q·scale, dK
    and dV summed over each GQA group.  Returns (dq, dk, dv) in the dtypes
    of q, k and v; a row with no valid key gets zero gradients."""
    b, tq, hq, d = q.shape
    _, tk, hkv, _ = k.shape
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    s, mask = _masked_scores(q, k, causal=causal, window=window,
                             q_offset=q_offset, lengths=lengths)
    p = torch.where(mask, torch.exp(s - lse.float().reshape(
        b, hkv, g, tq, 1)), 0.0)                         # (b,hkv,g,tq,tk)
    dog = _gqa_expand(do, hkv).float()                   # (b,tq,hkv,g,d)
    delta = (dog * _gqa_expand(o, hkv).float()).sum(-1)  # (b,tq,hkv,g)
    delta = delta.permute(0, 2, 3, 1)[..., None]         # (b,hkv,g,tq,1)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = p * (dp - delta)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds,
                      _gqa_expand(q, hkv).float()) * scale
    return (dq.reshape(b, tq, hq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def attention_bwd_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        q_offset: int = 0,
                        lengths: torch.Tensor | None = None,
                        n_splits: int | None = None,
                        bf16_products: bool | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The arithmetic of the bf16 backward kernel
    (``csrc/flash_attention_bwd.cu``) on ``attention_bwd_naive``'s
    equations: P and dS rounded to bf16 for their products (with
    ``bf16_products``; by default where q is bf16), dK and dV summed per
    split of the GQA group (``flash_attention.bwd_plan``'s, or
    ``n_splits``) over the split's heads and 64-row query tiles in the
    kernel's order, the splits' fp32 partials added in split order, and dQ
    as the dQ kernel forms it, the rounded dS tiles times K summed over the
    64-key tiles in order.  Tiles the kernel skips add exact zeros here."""
    from .flash_attention import BWD_TILE, bwd_plan

    b, tq, hq, d = q.shape
    _, tk, hkv, _ = k.shape
    g = hq // hkv
    t = BWD_TILE
    ns = (bwd_plan(b, tq, tk, hq, hkv, d, causal=causal, window=window,
                   q_offset=q_offset)["splits"]
          if n_splits is None else n_splits)
    rnd = q.dtype == torch.bfloat16 if bf16_products is None \
        else bf16_products

    def r(x):
        return x.to(torch.bfloat16).float() if rnd else x

    scale = 1.0 / math.sqrt(d)
    s, mask = _masked_scores(q, k, causal=causal, window=window,
                             q_offset=q_offset, lengths=lengths)
    p = torch.where(mask, torch.exp(s - lse.float().reshape(
        b, hkv, g, tq, 1)), 0.0)                         # (b,hkv,g,tq,tk)
    qg, dog = _gqa_expand(q, hkv).float(), _gqa_expand(do, hkv).float()
    delta = (dog * _gqa_expand(o, hkv).float()).sum(-1)  # (b,tq,hkv,g)
    delta = delta.permute(0, 2, 3, 1)[..., None]         # (b,hkv,g,tq,1)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    pr, dsr = r(p), r(p * (dp - delta))
    dk = torch.zeros((b, tk, hkv, d), device=q.device)
    dv = torch.zeros((b, tk, hkv, d), device=q.device)
    for split in range(ns):
        pk, pv = torch.zeros_like(dk), torch.zeros_like(dv)
        for hh in range(split * g // ns, (split + 1) * g // ns):
            for q0 in range(0, tq, t):
                rows = slice(q0, q0 + t)
                pv += torch.einsum("bhqk,bqhd->bkhd", pr[:, :, hh, rows],
                                   dog[:, rows, :, hh])
                pk += torch.einsum("bhqk,bqhd->bkhd", dsr[:, :, hh, rows],
                                   qg[:, rows, :, hh])
        dk, dv = dk + pk, dv + pv
    dq = torch.zeros((b, tq, hkv, g, d), device=q.device)
    kf = k.float()
    for k0 in range(0, tk, t):
        keys = slice(k0, k0 + t)
        dq += torch.einsum("bhgqk,bkhd->bqhgd", dsr[..., keys], kf[:, keys])
    return ((dq * scale).reshape(b, tq, hq, d).to(q.dtype),
            (dk * scale).to(k.dtype), dv.to(v.dtype))


# --------------------------------------------------------------------------
# Attention — blocked flash (online softmax)
# --------------------------------------------------------------------------

def attention_blocked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      q_offset: int = 0,
                      lengths: torch.Tensor | None = None,
                      block_q: int = 512, block_k: int = 512,
                      scale: float | None = None) -> torch.Tensor:
    """Flash algorithm as loops over q blocks (outer) and kv blocks (inner)
    with running (m, l, acc).  Never materialises Tq×Tk."""
    b, tq, hq, d = q.shape
    _, tk, hkv, _ = k.shape
    g = hq // hkv
    bq, bk = min(block_q, tq), min(block_k, tk)
    scale = _scale(d, scale)
    dev = q.device
    klen = _as_lengths(lengths, b, dev)
    if klen is None:
        klen = torch.full((b,), tk, device=dev)
    qf = _gqa_expand(q, hkv).float()                     # (b,tq,hkv,g,d)
    kf, vf = k.float(), v.float()
    out = torch.empty((b, tq, hkv, g, d), dtype=torch.float32, device=dev)
    for q0 in range(0, tq, bq):
        qblk = qf[:, q0:q0 + bq]
        nq = qblk.shape[1]
        qpos = q_offset + q0 + torch.arange(nq, device=dev)
        m = torch.full((b, hkv, g, nq), NEG_INF, device=dev)
        l = torch.zeros((b, hkv, g, nq), device=dev)
        acc = torch.zeros((b, hkv, g, nq, d), device=dev)
        for k0 in range(0, tk, bk):
            kblk, vblk = kf[:, k0:k0 + bk], vf[:, k0:k0 + bk]
            kpos = k0 + torch.arange(kblk.shape[1], device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qblk, kblk) * scale
            msk = torch.ones((nq, kpos.numel()), dtype=torch.bool, device=dev)
            if causal:
                msk &= kpos[None, :] <= qpos[:, None]
            if window is not None:
                msk &= kpos[None, :] > qpos[:, None] - window
            msk = msk[None] & (kpos[None, None, :] < klen[:, None, None])
            msk = msk[:, None, None]
            s = torch.where(msk, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(msk, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vblk)
            m = m_new
        o = acc / l.clamp_min(1e-30)[..., None]          # (b,hkv,g,nq,d)
        out[:, q0:q0 + nq] = o.permute(0, 3, 1, 2, 4)
    return out.reshape(b, tq, hq, d).to(q.dtype)


# --------------------------------------------------------------------------
# Decode attention — single new token against a filled KV cache
# --------------------------------------------------------------------------

def decode_attention_naive(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, lengths: torch.Tensor, *,
                           window: int | None = None, k_offset: int = 0,
                           return_lse: bool = False,
                           scale: float | None = None):
    """q: (B, 1, Hq, D); caches: (B, S, Hkv, D) — rows [k_offset, k_offset
    + S) of the sequence (0: the whole cache); lengths: (B,) — number of
    valid entries of the whole sequence (the new token's position is
    lengths-1).  With ``return_lse`` also each row's log-sum-exp of its
    scaled scores over the share's valid keys, (B, Hq) fp32, NEG_INF for a
    row without one.  ``scale`` multiplies the scores (1 / sqrt(D) by
    default)."""
    b, _, hq, d = q.shape
    _, s, hkv, _ = k_cache.shape
    qg = _gqa_expand(q, hkv)[:, 0]                       # (b,hkv,g,d)
    scale = _scale(d, scale)
    scores = torch.einsum("bhgd,bkhd->bhgk", qg.float(),
                          k_cache.float()) * scale
    lengths = _as_lengths(lengths, b, q.device)
    kpos = k_offset + torch.arange(s, device=q.device)[None, :]
    msk = kpos < lengths[:, None]
    if window is not None:
        msk &= kpos >= (lengths[:, None] - window)
    msk = msk[:, None, None]
    scores = torch.where(msk, scores, NEG_INF)
    m = scores.amax(-1, keepdim=True)
    p = torch.where(msk, torch.exp(scores - m), 0.0)
    den = p.sum(-1, keepdim=True)
    p = p / den.clamp_min(1e-30)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    o = o.reshape(b, 1, hq, d).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(den > 0, m + torch.log(den.clamp_min(1e-30)), NEG_INF)
    return o, lse.reshape(b, hq)


def decode_attention_split(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, lengths: torch.Tensor, *,
                           window: int | None = None,
                           n_splits: int | None = None, k_offset: int = 0,
                           return_lse: bool = False):
    """Flash-decoding, the algorithm of the CUDA decode kernels: fp32
    partials (m, l, acc) of every split of each sequence's valid range in
    the share (``decode_attention.split_plan`` / ``split_range``), then
    ``decode_combine``.  Semantics of ``decode_attention_naive``."""
    from .decode_attention import split_plan, split_range

    b, _, hq, d = q.shape
    _, s, hkv, _ = k_cache.shape
    ns = split_plan(b, hkv, s, window) if n_splits is None else n_splits
    scale = 1.0 / math.sqrt(d)
    qg = _gqa_expand(q, hkv)[:, 0].float()               # (b,hkv,g,d)
    acc = torch.zeros((b, hq, ns, d), device=q.device)
    ml = torch.zeros((b, hq, ns, 2), device=q.device)
    ml[..., 0] = NEG_INF                                 # empty split
    for bi, length in enumerate(torch.as_tensor(lengths).tolist()):
        for si in range(ns):
            a, e = split_range(length, s, window, ns, si, k_offset)
            if e <= a:
                continue
            k = k_cache[bi, a:e].float()                 # (n,hkv,d)
            sc = torch.einsum("hgd,khd->hgk", qg[bi], k) * scale
            m = sc.amax(-1)
            p = torch.exp(sc - m[..., None])
            o = torch.einsum("hgk,khd->hgd", p, v_cache[bi, a:e].float())
            acc[bi, :, si] = o.reshape(hq, d)
            ml[bi, :, si, 0] = m.reshape(hq)
            ml[bi, :, si, 1] = p.sum(-1).reshape(hq)
    out = decode_combine(acc, ml, return_lse=return_lse)
    if return_lse:
        return out[0][:, None].to(q.dtype), out[1]
    return out[:, None].to(q.dtype)


def decode_combine(acc: torch.Tensor, ml: torch.Tensor, *,
                   return_lse: bool = False):
    """Merge split partials: acc (b, hq, ns, d), ml (b, hq, ns, 2) → (b, hq,
    d).  out = Σ e^(m_s - M) acc_s / max(Σ e^(m_s - M) l_s, 1e-30), so a row
    whose every split is empty is 0; with ``return_lse`` also its
    log-sum-exp M + log Σ e^(m_s - M) l_s, NEG_INF for an empty row."""
    m, l = ml[..., 0], ml[..., 1]
    mx = m.amax(-1, keepdim=True)
    w = torch.exp(m - mx)
    raw = (w * l).sum(-1)
    den = raw.clamp_min(1e-30)
    out = (w[..., None] * acc).sum(-2) / den[..., None]
    if not return_lse:
        return out
    return out, torch.where(raw > 0, mx[..., 0] + torch.log(den), NEG_INF)


def decode_merge(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """The ranks' results over a cache split along the sequence merged
    (the plain version of ``decode_attention.merge``): outs (b, hq, R, d)
    the ranks' normalised outputs, lses (b, hq, R) their log-sum-exps,
    each rank a partial with m = lse and l = 1 (0 when it had no key), then
    ``decode_combine``.  Returns (b, 1, hq, d) in the outputs' dtype."""
    ml = torch.stack([lses.float(), (lses > NEG_INF / 2).float()], -1)
    return decode_combine(outs.float(), ml)[:, None].to(outs.dtype)


# --------------------------------------------------------------------------
# Mamba-2 SSD — naive recurrence oracle and the chunked (SSD) algorithm
# --------------------------------------------------------------------------

def ssd_naive(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
              h0: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential SSM recurrence (the oracle).  Returns y (b, t, nh, hd) in
    x's dtype and the final state (b, nh, hd, n) in fp32."""
    b, t, nh, hd = x.shape
    n = B.shape[-1]
    h = (torch.zeros((b, nh, hd, n), device=x.device) if h0 is None
         else h0.float())
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    ys = []
    for i in range(t):
        dA = torch.exp(dtf[:, i] * A[None, :])                 # (b,nh)
        dBx = torch.einsum("bn,bhp->bhpn", Bf[:, i],
                           xf[:, i] * dtf[:, i, :, None])
        h = h * dA[..., None, None] + dBx
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cf[:, i]))
    y = torch.stack(ys, 1) + xf * D[None, None, :, None]
    return y.to(x.dtype), h


def _segsum(logs: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum(logs[..., j+1:i+1]) for
    j <= i, -inf otherwise (the 1-semiseparable mask of the SSD paper)."""
    t = logs.shape[-1]
    cs = torch.cumsum(logs, -1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                 device=logs.device))
    return torch.where(mask, out, -torch.inf)


def _pad_chunks(x, dt, B, C, chunk: int):
    """Pad the time axis to whole chunks of ``c = min(chunk, t)``; returns
    the padded tensors, ``c`` and the chunk count."""
    t = x.shape[1]
    c = min(chunk, t)
    nc = -(-t // c)
    pad = nc * c - t
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, pad))
    return x, dt, B, C, c, nc


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
                chunk: int = 128, h0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """State-space duality algorithm (Mamba-2 §6): quadratic attention-like
    compute inside chunks + linear state recurrence across chunks."""
    b, t, nh, hd = x.shape
    n = B.shape[-1]
    xp, dtp, Bp, Cp, c, nc = _pad_chunks(x, dt, B, C, chunk)
    xf = xp.float().reshape(b, nc, c, nh, hd)
    dtf = dtp.float().reshape(b, nc, c, nh)
    Bf = Bp.float().reshape(b, nc, c, n)
    Cf = Cp.float().reshape(b, nc, c, n)

    dA = dtf * A[None, None, None, :]                    # (b,nc,c,nh)
    dA_cs = torch.cumsum(dA, 2)
    # 1. intra-chunk (quadratic, the "attention-like" part)
    L = torch.exp(_segsum(dA.transpose(2, 3)))           # (b,nc,nh,i,j)
    scores = torch.einsum("bzin,bzjn->bzij", Cf, Bf)
    xdt = xf * dtf[..., None]                            # x̄ = x·dt
    y_diag = torch.einsum("bzij,bzhij,bzjhp->bzihp", scores, L, xdt)
    # 2. per-chunk final states
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)
    states = torch.einsum("bzcn,bzch,bzchp->bzhpn", Bf, decay_states, xdt)
    # 3. inter-chunk recurrence; h_in[z] is the state ENTERING chunk z
    h = (torch.zeros((b, nh, hd, n), device=x.device) if h0 is None
         else h0.float())
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])          # (b,nc,nh)
    h_in = []
    for z in range(nc):
        h_in.append(h)
        h = h * chunk_decay[:, z, :, None, None] + states[:, z]
    h_in = torch.stack(h_in, 1)                          # (b,nc,nh,hd,n)
    # 4. chunk-input contribution
    in_decay = torch.exp(dA_cs)
    y_off = torch.einsum("bzcn,bzch,bzhpn->bzchp", Cf, in_decay, h_in)
    y = (y_diag + y_off).reshape(b, nc * c, nh, hd)[:, :t]
    y = y + x.float() * D[None, None, :, None]
    return y.to(x.dtype), h


def ssd_intra_chunk(xdt: torch.Tensor, dacs: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, *, nh: int, hd: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The function of the SSD intra-chunk kernel, on its layouts.

    xdt (b, nc, c, nh*hd), dacs (b, nc, c, nh) within-chunk cumsum of the
    log-decay, B/C (b, nc, c, n).  Returns fp32 y_diag (b, nc, c, nh*hd) and
    the chunks' outgoing states (b, nc, nh, n, hd)."""
    b, nc, c, _ = xdt.shape
    xh = xdt.float().reshape(b, nc, c, nh, hd)
    dacs, B, C = dacs.float(), B.float(), C.float()
    scores = torch.einsum("bzin,bzjn->bzij", C, B)
    dh = dacs.transpose(2, 3)                            # (b,nc,nh,c)
    tril = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                 device=xdt.device))
    # select before the exp: exp(dacs_i - dacs_j) may overflow for j > i
    L = torch.exp(torch.where(tril, dh[..., :, None] - dh[..., None, :],
                              -torch.inf))
    y = torch.einsum("bzij,bzhij,bzjhp->bzihp", scores, L, xh)
    decay = torch.exp(dacs[:, :, -1:, :] - dacs)         # (b,nc,c,nh)
    states = torch.einsum("bzcn,bzch,bzchp->bzhnp", B, decay, xh)
    return y.reshape(b, nc, c, nh * hd), states


def ssd_intra_chunk_bwd(xdt: torch.Tensor, dacs: torch.Tensor,
                        B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor,
                        dstates: torch.Tensor, *, nh: int, hd: int
                        ) -> tuple[torch.Tensor, ...]:
    """The gradients of ``ssd_intra_chunk``, written from its equations
    (no autograd): the plain version of the backward kernel.

    ``dy`` (b, nc, c, nh*hd) and ``dstates`` (b, nc, nh, n, hd) are the
    gradients of its two outputs.  With W[h,i,j] = scores[i,j]·L[h,i,j]
    (j <= i, L the decay mask) and decay[j,h] = exp(dacs[c-1,h] -
    dacs[j,h]):

      dW[h,i,j] = dy_h[i]·xdt_h[j]  (j <= i)
      dxdt_h[j] = Σ_i W[h,i,j] dy_h[i]
                  + decay[j,h] Σ_nn B[j,nn] dstates_h[nn]
      dS        = Σ_h dW⊙L_h;  dC = dS·B
      dB        = dSᵀ·C + Σ_h decay_h ⊙ (xdt_h·dstates_hᵀ)
      G         = dW⊙W:  ddacs[i] += Σ_j G[i,j],  ddacs[j] -= Σ_i G[i,j]
      E[j,h]    = decay[j,h] xdt_h[j]·(B[j]·dstates_h):
                  ddacs[j] -= E[j,h],  ddacs[c-1,h] += Σ_j E[j,h]

    Returns fp32 (dxdt, ddacs, dB, dC) in the inputs' layouts."""
    b, nc, c, _ = xdt.shape
    xh = xdt.float().reshape(b, nc, c, nh, hd)
    dyh = dy.float().reshape(b, nc, c, nh, hd)
    dacs, B, C, ds = dacs.float(), B.float(), C.float(), dstates.float()
    scores = torch.einsum("bzin,bzjn->bzij", C, B)
    dh = dacs.transpose(2, 3)                            # (b,nc,nh,c)
    tril = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                 device=xdt.device))
    # select before the exp, as the forward does: exp(dacs_i - dacs_j) may
    # overflow for j > i, and inf * 0 would be NaN in G
    L = torch.exp(torch.where(tril, dh[..., :, None] - dh[..., None, :],
                              -torch.inf))               # (b,nc,nh,i,j)
    W = scores[:, :, None] * L
    dW = torch.einsum("bzihp,bzjhp->bzhij", dyh, xh)
    dx = torch.einsum("bzhij,bzihp->bzjhp", W, dyh)
    decay = torch.exp(dacs[:, :, -1:, :] - dacs)         # (b,nc,c,nh)
    q = torch.einsum("bzjn,bzhnp->bzjhp", B, ds)         # B_j · dstates_h
    dx = dx + decay[..., None] * q
    dS = (dW * L).sum(2)                                 # (b,nc,i,j)
    dC = torch.einsum("bzij,bzjn->bzin", dS, B)
    dB = (torch.einsum("bzij,bzin->bzjn", dS, C)
          + torch.einsum("bzjh,bzjhp,bzhnp->bzjn", decay, xh, ds))
    G = dW * W
    E = decay * (xh * q).sum(-1)                         # (b,nc,c,nh)
    ddacs = ((G.sum(-1) - G.sum(-2)).transpose(2, 3) - E).contiguous()
    ddacs[:, :, -1] += E.sum(2)
    return dx.reshape(b, nc, c, nh * hd), ddacs, dB, dC


# the CUDA kernel's tiles: 64 query rows (y) or state rows, 32 keys
SSD_ROWS, SSD_KEYS = 64, 32


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``: the low 13 bits become 0."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x = big + small to about 22 bits: big = tf32(x), small = tf32(x -
    big), the operand split of 3xTF32."""
    big = tf32_round(x)
    return big, tf32_round(x.float() - big)


def _mm_tf32(a: torch.Tensor, b: torch.Tensor, split: bool) -> torch.Tensor:
    """a @ b on TF32 tensor cores with fp32 sums: one product of the rounded
    operands, or with ``split`` small·big + big·small + big·big (the
    kernel's order; small·small is left out).  Each product of two TF32
    values is exact in fp32."""
    if not split:
        return tf32_round(a) @ tf32_round(b)
    a_big, a_small = tf32_split(a)
    b_big, b_small = tf32_split(b)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def ssd_intra_chunk_tf32(xdt: torch.Tensor, dacs: torch.Tensor,
                         B: torch.Tensor, C: torch.Tensor, *, nh: int,
                         hd: int, split: bool = True
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The arithmetic of the CUDA SSD kernel (``csrc/ssd_intra_chunk.cu``):
    the function of ``ssd_intra_chunk`` with its three products in TF32
    and, with ``split`` (the kernel), the 3xTF32 split of every operand,
    over the kernel's tiles.  Per 32-key tile: scores C·Bᵀ for a 64-row
    tile, the masked decay applied to them in fp32 (the select before the
    exp), then y += (scores ⊙ L_h)·x̄_h; states += (B ⊙ decay_h)ᵀ·x̄_h
    with the decay to the chunk's end in fp32.  ``split=False`` is a single
    TF32 product, which the kernel does not run: the tests show that it
    misses the fp32 tolerance."""
    b, nc, c, _ = xdt.shape
    n = B.shape[-1]
    xh = xdt.float().reshape(b, nc, c, nh, hd).permute(0, 1, 3, 2, 4)
    dh = dacs.float().transpose(2, 3)                    # (b,nc,nh,c)
    B, C = B.float(), C.float()
    y = torch.zeros((b, nc, nh, c, hd), device=xdt.device)
    for i0 in range(0, c, SSD_ROWS):
        i1 = min(i0 + SSD_ROWS, c)
        rows = torch.arange(i0, i1, device=xdt.device)
        for j0 in range(0, i1, SSD_KEYS):
            j1 = min(j0 + SSD_KEYS, i1)
            keys = torch.arange(j0, j1, device=xdt.device)
            s = _mm_tf32(C[:, :, i0:i1], B[:, :, j0:j1].transpose(2, 3),
                         split)                           # (b,nc,ri,kj)
            causal = keys[None, :] <= rows[:, None]
            L = torch.exp(torch.where(
                causal, dh[..., i0:i1, None] - dh[..., None, j0:j1],
                -torch.inf))                              # (b,nc,nh,ri,kj)
            y[..., i0:i1, :] += _mm_tf32(s[:, :, None] * L,
                                         xh[..., j0:j1, :], split)
    decay = torch.exp(dh[..., -1:] - dh)                 # (b,nc,nh,c)
    states = torch.zeros((b, nc, nh, n, hd), device=xdt.device)
    for j0 in range(0, c, SSD_KEYS):
        j1 = min(j0 + SSD_KEYS, c)
        bd = B[:, :, None, j0:j1, :] * decay[..., j0:j1, None]
        states += _mm_tf32(bd.transpose(3, 4), xh[..., j0:j1, :], split)
    y = y.permute(0, 1, 3, 2, 4).reshape(b, nc, c, nh * hd)
    return y, states


def ssd_intra_chunk_bwd_tf32(xdt: torch.Tensor, dacs: torch.Tensor,
                             B: torch.Tensor, C: torch.Tensor,
                             dy: torch.Tensor, dstates: torch.Tensor, *,
                             nh: int, hd: int, split: bool = True,
                             heads_per_group: int | None = None
                             ) -> tuple[torch.Tensor, ...]:
    """The arithmetic of the CUDA SSD backward kernel
    (``csrc/ssd_intra_chunk_bwd.cu``): ``ssd_intra_chunk_bwd``'s equations
    with every product in TF32, with ``split`` (the kernel) in 3xTF32, over
    the kernel's 64 x 64 tiles: Sᵀ = B·Cᵀ per tile pair; per group of
    ``ssd_scan.bwd_plan``'s heads (or ``heads_per_group``), each head in
    order and each key tile j: q = B·dstates_h and R = decay ⊙
    (x̄_h·dstates_hᵀ) over 64-column blocks of the state, then dxdt =
    decay ⊙ q plus Wᵀ·dy_h over the query tiles i >= j in order, with
    dWᵀ = x̄_h·dy_hᵀ and Wᵀ = Sᵀ ⊙ Lᵀ (the select before the exp); the
    group's dW ⊙ L and R summed over its heads in order; then dC = Σ_j dS·B and dB = Σ_i dSᵀ·C over the tiles in
    order, plus the groups' R in group order.  ``split=False`` is a single
    TF32 product, which the kernel does not run: the tests show that it
    misses the fp32 tolerance."""
    from .ssd_scan import BWD_TILE, bwd_plan

    b, nc, c, _ = xdt.shape
    n = B.shape[-1]
    t = BWD_TILE
    gh = (bwd_plan(b, nc, c, nh, n, hd)["heads_per_group"]
          if heads_per_group is None else heads_per_group)

    def mm(a, m):
        return _mm_tf32(a, m, split)

    xh = xdt.float().reshape(b, nc, c, nh, hd)
    dyh = dy.float().reshape(b, nc, c, nh, hd)
    dh, B, C, ds = dacs.float(), B.float(), C.float(), dstates.float()
    decay = torch.exp(dh[:, :, -1:, :] - dh)             # (b,nc,c,nh)
    tiles = [slice(i, min(i + t, c)) for i in range(0, c, t)]
    cols = [slice(i, min(i + t, n)) for i in range(0, n, t)]
    st = {(jt, it): mm(B[:, :, tiles[jt]], C[:, :, tiles[it]].transpose(2, 3))
          for it in range(len(tiles)) for jt in range(it + 1)}
    pos = torch.arange(c, device=xdt.device)
    dxdt = torch.zeros((b, nc, c, nh, hd), device=xdt.device)
    ddacs = torch.zeros((b, nc, c, nh), device=xdt.device)
    ds_sum = torch.zeros((b, nc, c, c), device=xdt.device)   # dSᵀ: rows j
    r_sum = torch.zeros((b, nc, c, n), device=xdt.device)
    for h0 in range(0, nh, gh):
        ds_g = torch.zeros_like(ds_sum)
        r_g = torch.zeros_like(r_sum)
        for h in range(h0, min(h0 + gh, nh)):
            da = dh[..., h]                              # (b,nc,c)
            dd = torch.zeros((b, nc, c), device=xdt.device)
            es = torch.zeros((b, nc, c), device=xdt.device)
            for jt, js in enumerate(tiles):
                xa = xh[:, :, js, h]
                q = torch.zeros_like(xa)
                dec = decay[:, :, js, h]
                for ns_ in cols:
                    dsn = ds[:, :, h, ns_, :]            # (b,nc,nn,hd)
                    q = q + mm(B[:, :, js, ns_], dsn)
                    r_g[..., js, ns_] += mm(xa, dsn.transpose(2, 3)) * \
                        dec[..., None]
                es[..., js] = dec * (xa * q).sum(-1)
                dx = dec[..., None] * q
                for it in range(jt, len(tiles)):
                    i_s = tiles[it]
                    y = dyh[:, :, i_s, h]
                    dwt = mm(xa, y.transpose(2, 3))      # (b,nc,j,i)
                    ok = pos[js, None] <= pos[None, i_s]
                    lt = torch.exp(torch.where(
                        ok, da[..., None, i_s] - da[..., js, None],
                        -torch.inf))
                    wt = st[jt, it] * lt
                    gt = dwt * wt
                    ds_g[..., js, i_s] += dwt * lt
                    dx = dx + mm(wt, y)
                    dd[..., js] -= gt.sum(-1)
                    dd[..., i_s] += gt.sum(-2)
                dxdt[:, :, js, h] = dx
            ddacs[..., h] = dd - es
            ddacs[..., -1, h] += es.sum(-1)
        ds_sum = ds_sum + ds_g
        r_sum = r_sum + r_g
    dS = ds_sum.transpose(2, 3)                          # (b,nc,i,j)
    dC = torch.zeros_like(C)
    dB = torch.zeros_like(B)
    for ts in tiles:
        dC = dC + mm(dS[..., ts], B[:, :, ts])
        dB = dB + mm(ds_sum[..., ts], C[:, :, ts])
    return (dxdt.reshape(b, nc, c, nh * hd), ddacs, dB + r_sum, dC)


def ssd_decode_step(h: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                    D: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One-token SSM update.  h: (b,nh,hd,n); x: (b,nh,hd); dt: (b,nh);
    B,C: (b,n).  Returns (y (b,nh,hd) in x's dtype, h_new fp32)."""
    dA = torch.exp(dt * A[None, :])
    dBx = torch.einsum("bn,bhp->bhpn", B.float(),
                       x.float() * dt[..., None])
    h_new = h * dA[..., None, None] + dBx
    y = torch.einsum("bhpn,bn->bhp", h_new, C.float())
    y = y + x.float() * D[None, :, None]
    return y.to(x.dtype), h_new


# --------------------------------------------------------------------------
# The Mamba-2 mixer's prefill passes (csrc/mamba_prefill.cu), each the eager
# code of its stage in ``layers.mamba_block`` and ``ssd_scan.ssd``.  zxbcdt
# (b, t, 2 di + 2 n + nh) is the input projection (z | x | B | C | dt) in
# the activations' dtype; the time axis is padded to nc chunks of
# c = min(chunk, t) rows (``_pad_chunks``), tp = nc c.
# --------------------------------------------------------------------------

def causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                conv_state: torch.Tensor | None,
                bias: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv, width cw, and its bias (C,) where given, then
    SiLU.  xbc: (B,T,C); w: (cw,C).  conv_state: (B,cw-1,C) carried
    context (decode) or None (prefill).  Returns (out (B,T,C), new_state
    (B,cw-1,C))."""
    cw, t = w.shape[0], xbc.shape[1]
    if conv_state is None:
        conv_state = xbc.new_zeros((xbc.shape[0], cw - 1, xbc.shape[2]))
    full = torch.cat([conv_state, xbc], 1)                 # (B,T+cw-1,C)
    out = sum(full[:, i:i + t] * w[i][None, None] for i in range(cw))
    if bias is not None:
        out = out + bias
    return torch.nn.functional.silu(out), full[:, -(cw - 1):]


def ssd_dt(dtr: torch.Tensor, dt_bias: torch.Tensor, A_log: torch.Tensor,
           chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """dtr (b, t, nh) the projection's dt columns.  Returns dt =
    softplus(dtr + dt_bias) (b, tp, nh), 0 on the pad rows, and its
    within-chunk cumsum of dt·A, A = -exp(A_log): dacs (b, nc, c, nh), both
    fp32."""
    b, t, nh = dtr.shape
    c = min(chunk, t)
    nc = -(-t // c)
    dt = torch.nn.functional.softplus(dtr.float() + dt_bias.float())
    dt = torch.nn.functional.pad(dt, (0, 0, 0, nc * c - t))
    A = -torch.exp(A_log.float())
    return dt, torch.cumsum(dt.reshape(b, nc, c, nh) * A[None, None, None, :],
                            2)


def mamba_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None,
               conv_state: torch.Tensor | None, dt: torch.Tensor, *, hd: int
               ) -> tuple[torch.Tensor, ...]:
    """xbc (b, t, di + 2n) the projection's x|B|C columns; w (cw, di + 2n)
    and bias (di + 2n,) in any dtype (cast to xbc's); conv_state (b, cw-1,
    di + 2n) or None; dt (b, tp, nh) from ``ssd_dt``.  Returns the conv's
    output (b, t, di + 2n) and new context (b, cw-1, di + 2n) in xbc's
    dtype (``causal_conv``), and the intra-chunk operands in fp32, zero on
    the pad rows: xdt = x·dt (b, tp, di), B and C (b, tp, n)."""
    b, t, cc = xbc.shape
    tp, nh = dt.shape[1:]
    di = nh * hd
    n = (cc - di) // 2
    out, new_state = causal_conv(
        xbc, w.to(xbc.dtype), conv_state,
        None if bias is None else bias.to(xbc.dtype))
    xs, B, C = torch.split(out, [di, n, n], -1)
    pad = tp - t
    xp = torch.nn.functional.pad(xs.reshape(b, t, nh, hd),
                                 (0, 0, 0, 0, 0, pad))
    xdt = (xp.float() * dt[..., None]).reshape(b, tp, di)
    B, C = (torch.nn.functional.pad(v, (0, 0, 0, pad)).float() for v in (B, C))
    return out, new_state, xdt, B, C


def ssd_chunk_states(states: torch.Tensor, dacs: torch.Tensor,
                     h0: torch.Tensor | None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The recurrence across chunks: states (b, nc, nh, n, hd) the chunks'
    outgoing states (``ssd_intra_chunk``), dacs (b, nc, c, nh), h0 (b, nh,
    hd, n) or None (zeros).  Returns the state entering each chunk, h_in
    (b, nc, nh, n, hd), and the final state (b, nh, hd, n), fp32."""
    b, nc, nh, n, hd = states.shape
    states = states.transpose(3, 4)                      # (b,nc,nh,hd,n)
    h = (torch.zeros((b, nh, hd, n), device=states.device) if h0 is None
         else h0.float())
    chunk_decay = torch.exp(dacs[:, :, -1, :])           # (b,nc,nh)
    h_in = []
    for z in range(nc):
        h_in.append(h)
        h = h * chunk_decay[:, z, :, None, None] + states[:, z]
    return torch.stack(h_in, 1).transpose(3, 4), h


def ssd_output(y_diag: torch.Tensor, h_in: torch.Tensor, dacs: torch.Tensor,
               C: torch.Tensor, x: torch.Tensor, D: torch.Tensor
               ) -> torch.Tensor:
    """y = y_diag + exp(dacs)·(C·h_in) + D·x: y_diag (b, nc, c, nh·hd),
    h_in (b, nc, nh, n, hd), dacs (b, nc, c, nh), C (b, nc, c, n) fp32; x
    (b, t, nh, hd) and D (nh,).  Returns y (b, t, nh, hd) in x's dtype."""
    b, t, nh, hd = x.shape
    nc, c = dacs.shape[1:3]
    in_decay = torch.exp(dacs)                           # (b,nc,c,nh)
    y_off = torch.einsum("bzcn,bzch,bzhpn->bzchp", C, in_decay,
                         h_in.transpose(3, 4))
    y = y_diag.reshape(b, nc, c, nh, hd) + y_off
    y = y.reshape(b, nc * c, nh, hd)[:, :t]
    y = y + x.float() * D.float()[None, None, :, None]
    return y.to(x.dtype)


def gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """The mixer's gated RMSNorm over the last axis: g = y·silu(z) rounded
    to y's dtype, then ``layers.rmsnorm(g, w, eps)``.  y, z (b, t, di)."""
    g = y * torch.nn.functional.silu(z.float()).to(y.dtype)
    gf = g.float()
    var = (gf * gf).mean(-1, keepdim=True)
    return ((gf * torch.rsqrt(var + eps)) * (1.0 + w)).to(g.dtype)
