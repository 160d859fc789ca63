"""Plain PyTorch versions of the attention kernels, ported from
``repro.kernels.ref``.

Two tiers per op, as in the JAX package:
  * ``*_naive``   — direct einsum/softmax math; the correctness oracle.
  * ``*_blocked`` — the flash algorithm as Python loops over blocks with a
                    running (m, l, acc); numerically equivalent to naive.

``ops`` sends CPU tensors here; CUDA tensors go to the hand-written kernels,
which ``chip_smoke.py`` holds against these functions on the card.

Conventions (throughout the port): q ``(B, Tq, Hq, D)``, k/v
``(B, Tk, Hkv, D)`` with ``Hq % Hkv == 0``; q head ``h`` reads kv head
``h // g``; masked scores are ``NEG_INF = -1e30`` (not ``-inf``); softmax in
fp32; a row whose every key is masked returns 0.
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

def attention_naive(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0,
                    lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Full-materialisation attention.  ``q_offset`` is the absolute position
    of q[0]; ``lengths`` (B,) masks the KV suffix (per-sequence fill)."""
    b, tq, hq, d = q.shape
    _, tk, hkv, _ = k.shape
    qg = _gqa_expand(q, hkv)
    scale = 1.0 / math.sqrt(d)
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
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)         # 0 on masked rows
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)     # fully-masked row → 0
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, tq, hq, d).to(q.dtype)


# --------------------------------------------------------------------------
# Attention — blocked flash (online softmax)
# --------------------------------------------------------------------------

def attention_blocked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      q_offset: int = 0,
                      lengths: torch.Tensor | None = None,
                      block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """Flash algorithm as loops over q blocks (outer) and kv blocks (inner)
    with running (m, l, acc).  Never materialises Tq×Tk."""
    b, tq, hq, d = q.shape
    _, tk, hkv, _ = k.shape
    g = hq // hkv
    bq, bk = min(block_q, tq), min(block_k, tk)
    scale = 1.0 / math.sqrt(d)
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
                           window: int | None = None) -> torch.Tensor:
    """q: (B, 1, Hq, D); caches: (B, S, Hkv, D); lengths: (B,) — number of
    valid cache entries (the new token's position is lengths-1)."""
    b, _, hq, d = q.shape
    _, s, hkv, _ = k_cache.shape
    qg = _gqa_expand(q, hkv)[:, 0]                       # (b,hkv,g,d)
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bhgd,bkhd->bhgk", qg.float(),
                          k_cache.float()) * scale
    lengths = _as_lengths(lengths, b, q.device)
    kpos = torch.arange(s, device=q.device)[None, :]
    msk = kpos < lengths[:, None]
    if window is not None:
        msk &= kpos >= (lengths[:, None] - window)
    msk = msk[:, None, None]
    scores = torch.where(msk, scores, NEG_INF)
    m = scores.amax(-1, keepdim=True)
    p = torch.where(msk, torch.exp(scores - m), 0.0)
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return o.reshape(b, 1, hq, d).to(q.dtype)
