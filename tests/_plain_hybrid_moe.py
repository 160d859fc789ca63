"""Plain fp32 reference of the ``hybrid_moe`` family (granite-4.0-h-small,
HF ``granitemoehybrid``): the forward pass over one sequence in plain
``torch``, no kernel of the port, no cache, no batching, nothing of JAX.

Each layer, with r = ``residual_multiplier`` (μP)::

    h = x + r · mixer(rmsnorm(x))
    y = h + r · (moe(rmsnorm(h)) + shared(rmsnorm(h)))

The mixer is a Mamba-2 mixer or grouped-query attention, as ``cfg.mixers``
says.  Attention: no positional embedding, scores scaled by
``attn_scale``, causal.  Mamba-2: one input projection to (z, x, B, C,
dt), a depthwise causal conv with its bias and SiLU over (x, B, C),
dt = softplus(dt + dt_bias), A = -exp(A_log), the recurrence
h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t + D x_t step by
step (one group: B and C shared by the heads), the gated RMSNorm of
y · silu(z) with ``ssm.norm_eps``, the output projection.  MoE: router
logits, the top-k of them softmaxed (HF's order: top-k first), each
token through its k SwiGLU experts, weighted; the shared SwiGLU expert
beside it.  The embedding times ``embedding_multiplier``, a final RMSNorm,
the head tied to the embedding, the logits divided by ``logits_scaling``.

Departures from the published model, where the program keeps its weights
so: every RMSNorm weight (the gated norm's too) is stored as an offset from
one, ``x · (1 + w)``; the router's product is fp32 whatever the weights'
dtype.  Everything here computes in fp32 with TF32 off.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rmsnorm(x, w, eps):
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (
        1.0 + w.float())


def _swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate.float()) * (x @ w_up.float())) @ w_down.float()


def _attention(cfg, p, h):
    t = h.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (h @ p["wq"].float()).reshape(t, hq, hd)
    k = (h @ p["wk"].float()).reshape(t, hkv, hd)
    v = (h @ p["wv"].float()).reshape(t, hkv, hd)
    k = k.repeat_interleave(hq // hkv, 1)
    v = v.repeat_interleave(hq // hkv, 1)
    s = torch.einsum("qhd,khd->hqk", q, k) * cfg.attn_scale
    causal = torch.ones(t, t, dtype=torch.bool, device=h.device).tril()
    a = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
    o = torch.einsum("hqk,khd->qhd", a, v).reshape(t, hq * hd)
    return o @ p["wo"].float()


def _mamba(cfg, p, h):
    s, t = cfg.ssm, h.shape[0]
    di, n = s.d_inner(cfg.d_model), s.d_state
    nh, hd, cw = s.n_heads(cfg.d_model), s.head_dim, s.conv_width
    z, xs, B, C, dt = torch.split(h @ p["w_in"].float(),
                                  [di, di, n, n, nh], -1)
    u = torch.cat([xs, B, C], -1)                          # (t, C)
    u = torch.cat([u.new_zeros(cw - 1, u.shape[1]), u], 0)
    w = p["conv"].float()
    conv = sum(u[j:j + t] * w[j] for j in range(cw))
    if s.conv_bias:
        conv = conv + p["conv_b"].float()
    xs, B, C = torch.split(F.silu(conv), [di, n, n], -1)
    dt = F.softplus(dt + p["dt_bias"].float())             # (t, nh)
    A = -torch.exp(p["A_log"].float())
    x = xs.reshape(t, nh, hd)
    state = h.new_zeros(nh, hd, n)
    ys = []
    for i in range(t):
        state = (state * torch.exp(dt[i] * A)[:, None, None]
                 + (x[i] * dt[i][:, None])[..., None] * B[i])
        ys.append(state @ C[i] + x[i] * p["D"].float()[:, None])
    y = torch.stack(ys).reshape(t, di) * F.silu(z)
    return _rmsnorm(y, p["norm"], s.norm_eps) @ p["w_out"].float()


def _moe(cfg, p, h):
    m = cfg.moe
    logits = h @ p["router"].float()
    top, idx = torch.topk(logits, m.top_k, -1)
    gates = torch.softmax(top, -1)
    y = torch.zeros_like(h)
    for e in range(m.num_experts):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel():
            y[rows] += gates[rows, slot, None] * _swiglu(
                h[rows], p["w_gate"][e], p["w_up"][e], p["w_down"][e])
    return y


def forward(cfg, params: dict, tokens: torch.Tensor, *, shared: bool = True,
            residual_multiplier: float | None = None) -> torch.Tensor:
    """fp32 logits (T, V) of one sequence ``tokens`` (T,), each position
    seeing those up to itself.  ``params`` in the program's layout (per-kind
    stacks).  ``shared`` and ``residual_multiplier`` exist to show that a
    reference without the shared expert, or with another residual scale,
    is told apart by the tests' tolerances."""
    _tf32_off()
    r = (cfg.residual_multiplier if residual_multiplier is None
         else residual_multiplier)
    lp = params["layers"]
    emb = params["embed"]["embedding"].float()
    x = emb[tokens.long()] * cfg.embedding_multiplier
    slot = {"A": 0, "M": 0}
    for i, mixer in enumerate(cfg.mixers):
        j = slot[mixer]
        slot[mixer] += 1
        h = _rmsnorm(x, lp["ln1"]["w"][i], cfg.norm_eps)
        if mixer == "A":
            mix = _attention(cfg, {k: v[j] for k, v in lp["attn"].items()}, h)
        else:
            mix = _mamba(cfg, {k: v[j] for k, v in lp["ssm"].items()}, h)
        x = x + r * mix
        h = _rmsnorm(x, lp["ln2"]["w"][i], cfg.norm_eps)
        f = _moe(cfg, {k: v[i] for k, v in lp["moe"].items()}, h)
        if shared:
            sp = lp["shared_mlp"]
            f = f + _swiglu(h, sp["w_gate"][i], sp["w_up"][i],
                            sp["w_down"][i])
        x = x + r * f
    x = _rmsnorm(x, params["final_norm"]["w"], cfg.norm_eps)
    return (x @ emb.T) / cfg.logits_scaling
