"""Plain reference of the ``hybrid_moe`` family (granite-4.0-h-small, HF
``granitemoehybrid``): a decoder whose layers each hold a Mamba-2 mixer or
grouped-query attention (``mixers``: "M" or "A" a layer), then a routed
SwiGLU MoE and a shared SwiGLU expert, with the μP scalars::

    h = x + r · mixer(rmsnorm(x))
    y = h + r · (moe(rmsnorm(h)) + shared(rmsnorm(h)))

(r = ``residual_multiplier``), the embedding times ``embedding_multiplier``,
an RMS-normed output, the head tied to the embedding and the logits divided
by ``logits_scaling``.  Attention has no positional embedding and scales its
scores by ``attn_scale``.  The Mamba-2 mixer is the ``ssm`` family's
(``ssm.py``) with the conv's bias and the configuration's gated-norm
epsilon; its scan is that file's quadratic form y_t = sum_{s<=t} (C_t .
B_s) exp(cum_t - cum_s) dt_s x_s, written out here (a reference imports
nothing but ``_plain``) in blocks of query rows and of heads, so that a
4616-token sequence at 128 heads fits.  The router takes the softmax of
its top-k logits, HF's order.

``make_params`` draws the weights the benchmark hands to the program and to
this reference alike, in the layout the program reads (``ln1``, ``ln2``,
``moe`` and ``shared_mlp`` stacked over the layers, ``attn`` over the
attention layers, ``ssm`` over the Mamba layers).  ``logits`` is the
forward pass over one sequence in fp32 (or in fp8 for the lower precision
control).  Departures from the published model: the RMSNorm weights (the
gated norm's too) are stored as offsets from one, as the program keeps
them; the router's product is fp32 at either precision.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ._plain import causal_attention, linear, rmsnorm

HEAD_BLOCK = 16                  # heads of the quadratic SSD form at once


def _normal(shape, scale: float, gen: torch.Generator, device,
            dtype) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device,
                       dtype=dtype).mul_(scale)


def _uniform(shape, lo: float, hi: float, gen: torch.Generator, device
             ) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def widths(cfg: dict) -> tuple[int, int, int, int]:
    """(d_inner, d_state, heads, head_dim) of the mixer."""
    s = cfg["ssm"]
    di = s["expand"] * cfg["d_model"]
    return di, s["d_state"], di // s["head_dim"], s["head_dim"]


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, block: int = 512) -> torch.Tensor:
    """y_t = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s for x
    (T, nh, hd), dt (T, nh), A (nh,), B and C (T, n), cum the running sum
    of dt A in float64; blocks of ``block`` query rows and ``HEAD_BLOCK``
    heads."""
    t, nh, _ = x.shape
    cum = torch.cumsum(dt.double() * A.double(), 0)          # (T, nh)
    xdt = x.float() * dt.float()[..., None]                  # (T, nh, hd)
    y = torch.empty_like(xdt)
    pos = torch.arange(t, device=x.device)
    for lo in range(0, t, block):
        hi = min(t, lo + block)
        cb = C[lo:hi].float() @ B[:hi].float().T              # (q, s)
        keep = (pos[None, :hi] <= pos[lo:hi, None])[..., None]
        for h0 in range(0, nh, HEAD_BLOCK):
            h1 = min(nh, h0 + HEAD_BLOCK)
            diff = cum[lo:hi, None, h0:h1] - cum[None, :hi, h0:h1]
            decay = torch.exp(diff.masked_fill(~keep, float("-inf"))).float()
            y[lo:hi, h0:h1] = torch.einsum("qs,qsh,shp->qhp", cb, decay,
                                           xdt[:hi, h0:h1])
    return y


def make_params(cfg: dict, gen: torch.Generator, device,
                dtype=torch.bfloat16) -> dict:
    """One draw per stacked leaf from ``gen``: projections N(0, 1/fan_in),
    the conv N(0, 1/width) and its bias uniform in ±1/sqrt(width) (a
    PyTorch Conv1d's), A = -exp(A_log) uniform in [-16, -1], dt_bias the
    inverse softplus of a dt log-uniform in [1e-3, 1e-1] (Mamba-2's
    initialisation), D and the gated norm's offset near 1 and 0, layer norm
    offsets N(0, 0.1^2) in fp32; the embedding N(0, (0.02 / m)^2), m the
    embedding multiplier, so that its rows enter the residual stream at
    0.02, as the ``moe`` family's do.  At N(0, 0.02^2) the tied head would
    find each position's own token, times 12, far above every other row:
    a random model that repeats its input, on which every precision picks
    the same tokens."""
    nl, d, v = cfg["n_layers"], cfg["d_model"], cfg["vocab"]
    hq, hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    m = cfg["moe"]
    e, f, fs = m["num_experts"], m["d_ff_expert"], m["d_ff_shared"]
    na, nm = cfg["mixers"].count("A"), cfg["mixers"].count("M")
    di, n, nh, _ = widths(cfg)
    cw = cfg["ssm"]["conv_width"]

    def proj(lead, *shape):
        return _normal((lead, *shape), 1.0 / math.sqrt(shape[-2]), gen,
                       device, dtype)

    def norm(*shape):
        return {"w": _normal(shape, 0.1, gen, device, torch.float32)}

    dt = torch.exp(_uniform((nm, nh), math.log(1e-3), math.log(1e-1), gen,
                            device))
    bound = 1.0 / math.sqrt(cw)
    layers = {
        "ln1": norm(nl, d), "ln2": norm(nl, d),
        "moe": {"router": proj(nl, d, e), "w_gate": proj(nl, e, d, f),
                "w_up": proj(nl, e, d, f), "w_down": proj(nl, e, f, d)},
        "shared_mlp": {"w_gate": proj(nl, d, fs), "w_up": proj(nl, d, fs),
                       "w_down": proj(nl, fs, d)},
        "attn": {"wq": proj(na, d, hq * hd), "wk": proj(na, d, hkv * hd),
                 "wv": proj(na, d, hkv * hd), "wo": proj(na, hq * hd, d)},
        "ssm": {"w_in": proj(nm, d, 2 * di + 2 * n + nh),
                "conv": proj(nm, cw, di + 2 * n),
                "conv_b": _uniform((nm, di + 2 * n), -bound, bound, gen,
                                   device).to(dtype),
                "A_log": torch.log(_uniform((nm, nh), 1.0, 16.0, gen,
                                            device)).to(dtype),
                "D": (1.0 + _normal((nm, nh), 0.1, gen, device,
                                    torch.float32)).to(dtype),
                "dt_bias": (dt + torch.log(-torch.expm1(-dt))).to(dtype),
                "norm": _normal((nm, di), 0.1, gen, device, dtype),
                "w_out": proj(nm, di, d)}}
    emb = _normal((v, d), 0.02 / cfg["embedding_multiplier"], gen, device,
                  dtype)
    return {"embed": {"embedding": emb},
            "layers": layers, "final_norm": norm(d)}


def _attention(cfg: dict, p: dict, j: int, h: torch.Tensor,
               precision: str) -> torch.Tensor:
    t = h.shape[0]
    hq, hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = linear(h, p["wq"][j], precision).reshape(t, hq, hd)
    k = linear(h, p["wk"][j], precision).reshape(t, hkv, hd)
    v = linear(h, p["wv"][j], precision).reshape(t, hkv, hd)
    # causal_attention scales by 1/sqrt(hd): the query carries the rest
    o = causal_attention(q * (cfg["attn_scale"] * math.sqrt(hd)), k, v, None)
    return linear(o.reshape(t, hq * hd), p["wo"][j], precision)


def _mixer(cfg: dict, p: dict, j: int, h: torch.Tensor,
           precision: str) -> torch.Tensor:
    t = h.shape[0]
    di, n, nh, hd = widths(cfg)
    s = cfg["ssm"]
    cw = s["conv_width"]
    z, xs, B, C, dt = torch.split(linear(h, p["w_in"][j], precision),
                                  [di, di, n, n, nh], -1)
    conv_in = torch.cat([xs, B, C], -1)
    w = p["conv"][j].float()
    padded = torch.cat([conv_in.new_zeros((cw - 1, conv_in.shape[1])),
                        conv_in], 0)
    conv = sum(padded[i:i + t] * w[i] for i in range(cw))
    if s["conv_bias"]:
        conv = conv + p["conv_b"][j].float()
    xs, B, C = torch.split(F.silu(conv), [di, n, n], -1)
    dt = F.softplus(dt + p["dt_bias"][j].float())
    A = -torch.exp(p["A_log"][j].float())
    xh = xs.reshape(t, nh, hd)
    y = ssd(xh, dt, A, B, C) + xh * p["D"][j].float()[:, None]
    g = y.reshape(t, di) * F.silu(z)
    return linear(rmsnorm(g, p["norm"][j], s["norm_eps"]), p["w_out"][j],
                  precision)


def _experts(cfg: dict, p: dict, i: int, h: torch.Tensor,
             precision: str) -> torch.Tensor:
    """The routed experts (softmax over the top-k router logits) and the
    shared expert's input ``h``: the routed sum."""
    m = cfg["moe"]
    top, idx = torch.topk(h.float() @ p["router"][i].float(), m["top_k"], -1)
    gates = torch.softmax(top, -1)
    y = torch.zeros_like(h)
    for e in range(m["num_experts"]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        x = h[rows]
        a = F.silu(linear(x, p["w_gate"][i, e], precision)) * linear(
            x, p["w_up"][i, e], precision)
        y.index_add_(0, rows, gates[rows, slot, None]
                     * linear(a, p["w_down"][i, e], precision))
    return y


def _shared(p: dict, i: int, h: torch.Tensor, precision: str
            ) -> torch.Tensor:
    a = F.silu(linear(h, p["w_gate"][i], precision)) * linear(
        h, p["w_up"][i], precision)
    return linear(a, p["w_down"][i], precision)


def logits(cfg: dict, params: dict, tokens: torch.Tensor, start: int,
           precision: str = "fp32") -> torch.Tensor:
    """fp32 logits (T - start, V) of positions start..T-1 of one sequence
    ``tokens`` (T,), each seeing the positions up to itself."""
    eps, r = cfg["norm_eps"], cfg["residual_multiplier"]
    lp = params["layers"]
    emb = params["embed"]["embedding"]
    x = emb[tokens.long()].float() * cfg["embedding_multiplier"]
    slot = {"A": 0, "M": 0}
    for i, mixer in enumerate(cfg["mixers"]):
        j = slot[mixer]
        slot[mixer] += 1
        h = rmsnorm(x, lp["ln1"]["w"][i], eps)
        if mixer == "A":
            x = x + r * _attention(cfg, lp["attn"], j, h, precision)
        else:
            x = x + r * _mixer(cfg, lp["ssm"], j, h, precision)
        h = rmsnorm(x, lp["ln2"]["w"][i], eps)
        x = x + r * (_experts(cfg, lp["moe"], i, h, precision)
                     + _shared(lp["shared_mlp"], i, h, precision))
    x = rmsnorm(x[start:], params["final_norm"]["w"], eps)
    return linear(x, emb.T, precision) / cfg["logits_scaling"]
