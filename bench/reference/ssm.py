"""Plain reference of the ``ssm`` family (Mamba-2, arXiv:2405.21060): a
decoder of pre-norm layers, each a Mamba-2 mixer alone, an RMS-normed
output and a head tied to the embedding or not, as the configuration says.

The mixer: one input projection to (z, x, B, C, dt); a depthwise causal
convolution of width ``conv_width`` over (x, B, C) followed by SiLU;
dt = softplus(dt + dt_bias), A = -exp(A_log); the selective state space
recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t + D x_t
with one B and C shared by every head (one group), computed here in its
quadratic form y_t = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s
(cum the running sum of dt A, in float64); the gated RMSNorm of y * silu(z)
and the output projection.

``make_params`` draws the weights the benchmark hands to the program and to
this reference alike, in the layout the program reads.  Departures from the
published model, where the program computes otherwise: no bias on the
convolution, the gated norm's epsilon 1e-6 (the layer norms take the
configuration's), the RMSNorm weights stored as offsets from one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ._plain import linear, rmsnorm

GATED_NORM_EPS = 1e-6


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


def make_params(cfg: dict, gen: torch.Generator, device,
                dtype=torch.bfloat16) -> dict:
    """One draw per stacked leaf from ``gen``: projections N(0, 1/fan_in),
    the conv N(0, 1/width), A = -exp(A_log) uniform in [-16, -1], dt_bias
    the inverse softplus of a dt log-uniform in [1e-3, 1e-1] (Mamba-2's
    initialisation), D and the gated norm's offset near 1 and 0; embedding
    N(0, 0.02^2), layer norm offsets N(0, 0.1^2) in fp32."""
    nl, d, v = cfg["n_layers"], cfg["d_model"], cfg["vocab"]
    di, n, nh, _ = widths(cfg)
    cw = cfg["ssm"]["conv_width"]

    def proj(*shape):
        return _normal((nl, *shape), 1.0 / math.sqrt(shape[-2]), gen,
                       device, dtype)

    def norm(*shape):
        return {"w": _normal(shape, 0.1, gen, device, torch.float32)}

    dt = torch.exp(_uniform((nl, nh), math.log(1e-3), math.log(1e-1), gen,
                            device))
    embed = {"embedding": _normal((v, d), 0.02, gen, device, dtype)}
    if not cfg["tie_embeddings"]:
        embed["head"] = _normal((d, v), 0.02, gen, device, dtype)
    ssm = {"w_in": proj(d, 2 * di + 2 * n + nh),
           "conv": proj(cw, di + 2 * n),
           "A_log": torch.log(_uniform((nl, nh), 1.0, 16.0, gen,
                                       device)).to(dtype),
           "D": (1.0 + _normal((nl, nh), 0.1, gen, device,
                               torch.float32)).to(dtype),
           "dt_bias": (dt + torch.log(-torch.expm1(-dt))).to(dtype),
           "norm": _normal((nl, di), 0.1, gen, device, dtype),
           "w_out": proj(di, d)}
    return {"embed": embed, "layers": {"ln1": norm(nl, d), "ssm": ssm},
            "final_norm": norm(d)}


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, block: int = 512) -> torch.Tensor:
    """y_t = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s for x
    (T, nh, hd), dt (T, nh), A (nh,), B and C (T, n); blocks of ``block``
    query rows."""
    t = x.shape[0]
    cum = torch.cumsum(dt.double() * A.double(), 0)          # (T, nh)
    xdt = x.float() * dt.float()[..., None]                  # (T, nh, hd)
    y = torch.empty_like(xdt)
    pos = torch.arange(t, device=x.device)
    for lo in range(0, t, block):
        hi = min(t, lo + block)
        cb = C[lo:hi].float() @ B[:hi].float().T              # (q, s)
        diff = cum[lo:hi, None, :] - cum[None, :hi, :]        # (q, s, nh)
        keep = (pos[None, :hi] <= pos[lo:hi, None])[..., None]
        decay = torch.exp(diff.masked_fill(~keep, float("-inf"))).float()
        y[lo:hi] = torch.einsum("qs,qsh,shp->qhp", cb, decay, xdt[:hi])
    return y


def _mixer(cfg: dict, p: dict, i: int, h: torch.Tensor,
           precision: str) -> torch.Tensor:
    t = h.shape[0]
    di, n, nh, hd = widths(cfg)
    cw = cfg["ssm"]["conv_width"]
    z, xs, B, C, dt = torch.split(linear(h, p["w_in"][i], precision),
                                  [di, di, n, n, nh], -1)
    conv_in = torch.cat([xs, B, C], -1)
    w = p["conv"][i].float()
    padded = torch.cat([conv_in.new_zeros((cw - 1, conv_in.shape[1])),
                        conv_in], 0)
    conv = F.silu(sum(padded[j:j + t] * w[j] for j in range(cw)))
    xs, B, C = torch.split(conv, [di, n, n], -1)
    dt = F.softplus(dt + p["dt_bias"][i].float())
    A = -torch.exp(p["A_log"][i].float())
    xh = xs.reshape(t, nh, hd)
    y = ssd(xh, dt, A, B, C) + xh * p["D"][i].float()[:, None]
    g = y.reshape(t, di) * F.silu(z)
    return linear(rmsnorm(g, p["norm"][i], GATED_NORM_EPS), p["w_out"][i],
                  precision)


def logits(cfg: dict, params: dict, tokens: torch.Tensor, start: int,
           precision: str = "fp32") -> torch.Tensor:
    """fp32 logits (T - start, V) of positions start..T-1 of one sequence
    ``tokens`` (T,), each seeing the positions up to itself."""
    eps = cfg["norm_eps"]
    lp = params["layers"]
    x = params["embed"]["embedding"][tokens.long()].float()
    for i in range(cfg["n_layers"]):
        x = x + _mixer(cfg, lp["ssm"], i, rmsnorm(x, lp["ln1"]["w"][i], eps),
                       precision)
    x = rmsnorm(x[start:], params["final_norm"]["w"], eps)
    emb = params["embed"]
    head = emb["embedding"].T if cfg["tie_embeddings"] else emb["head"]
    return linear(x, head, precision)
