"""Plain reference of the ``moe`` family (Mixtral, arXiv:2401.04088): a
decoder of pre-norm layers, each grouped-query attention with rotary
positions and a routed SwiGLU expert FFN (softmax over the experts, the
top-k kept and renormalised to sum one), an RMS-normed output and an untied
head.

``make_params`` draws the weights the benchmark hands to the program and to
this reference alike, in the layout the program reads (leaves stacked over
the layers).  ``logits`` is the forward pass over one sequence in fp32 (or
in fp8 for the lower precision control), every expert computing only the
tokens routed to it.  Departures from the published model: the RMSNorm
weights are stored as offsets from one (``x * (1 + w)``), as the program
keeps them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ._plain import causal_attention, linear, rmsnorm, rope


def _normal(shape, scale: float, gen: torch.Generator, device,
            dtype) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device,
                       dtype=dtype).mul_(scale)


def make_params(cfg: dict, gen: torch.Generator, device,
                dtype=torch.bfloat16) -> dict:
    """One draw per stacked leaf from ``gen``: projections N(0, 1/fan_in),
    embedding and head N(0, 0.02^2), RMSNorm offsets N(0, 0.1^2) in fp32."""
    nl, d, v = cfg["n_layers"], cfg["d_model"], cfg["vocab"]
    hq, hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    m = cfg["moe"]
    e, f = m["num_experts"], m["d_ff_expert"]

    def proj(*shape):
        return _normal((nl, *shape), 1.0 / math.sqrt(shape[-2]), gen,
                       device, dtype)

    def norm(*shape):
        return {"w": _normal(shape, 0.1, gen, device, torch.float32)}

    embed = {"embedding": _normal((v, d), 0.02, gen, device, dtype)}
    if not cfg["tie_embeddings"]:
        embed["head"] = _normal((d, v), 0.02, gen, device, dtype)
    layers = {"ln1": norm(nl, d),
              "attn": {"wq": proj(d, hq * hd), "wk": proj(d, hkv * hd),
                       "wv": proj(d, hkv * hd), "wo": proj(hq * hd, d)},
              "ln2": norm(nl, d),
              "moe": {"router": proj(d, e), "w_gate": proj(e, d, f),
                      "w_up": proj(e, d, f), "w_down": proj(e, f, d)}}
    return {"embed": embed, "layers": layers, "final_norm": norm(d)}


def _experts(cfg: dict, p: dict, i: int, h: torch.Tensor,
             precision: str) -> torch.Tensor:
    m = cfg["moe"]
    probs = torch.softmax(h.float() @ p["router"][i].float(), -1)
    vals, idx = torch.topk(probs, m["top_k"], -1)
    vals = vals / vals.sum(-1, keepdim=True)
    y = torch.zeros_like(h)
    for e in range(m["num_experts"]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        x = h[rows]
        a = F.silu(linear(x, p["w_gate"][i, e], precision)) * linear(
            x, p["w_up"][i, e], precision)
        y.index_add_(0, rows,
                     vals[rows, slot, None] * linear(a, p["w_down"][i, e],
                                                     precision))
    return y


def logits(cfg: dict, params: dict, tokens: torch.Tensor, start: int,
           precision: str = "fp32") -> torch.Tensor:
    """fp32 logits (T - start, V) of positions start..T-1 of one sequence
    ``tokens`` (T,), each seeing the positions up to itself."""
    t = tokens.shape[0]
    hq, hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    lp = params["layers"]
    a, m = lp["attn"], lp["moe"]
    x = params["embed"]["embedding"][tokens.long()].float()
    for i in range(cfg["n_layers"]):
        h = rmsnorm(x, lp["ln1"]["w"][i], eps)
        q = rope(linear(h, a["wq"][i], precision).reshape(t, hq, hd), theta)
        k = rope(linear(h, a["wk"][i], precision).reshape(t, hkv, hd), theta)
        v = linear(h, a["wv"][i], precision).reshape(t, hkv, hd)
        o = causal_attention(q, k, v, cfg["sliding_window"])
        x = x + linear(o.reshape(t, hq * hd), a["wo"][i], precision)
        x = x + _experts(cfg, m, i, rmsnorm(x, lp["ln2"]["w"][i], eps),
                         precision)
    x = rmsnorm(x[start:], params["final_norm"]["w"], eps)
    emb = params["embed"]
    head = emb["embedding"].T if cfg["tie_embeddings"] else emb["head"]
    return linear(x, head, precision)
