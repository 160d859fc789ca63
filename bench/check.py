"""How ``correct`` is decided: the served tokens against the plain
reference, after the window has closed.

A sample, drawn from the seed, of the requests finished inside the window,
with the longest of them (prompt and served tokens together) always in
it, grown until it holds ``check_tokens`` served tokens and
``check_requests`` requests (the mix's file sets both).  The reference
runs once over each prompt followed by its served tokens, in fp32, and
each served token is judged by how far the reference's logit for it lies
below the reference's best at that position: greedy decoding should pick
the best up to rounding.  The cell's limits (``bench/limits/<cell>.json``) name the
numbers compared, each read over the sample:

* ``max_logit_gap``: the widest gap;
* ``mean_logit_gap``: the mean gap over the served tokens (where bf16
  routing near ties make the widest gap swing as far as the control's);
* ``worst_request_mean_gap``: the mean gap over each request's served
  tokens, the largest over the requests, which one slot serving wrong
  tokens among many right ones would raise where the mean hardly moves.

``PERF.md`` gives the readings each limit was set from, and those of the
numbers no limit names yet; every run prints them all.  Every finished
request must also hold exactly the tokens it asked for, each inside the
vocabulary.

The control (``control=True``; the benchmark's runs never ask for it)
computes the reference again with every product in fp8 and reads, at the
same positions, the gap of the token the fp8 computation puts first: the
same numbers, read for the control's tokens in the program's place.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference._plain import gap_of


def malformed(track, vocab: int) -> bool:
    gen = track.req.generated
    return (len(gen) != track.spec.max_new or not track.req.done
            or any(not 0 <= t < vocab for t in gen))


def sample(tracks, seed: int, check_tokens: int, check_requests: int
           ) -> list:
    """The longest finished request, then others in the seed's order
    until the sample holds ``check_tokens`` served tokens and
    ``check_requests`` requests (or every finished one)."""
    if not tracks:
        return []
    key = [len(t.req.generated) + t.spec.prompt_len for t in tracks]
    first = int(np.argmax(key))
    rest = [i for i in np.random.default_rng([seed, 4]).permutation(
        len(tracks)) if i != first]
    out, served = [tracks[first]], len(tracks[first].req.generated)
    for i in rest:
        if served >= check_tokens and len(out) >= check_requests:
            break
        out.append(tracks[int(i)])
        served += len(tracks[int(i)].req.generated)
    return out


def compare(ref, cfg: dict, params: dict, picked, prompt_of, device,
            control: bool = False) -> dict:
    """The numbers compared, read for the program's served tokens
    (``program``) and, with ``control``, for the fp8 reference's first
    choices at the same positions (``control``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gaps, ctrl_gaps, n = [], [], 0
    with torch.no_grad():
        for tr in picked:
            prompt = prompt_of(tr.spec.index)
            served = torch.as_tensor(tr.req.generated, device=device)
            seq = torch.cat([torch.as_tensor(prompt, device=device).long(),
                             served[:-1].long()])
            start = len(prompt) - 1
            want = ref.logits(cfg, params, seq, start)
            gaps.append(gap_of(want, served).cpu())
            n += len(served)
            if control:
                low = ref.logits(cfg, params, seq, start, precision="fp8")
                ctrl_gaps.append(gap_of(want, low.argmax(-1)).cpu())
                del low
            del want
    out = {"tokens_compared": n, "requests_compared": len(picked),
           "program": numbers(gaps),
           "per_request": [(len(g), round(float(g.double().mean()), 4))
                           for g in gaps]}
    if control:
        out["control"] = numbers(ctrl_gaps)
        out["control_per_request"] = [round(float(g.double().mean()), 4)
                                      for g in ctrl_gaps]
    return out


def numbers(parts) -> dict:
    """The numbers a limit may name, from each request's per-token gaps,
    with the spread of the gaps beside them: the share of tokens off the
    reference's best and the 99th percentile."""
    if not parts:
        return {"max_logit_gap": None, "mean_logit_gap": None,
                "worst_request_mean_gap": None}
    g = torch.cat(parts).double()
    return {"max_logit_gap": float(g.max()),
            "mean_logit_gap": float(g.mean()),
            "worst_request_mean_gap": max(float(p.double().mean())
                                          for p in parts),
            "off_best_share": float((g > 0).double().mean()),
            "p99": float(torch.quantile(g, 0.99))}
