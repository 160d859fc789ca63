"""The one traffic generator: closed-loop clients over a pool of requests
whose sizes are fixed by the mix's file and whose order and tokens come
from the seed.

A mix file (``bench/traffic/<mix>.json``) holds::

    {"kind": "closed_loop", "clients": C, "max_len": S,
     "prompt_tokens": {"dist": "loguniform" | "uniform", "min": a, "max": b},
     "output_tokens": {"dist": ..., "min": a, "max": b},
     "pool": N, "check_tokens": K, "check_requests": R,
     "source": ..., "why": ...}

The pool's N prompt lengths are the distribution's quantiles at
(i + 1/2) / N, and so are its output lengths, paired by a permutation that
does not depend on the seed: every seed serves the same multiset of sizes,
in another order (the seed's permutation).  Requests take the pool's
entries in turn, round after round (request i has entry i mod N's sizes
and token ids of its own, uniform over the vocabulary); N is set near the
number of requests a window serves, or below it, so that every window
serves nearly the whole multiset whatever the seed.  The first wave gives
client c request c with its output cut to a residual length (the seed's
permutation of the quantiles of (c + 1/2) / C times the drawn length, at
least 2: the engine emits two tokens before it checks the limit), so that
completions spread over the window from its first step.  Later requests
go to clients in the order they come free.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

MIN_OUTPUT = 2


@dataclasses.dataclass(frozen=True)
class RequestSpec:
    index: int            # position in the pool's order
    prompt_len: int
    max_new: int


def _quantiles(dist: dict, n: int) -> np.ndarray:
    u = (np.arange(n) + 0.5) / n
    lo, hi = float(dist["min"]), float(dist["max"])
    if dist["dist"] == "loguniform":
        v = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    elif dist["dist"] == "uniform":
        v = lo + u * (hi - lo)
    else:
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    return np.clip(np.rint(v), lo, hi).astype(np.int64)


class Pool:
    """The seed's requests of one mix, in the order clients take them."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        if mix.get("kind") != "closed_loop":
            raise ValueError(f"unknown traffic kind {mix.get('kind')!r}")
        self.mix, self.seed, self.vocab = mix, int(seed), int(vocab)
        self.clients = int(mix["clients"])
        n = int(mix["pool"])
        prompts = _quantiles(mix["prompt_tokens"], n)
        outputs = _quantiles(mix["output_tokens"], n)
        # the pairing of prompt and output sizes is fixed; the seed orders
        pairing = np.random.default_rng(0).permutation(n)
        order = np.random.default_rng([self.seed, 1]).permutation(n)
        self.prompt_lens = prompts[order]
        self.max_news = np.maximum(outputs[pairing][order], MIN_OUTPUT)
        frac = (np.arange(self.clients) + 0.5) / self.clients
        frac = frac[np.random.default_rng([self.seed, 2]).permutation(
            self.clients)]
        whole = self.max_news[np.arange(self.clients) % n]
        self.first_news = np.maximum(
            np.ceil(frac * whole).astype(np.int64), MIN_OUTPUT)
        self.next = 0

    def __len__(self) -> int:
        return len(self.prompt_lens)

    def spec(self, i: int) -> RequestSpec:
        """Request ``i``'s sizes: pool entry i mod N (the first wave's
        outputs cut to their residual lengths)."""
        k = i % len(self)
        return RequestSpec(i, int(self.prompt_lens[k]),
                           int(self.first_news[i] if i < self.clients
                               else self.max_news[k]))

    def tokens(self, i: int) -> np.ndarray:
        """Request ``i``'s prompt: uniform ids from the seed and ``i``."""
        return np.random.default_rng([self.seed, 3, i]).integers(
            0, self.vocab, size=int(self.prompt_lens[i % len(self)]),
            dtype=np.int32)

    def take(self) -> RequestSpec:
        """The next request."""
        s = self.spec(self.next)
        self.next += 1
        return s

    def max_prompt(self) -> int:
        return int(self.mix["prompt_tokens"]["max"])

    def min_prompt(self) -> int:
        return int(self.mix["prompt_tokens"]["min"])
