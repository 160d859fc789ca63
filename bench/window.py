"""The measured window's arithmetic, on the host clock.

Every output token is stamped with the end of the ``step()`` that produced
it (the engine synchronises the device and copies the tokens to the host
inside ``step``).  Over a window (t0, t1]:

* ``output_tok_per_s``: the tokens stamped inside it over t1 - t0, all the
  work over all the time;
* ``ttft_p95_ms``: the 95th percentile, over every request whose first
  token is stamped inside it, of that stamp minus the request's ``submit``
  call;
* ``itl_p95_ms``: the 95th percentile over every gap between consecutive
  tokens of one request, both stamped inside it (two tokens of one step
  give a gap of 0: they reach the client together).

Percentiles interpolate linearly between order statistics (numpy's
default), over all samples.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Track:
    """One request as its client sees it."""
    client: int
    spec: object                 # traffic.RequestSpec
    submit_t: float
    req: object                  # the engine's Request
    stamps: list = dataclasses.field(default_factory=list)

    def stamp(self, t: float) -> int:
        """Stamp the tokens the request gained since the last stamp;
        returns how many."""
        new = len(self.req.generated) - len(self.stamps)
        self.stamps.extend([t] * new)
        return new


def percentile(values, q: float) -> float | None:
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def in_window(t: float, t0: float, t1: float) -> bool:
    return t0 < t <= t1


def tokens_in(tracks, t0: float, t1: float) -> int:
    return sum(sum(1 for s in tr.stamps if t0 < s <= t1) for tr in tracks)


def ttfts(tracks, t0: float, t1: float) -> list[float]:
    return [tr.stamps[0] - tr.submit_t for tr in tracks
            if tr.stamps and in_window(tr.stamps[0], t0, t1)]


def gaps(tracks, t0: float, t1: float) -> list[float]:
    out = []
    for tr in tracks:
        s = [x for x in tr.stamps if t0 < x <= t1]
        out.extend(b - a for a, b in zip(s, s[1:]))
    return out


def end_to_end(tracks, t0: float, t1: float) -> dict:
    """The window's host-clock metrics (None where a tail has no sample),
    with the sample counts."""
    tt, gg = ttfts(tracks, t0, t1), gaps(tracks, t0, t1)
    n = tokens_in(tracks, t0, t1)
    p_tt, p_gg = percentile(tt, 95), percentile(gg, 95)
    return {"output_tok_per_s": n / (t1 - t0),
            "ttft_p95_ms": None if p_tt is None else 1e3 * p_tt,
            "itl_p95_ms": None if p_gg is None else 1e3 * p_gg,
            "tokens": n, "first_tokens": len(tt), "gaps": len(gg),
            "window_s": t1 - t0}
