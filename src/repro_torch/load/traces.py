"""The port's copy of ``repro.load.traces``.

Arrival traces — who asks for inference, and when.

An :class:`ArrivalTrace` is the open-loop twin of
``repro_torch.fleet.traces.ChurnTrace``: an immutable, time-sorted schedule of
request arrivals, held as numpy arrays so generating and replaying
10⁵–10⁶ requests stays vectorized end to end.  Traces are *seeded and
replayable* — the same ``(constructor, args, seed)`` always produces the
same arrays, so one trace drives a benchmark gate, a unit test, and a
saturation sweep to identical queueing histories.

Arrival-model taxonomy (see docs/load.md):

==================  ======================================================
constructor         traffic it models
==================  ======================================================
:meth:`poisson`     memoryless steady-state traffic — independent users at
                    fixed per-tenant rates (M/·/· arrivals)
:meth:`diurnal`     a day/night cycle: a non-homogeneous Poisson process
                    whose rate swings sinusoidally between ``base_rate``
                    and ``peak_rate`` (generated by thinning)
:meth:`mmpp`        bursty traffic: a Markov-modulated Poisson process
                    alternating between rate states with exponential
                    dwell times (``burst`` is the 2-state quiet/burst
                    convenience wrapper)
==================  ======================================================

Operators compose and reshape traces without re-seeding: :meth:`merge`
(union of tenant streams), :meth:`scaled` (compress time by a factor —
the offered-load knob a saturation sweep turns: a Poisson process sped up
×f is a Poisson process at rate ×f, with the identical arrival sequence),
and :meth:`window` (a sub-interval, re-anchored at 0).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np


def _freeze(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    a.setflags(write=False)
    return a


def _rng(seed: int, *stream: int) -> np.random.Generator:
    """A child generator keyed on (seed, stream...) so per-tenant streams
    are independent yet fully determined by the trace seed."""
    return np.random.default_rng([int(seed), *map(int, stream)])


def _exponential_arrivals(rng: np.random.Generator, rate: float,
                          horizon: float) -> np.ndarray:
    """Homogeneous Poisson arrival instants on [0, horizon) — drawn in
    vectorized chunks (cumsum of exponential gaps), topped up until the
    process provably crosses the horizon."""
    if rate <= 0 or horizon <= 0:
        return np.empty(0, np.float64)
    mean = rate * horizon
    n = int(mean + 10.0 * np.sqrt(mean) + 16)
    times = np.cumsum(rng.exponential(1.0 / rate, size=n))
    while times[-1] < horizon:           # astronomically rare top-up
        extra = np.cumsum(rng.exponential(1.0 / rate, size=n)) + times[-1]
        times = np.concatenate([times, extra])
    return times[times < horizon]


@dataclasses.dataclass(frozen=True)
class ArrivalTrace:
    """An immutable, time-sorted arrival schedule over named tenants.

    Attributes:
        times: (N,) float64, non-decreasing arrival instants in seconds.
        tenant_ids: (N,) int32 indices into ``tenants``.
        tenants: the tenant names the ids index.
        horizon: the generation window's end (rates are counts/horizon).
    """

    times: np.ndarray
    tenant_ids: np.ndarray
    tenants: tuple[str, ...]
    horizon: float

    def __post_init__(self) -> None:
        times = np.asarray(self.times, np.float64)
        ids = np.asarray(self.tenant_ids, np.int32)
        if times.shape != ids.shape or times.ndim != 1:
            raise ValueError("times and tenant_ids must be 1-D and equal "
                             f"length, got {times.shape} vs {ids.shape}")
        if times.size and np.any(np.diff(times) < 0):
            order = np.argsort(times, kind="stable")
            times, ids = times[order], ids[order]
        if ids.size and (ids.min() < 0 or ids.max() >= len(self.tenants)):
            raise ValueError("tenant_ids index outside tenants")
        object.__setattr__(self, "times", _freeze(times))
        object.__setattr__(self, "tenant_ids", _freeze(ids))
        object.__setattr__(self, "tenants", tuple(self.tenants))
        object.__setattr__(self, "horizon", float(self.horizon))

    # ---------------------------------------------------------- constructors
    @classmethod
    def poisson(cls, rates: Mapping[str, float], horizon: float,
                seed: int = 0) -> "ArrivalTrace":
        """Independent homogeneous Poisson streams: ``rates`` maps tenant
        name → arrivals/second.  Each tenant draws from its own child
        generator, so adding a tenant never perturbs another's stream."""
        tenants = tuple(rates)
        parts_t, parts_i = [], []
        for ti, name in enumerate(tenants):
            t = _exponential_arrivals(_rng(seed, ti), rates[name], horizon)
            parts_t.append(t)
            parts_i.append(np.full(t.shape, ti, np.int32))
        return cls._merged(parts_t, parts_i, tenants, horizon)

    @classmethod
    def diurnal(cls, rates: Mapping[str, float], horizon: float,
                seed: int = 0, *, peak_factor: float = 3.0,
                period: float | None = None,
                phase: float = 0.0) -> "ArrivalTrace":
        """A day/night cycle: per-tenant non-homogeneous Poisson with
        ``λ(t) = base · (1 + (peak_factor−1) · (1−cos(2π(t+phase)/period))/2)``
        — rate swings between ``base`` and ``base · peak_factor`` once per
        ``period`` (default: the horizon).  Generated by thinning a
        homogeneous process at the peak rate."""
        if peak_factor < 1.0:
            raise ValueError("peak_factor must be >= 1 (base is the trough)")
        period = horizon if period is None else float(period)
        tenants = tuple(rates)
        parts_t, parts_i = [], []
        for ti, name in enumerate(tenants):
            rng = _rng(seed, ti, 1)
            peak = rates[name] * peak_factor
            t = _exponential_arrivals(rng, peak, horizon)
            lam = rates[name] * (1.0 + (peak_factor - 1.0)
                                 * 0.5 * (1.0 - np.cos(
                                     2.0 * np.pi * (t + phase) / period)))
            t = t[rng.random(t.shape) * peak < lam]
            parts_t.append(t)
            parts_i.append(np.full(t.shape, ti, np.int32))
        return cls._merged(parts_t, parts_i, tenants, horizon)

    @classmethod
    def mmpp(cls, rates: Mapping[str, float], horizon: float,
             seed: int = 0, *, state_factors: Sequence[float] = (0.2, 4.0),
             mean_dwell: float | Sequence[float] = 5.0) -> "ArrivalTrace":
        """A Markov-modulated Poisson process: one shared state chain
        cycles through ``state_factors`` (multipliers on each tenant's
        base rate) with exponential dwell times of mean ``mean_dwell``
        (scalar, or one mean per state).  Within a state the process is
        homogeneous Poisson — the classic burst model: long quiet
        stretches punctured by arrival storms all tenants feel at once."""
        factors = tuple(float(f) for f in state_factors)
        if len(factors) < 2:
            raise ValueError("mmpp needs >= 2 rate states")
        dwells = ((float(mean_dwell),) * len(factors)
                  if np.isscalar(mean_dwell) else tuple(mean_dwell))
        if len(dwells) != len(factors):
            raise ValueError("one mean_dwell per state (or a scalar)")
        chain = _rng(seed, 0, 2)
        # state timeline: (start, factor) segments covering [0, horizon)
        segs: list[tuple[float, float, float]] = []
        t, s = 0.0, 0
        while t < horizon:
            d = chain.exponential(dwells[s])
            segs.append((t, min(t + d, horizon), factors[s]))
            t += d
            s = (s + 1) % len(factors)
        tenants = tuple(rates)
        parts_t, parts_i = [], []
        for ti, name in enumerate(tenants):
            rng = _rng(seed, ti, 3)
            seg_t = [_exponential_arrivals(rng, rates[name] * f, b - a) + a
                     for a, b, f in segs]
            t = (np.concatenate(seg_t) if seg_t
                 else np.empty(0, np.float64))
            parts_t.append(t)
            parts_i.append(np.full(t.shape, ti, np.int32))
        return cls._merged(parts_t, parts_i, tenants, horizon)

    @classmethod
    def burst(cls, rates: Mapping[str, float], horizon: float,
              seed: int = 0, *, burst_factor: float = 8.0,
              quiet_dwell: float = 8.0,
              burst_dwell: float = 2.0) -> "ArrivalTrace":
        """Quiet/burst traffic — the 2-state :meth:`mmpp` convenience:
        base-rate stretches of mean ``quiet_dwell`` seconds, storms at
        ``burst_factor``× of mean ``burst_dwell`` seconds."""
        return cls.mmpp(rates, horizon, seed,
                        state_factors=(1.0, burst_factor),
                        mean_dwell=(quiet_dwell, burst_dwell))

    @classmethod
    def _merged(cls, parts_t: list[np.ndarray], parts_i: list[np.ndarray],
                tenants: tuple[str, ...], horizon: float) -> "ArrivalTrace":
        if parts_t:
            times = np.concatenate(parts_t)
            ids = np.concatenate(parts_i)
        else:
            times, ids = np.empty(0, np.float64), np.empty(0, np.int32)
        # lexsort: time first, tenant index breaking exact ties — a total,
        # replay-stable order
        order = np.lexsort((ids, times))
        return cls(times[order], ids[order], tenants, horizon)

    # ------------------------------------------------------------- operators
    def merge(self, *others: "ArrivalTrace") -> "ArrivalTrace":
        """The union stream.  Tenant name sets may overlap — same-named
        tenants pool into one stream; the horizon is the max."""
        tenants = list(self.tenants)
        index = {n: i for i, n in enumerate(tenants)}
        parts_t = [np.asarray(self.times)]
        parts_i = [np.asarray(self.tenant_ids)]
        horizon = self.horizon
        for o in others:
            remap = np.empty(max(len(o.tenants), 1), np.int32)
            for i, n in enumerate(o.tenants):
                if n not in index:
                    index[n] = len(tenants)
                    tenants.append(n)
                remap[i] = index[n]
            parts_t.append(np.asarray(o.times))
            parts_i.append(remap[o.tenant_ids] if len(o) else
                           np.empty(0, np.int32))
            horizon = max(horizon, o.horizon)
        return self._merged(parts_t, parts_i, tuple(tenants), horizon)

    def scaled(self, factor: float) -> "ArrivalTrace":
        """Offered load × ``factor``: the same arrival sequence compressed
        in time (``t → t/factor``).  For (modulated) Poisson processes
        this is exactly a rate-×factor process, so a saturation sweep over
        factors replays *one* seeded sequence at every load level instead
        of re-seeding per level."""
        if factor <= 0:
            raise ValueError("factor must be positive")
        return ArrivalTrace(self.times / factor, self.tenant_ids,
                            self.tenants, self.horizon / factor)

    def window(self, t0: float, t1: float) -> "ArrivalTrace":
        """Arrivals with ``t0 <= time < t1``, re-anchored at 0."""
        m = (self.times >= t0) & (self.times < t1)
        return ArrivalTrace(self.times[m] - t0, self.tenant_ids[m],
                            self.tenants, t1 - t0)

    # ----------------------------------------------------------------- stats
    def counts(self) -> dict[str, int]:
        """Arrivals per tenant."""
        c = np.bincount(self.tenant_ids, minlength=len(self.tenants))
        return {n: int(c[i]) for i, n in enumerate(self.tenants)}

    def offered_rates(self) -> dict[str, float]:
        """Arrivals/second per tenant over the horizon."""
        h = max(self.horizon, 1e-12)
        return {n: c / h for n, c in self.counts().items()}

    def offered_rate(self) -> float:
        """Total arrivals/second over the horizon."""
        return len(self) / max(self.horizon, 1e-12)

    def __len__(self) -> int:
        return int(self.times.size)

    def __repr__(self) -> str:
        if not len(self):
            return f"ArrivalTrace(empty, horizon={self.horizon:.3g}s)"
        return (f"ArrivalTrace({len(self)} arrivals, "
                f"{len(self.tenants)} tenants, "
                f"{self.offered_rate():.3g}/s over {self.horizon:.3g}s)")
