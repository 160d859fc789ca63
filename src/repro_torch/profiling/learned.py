"""The port's copy of ``repro.profiling.learned``.

LearnedCostModel — the regression half of the paper's DNN Model Analyzer.

The paper fits random-forest predictors mapping block features to per-block
latency **and energy** on each processor class.  We keep the *role* (measured
samples in, per-(block-kind × processor) predictions out) with two
dependency-free regressors:

* ``linear``   — non-negative least squares over (work, traffic, 1), where
                 ``work`` is δ-weighted FLOPs (device cycles) and ``traffic``
                 is bytes touched (params + activations).  The marginal
                 d latency/d work is the processor's *measured* inverse rate —
                 exactly the quantity the analytic model guesses from
                 datasheets.
* ``isotonic`` — pool-adjacent-violators over work → latency, for processors
                 whose latency curve is monotone but not affine (cache
                 cliffs, DVFS steps).  Predictions interpolate the fitted
                 step curve and extrapolate proportionally.

Energy predictors reuse the same machinery: every ``Sample`` carrying
``energy_j > 0`` contributes to a per-(key × kind) *energy* entry fitted
over (work, traffic, 1) exactly like latency — the marginal d energy/d work
is the processor's measured joules-per-flop, the quantity the analytic
model derives as ``active_power / rate``.  Latency and energy entries
serialize, EWMA-blend, and fall back identically.

Models serialize to/from JSON so a ``CalibrationStore`` can version them per
cluster fingerprint, and support EWMA blending of online observations (the
run-time scheduler feeding measurements back — paper Fig. 4's EXECUTE →
ANALYZE edge).

Keys are resource names: ``"orin_nx/gpu"`` for a processor, ``"orin_nx"``
for a node.  Node-level rates aggregate fitted processor rates, mirroring
Λ_j = Σ_k λ_k (Eq. 2) with measured λ.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable, Mapping, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Sample:
    """One measured (or micro-benchmarked) block execution."""

    key: str                     # "node/proc" (or "node")
    kind: str                    # block kind: conv/dwconv/dense/attn/...
    work: float                  # δ-weighted FLOPs (device cycles)
    traffic: float               # bytes touched: params + activations
    latency_s: float
    energy_j: float = 0.0


@dataclasses.dataclass
class _Entry:
    a: float                     # seconds per work unit (1/rate)
    b: float                     # seconds per byte of traffic
    c: float                     # fixed per-block overhead (s)
    n: int = 0                   # samples behind the fit
    mape: float = 0.0            # in-sample fit error
    iso_x: tuple[float, ...] = ()
    iso_y: tuple[float, ...] = ()

    def linear(self, work: float, traffic: float) -> float:
        return self.a * work + self.b * traffic + self.c


def _nnls(X: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Tiny non-negative least squares: iteratively drop negative columns.

    Columns are norm-scaled first so the solve is well-conditioned despite
    work ~1e11 vs traffic ~1e6 vs the constant column."""
    norms = np.linalg.norm(X, axis=0)
    norms[norms == 0] = 1.0
    Xs = X / norms
    cols = list(range(X.shape[1]))
    coef = np.zeros(X.shape[1])
    for _ in range(X.shape[1] + 1):
        if not cols:
            break
        sol, *_ = np.linalg.lstsq(Xs[:, cols], y, rcond=None)
        if (sol >= 0).all():
            for ci, s in zip(cols, sol):
                coef[ci] = s
            break
        cols = [ci for ci, s in zip(cols, sol) if s > 0]
    return coef / norms


def _pava(x: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pool-adjacent-violators: isotonic (non-decreasing) fit of y over x."""
    order = np.argsort(x)
    xs, ys = x[order], y[order].astype(float)
    level_y = list(ys)
    level_w = [1.0] * len(ys)
    level_n = [1] * len(ys)
    i = 0
    while i < len(level_y) - 1:
        if level_y[i] > level_y[i + 1] + 1e-18:
            w = level_w[i] + level_w[i + 1]
            merged = (level_y[i] * level_w[i]
                      + level_y[i + 1] * level_w[i + 1]) / w
            level_y[i] = merged
            level_w[i] = w
            level_n[i] += level_n[i + 1]
            del level_y[i + 1], level_w[i + 1], level_n[i + 1]
            i = max(i - 1, 0)
        else:
            i += 1
    fit = np.concatenate([np.full(n, v) for v, n in zip(level_y, level_n)])
    return xs, fit


class LearnedCostModel:
    """Per-(key × kind) latency *and energy* predictors fitted from
    ProfileSamples.

    ``entries`` maps (key, kind) → latency predictor (seconds);
    ``energy_entries`` maps (key, kind) → energy predictor (joules).  Both
    are :class:`_Entry` instances fitted by the same NNLS/isotonic
    machinery, so everything said about latency fitting, fallback, EWMA
    blending, and serialization holds for energy too.
    """

    def __init__(self, mode: str = "linear"):
        if mode not in ("linear", "isotonic"):
            raise ValueError(mode)
        self.mode = mode
        self.entries: dict[tuple[str, str], _Entry] = {}
        self.energy_entries: dict[tuple[str, str], _Entry] = {}
        # Monotone mutation counter: every (re)fit or online observation
        # bumps it, so planner workspaces (repro_torch.core.dp_cache) keyed on
        # this model can tell cached DP rows went stale.
        self.revision = 0

    # ------------------------------------------------------------------- fit
    @classmethod
    def fit(cls, samples: Iterable[Sample],
            mode: str = "linear") -> "LearnedCostModel":
        """Fit latency predictors for every (key × kind) group, and energy
        predictors for every group whose samples carry ``energy_j``."""
        model = cls(mode=mode)
        groups: dict[tuple[str, str], list[Sample]] = {}
        for s in samples:
            groups.setdefault((s.key, s.kind), []).append(s)
        for (key, kind), group in sorted(groups.items()):
            model.fit_entry(key, kind,
                            [(s.work, s.traffic, s.latency_s) for s in group])
            energy_rows = [(s.work, s.traffic, s.energy_j)
                           for s in group if s.energy_j > 0]
            if energy_rows:
                model.fit_energy_entry(key, kind, energy_rows)
        return model

    def fit_entry(self, key: str, kind: str,
                  rows: Sequence[tuple[float, float, float]]) -> None:
        """(Re)fit one latency predictor from (work, traffic, latency) rows."""
        self.entries[(key, kind)] = self._fit_rows(key, kind, rows)
        self.revision += 1

    def fit_energy_entry(self, key: str, kind: str,
                         rows: Sequence[tuple[float, float, float]]) -> None:
        """(Re)fit one energy predictor from (work, traffic, joules) rows —
        the same regression as latency with joules as the response."""
        self.energy_entries[(key, kind)] = self._fit_rows(key, kind, rows)
        self.revision += 1

    def _fit_rows(self, key: str, kind: str,
                  rows: Sequence[tuple[float, float, float]]) -> _Entry:
        arr = np.asarray(rows, dtype=float)
        if arr.ndim != 2 or arr.shape[0] == 0:
            raise ValueError(f"no samples for ({key}, {kind})")
        work, traffic, lat = arr[:, 0], arr[:, 1], arr[:, 2]
        # Only fit columns the samples can identify: with a single distinct
        # work value (or traffic collinear with work) the full design is
        # rank-deficient and minimum-norm lstsq splits latency arbitrarily
        # across coefficients — biasing the marginal rate 1/a.
        distinct_work = np.unique(work).size
        use_traffic = (np.ptp(traffic)
                       > 1e-9 * (np.mean(np.abs(traffic)) + 1e-12))
        if use_traffic and np.ptp(work) > 0:
            corr = np.corrcoef(work, traffic)[0, 1]
            if abs(corr) > 0.9999:
                use_traffic = False
        if distinct_work < 2:
            coef = np.array([float(np.mean(lat / np.maximum(work, 1e-12))),
                             0.0, 0.0])
        else:
            cols = [work]
            layout = [0]
            if use_traffic:
                cols.append(traffic)
                layout.append(1)
            cols.append(np.ones_like(work))
            layout.append(2)
            sol = _nnls(np.stack(cols, axis=1), lat)
            coef = np.zeros(3)
            coef[layout] = sol
            if coef[0] <= 0:          # degenerate: fall back to mean rate
                coef = np.array([float(np.mean(lat / np.maximum(work, 1e-12))),
                                 0.0, 0.0])
        pred = coef[0] * work + coef[1] * traffic + coef[2]
        mape = float(np.mean(np.abs(pred - lat) / np.maximum(lat, 1e-12)))
        entry = _Entry(a=float(coef[0]), b=float(coef[1]), c=float(coef[2]),
                       n=int(arr.shape[0]), mape=mape)
        if self.mode == "isotonic" and arr.shape[0] >= 2:
            xs, ys = _pava(work, lat)
            entry.iso_x, entry.iso_y = tuple(map(float, xs)), tuple(
                map(float, ys))
        return entry

    # --------------------------------------------------------------- queries
    @staticmethod
    def _lookup(table: dict[tuple[str, str], _Entry], key: str,
                kind: str) -> _Entry | None:
        e = table.get((key, kind))
        if e is None:
            e = table.get((key, "generic"))
        return e

    def _entry_for(self, key: str, kind: str) -> _Entry | None:
        return self._lookup(self.entries, key, kind)

    def entry(self, key: str, kind: str) -> _Entry | None:
        """The fitted latency predictor serving (key, kind), with generic
        fallback."""
        return self._entry_for(key, kind)

    def energy_entry(self, key: str, kind: str) -> _Entry | None:
        """The fitted energy predictor serving (key, kind), with generic
        fallback."""
        return self._lookup(self.energy_entries, key, kind)

    def rate(self, key: str, kind: str = "generic") -> float | None:
        """Measured work-units/s (δ=1 FLOP/s).  Node keys aggregate their
        processors' fitted rates: Λ_j = Σ_k λ_k with measured λ."""
        e = self._entry_for(key, kind)
        if e is not None and e.a > 0:
            return 1.0 / e.a
        prefix = key + "/"
        children = {k for (k, _) in self.entries if k.startswith(prefix)}
        rates = [r for r in (self.rate(c, kind) for c in sorted(children))
                 if r is not None]
        if rates:
            return sum(rates)
        return None

    def predict(self, key: str, kind: str, work: float,
                traffic: float = 0.0) -> float | None:
        """Predicted latency in seconds, or None when uncalibrated."""
        e = self._entry_for(key, kind)
        if e is None:
            r = self.rate(key, kind)      # node-level aggregation
            return None if r is None else work / max(r, 1e-300)
        return self._evaluate(e, work, traffic)

    def _evaluate(self, e: _Entry, work: float, traffic: float) -> float:
        if self.mode == "isotonic" and e.iso_x:
            x, y = e.iso_x, e.iso_y
            if work >= x[-1]:
                return y[-1] * (work / x[-1]) if x[-1] > 0 else y[-1]
            if work <= x[0]:
                return y[0] * (work / x[0]) if x[0] > 0 else y[0]
            return float(np.interp(work, x, y))
        return e.linear(work, traffic)

    def predict_energy(self, key: str, kind: str, work: float,
                       traffic: float = 0.0) -> float | None:
        """Predicted active energy in joules, or None when uncalibrated.

        Node keys aggregate their processors: the work splits across the
        fitted children in proportion to their measured rates (the share
        each realises under Λ_j = Σ_k λ_k) and each share is priced by the
        child's energy predictor."""
        e = self.energy_entry(key, kind)
        if e is not None:
            return self._evaluate(e, work, traffic)
        prefix = key + "/"
        children = sorted({k for (k, _) in self.energy_entries
                           if k.startswith(prefix)})
        shares = [(c, self.rate(c, kind)) for c in children]
        shares = [(c, r) for c, r in shares if r is not None]
        total = sum(r for _, r in shares)
        if not shares or total <= 0:
            return None
        joules = 0.0
        for c, r in shares:
            p = self.predict_energy(c, kind, work * r / total,
                                    traffic * r / total)
            if p is None:
                return None
            joules += p
        return joules

    # ------------------------------------------------------ online blending
    def observe(self, key: str, kind: str, work: float, traffic: float,
                latency_s: float, alpha: float = 0.3) -> None:
        """EWMA-blend one measured execution into the fitted rate."""
        if work <= 0 or latency_s <= 0:
            return
        self.revision += 1
        e = self.entries.get((key, kind))
        if e is None:
            self.entries[(key, kind)] = _Entry(
                a=latency_s / work, b=0.0, c=0.0, n=1)
            return
        resid = max(latency_s - e.b * traffic - e.c, 1e-12)
        implied_a = resid / work
        e.a = (1.0 - alpha) * e.a + alpha * implied_a
        e.n += 1
        if e.iso_x:
            # keep the isotonic curve consistent with the blended rate by
            # scaling it toward the observation
            scale = implied_a / max(e.a, 1e-300)
            blend = (1.0 - alpha) + alpha * scale
            e.iso_y = tuple(v * blend for v in e.iso_y)

    def observe_energy(self, key: str, kind: str, work: float, traffic: float,
                       energy_j: float, alpha: float = 0.3) -> None:
        """EWMA-blend one measured execution's joules into the fitted
        marginal energy — the energy twin of :meth:`observe`."""
        if work <= 0 or energy_j <= 0:
            return
        self.revision += 1
        e = self.energy_entries.get((key, kind))
        if e is None:
            self.energy_entries[(key, kind)] = _Entry(
                a=energy_j / work, b=0.0, c=0.0, n=1)
            return
        resid = max(energy_j - e.b * traffic - e.c, 1e-12)
        implied_a = resid / work
        e.a = (1.0 - alpha) * e.a + alpha * implied_a
        e.n += 1
        if e.iso_x:
            scale = implied_a / max(e.a, 1e-300)
            blend = (1.0 - alpha) + alpha * scale
            e.iso_y = tuple(v * blend for v in e.iso_y)

    # --------------------------------------------------------- serialization
    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    def to_dict(self) -> dict:
        def table(entries: dict[tuple[str, str], _Entry]) -> dict:
            return {f"{key}|{kind}": dataclasses.asdict(e)
                    for (key, kind), e in sorted(entries.items())}
        return {
            "mode": self.mode,
            "entries": table(self.entries),
            "energy_entries": table(self.energy_entries),
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "LearnedCostModel":
        model = cls(mode=d.get("mode", "linear"))

        def load(table: Mapping, into: dict) -> None:
            for joint, ed in table.items():
                key, _, kind = joint.rpartition("|")
                into[(key, kind)] = _Entry(
                    a=ed["a"], b=ed["b"], c=ed["c"], n=ed.get("n", 0),
                    mape=ed.get("mape", 0.0),
                    iso_x=tuple(ed.get("iso_x", ())),
                    iso_y=tuple(ed.get("iso_y", ())))
        load(d.get("entries", {}), model.entries)
        load(d.get("energy_entries", {}), model.energy_entries)
        return model

    @classmethod
    def from_json(cls, text: str) -> "LearnedCostModel":
        return cls.from_dict(json.loads(text))

    # ------------------------------------------------------------ diagnostics
    def mape_against(self, samples: Iterable[Sample]) -> float:
        """Mean absolute percentage latency error of this model over samples."""
        errs = []
        for s in samples:
            p = self.predict(s.key, s.kind, s.work, s.traffic)
            if p is not None:
                errs.append(abs(p - s.latency_s) / max(s.latency_s, 1e-12))
        return float(np.mean(errs)) if errs else float("nan")

    def energy_mape_against(self, samples: Iterable[Sample]) -> float:
        """Mean absolute percentage energy error over samples carrying
        ``energy_j``."""
        errs = []
        for s in samples:
            if s.energy_j <= 0:
                continue
            p = self.predict_energy(s.key, s.kind, s.work, s.traffic)
            if p is not None:
                errs.append(abs(p - s.energy_j) / max(s.energy_j, 1e-12))
        return float(np.mean(errs)) if errs else float("nan")
