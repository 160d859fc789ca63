"""The port's copy of ``repro.profiling.store``.

CalibrationStore — versioned fitted models, keyed by cluster fingerprint.

A calibration is only valid for the hardware it was measured on, so models
are filed under a fingerprint of the cluster's declared topology (node and
processor names, datasheet rates, link bandwidths, affinity tables).  Any
change to the fleet — a board swapped, a link upgraded — changes the
fingerprint and cleanly invalidates old calibrations.  Within a fingerprint,
every ``save`` appends a new monotonically-numbered version; ``load``
returns the latest by default so re-profiling supersedes without deleting
history (the per-request plan cache can key on ``(fingerprint, version)``).

The store also files **warm plan frontiers** next to the calibrations they
were planned under (:meth:`save_fronts` / :meth:`load_fronts`): one
``fronts.json`` per cluster fingerprint, each entry stamped with the
``calibration_version`` it is valid for, the ``dag_fingerprint`` of the
tenant it serves, and the ``membership_fingerprint`` of the availability
mask it was planned over (fronts for distinct memberships persist side by
side, so a node that leaves and returns is served warm across restarts).  ``repro_torch.serving.plan_cache.PlanCache`` persists its warm
table here so a restarted process serves every tenant without re-running
the cold frontier pass; entries whose version no longer matches the live
calibration are dropped on load, so a stale front can never be served.
The store itself treats entries as opaque JSON — encoding/decoding plan
payloads is the cache's job (``repro_torch.core.plan_to_dict`` /
``plan_from_dict``), which keeps profiling free of serving imports.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import time

from repro_torch.core.cost_model import Cluster
from repro_torch.core.fingerprint import cluster_fingerprint

from .learned import LearnedCostModel


@contextlib.contextmanager
def _advisory_lock(path: pathlib.Path):
    """Best-effort exclusive advisory lock on ``path``'s sidecar
    ``.lock`` file (``fcntl.flock``).  Two cooperating processes — a
    serving fleet sharing one ``fronts.json`` — serialize their writes;
    where ``fcntl`` is unavailable (non-POSIX) or the filesystem refuses
    (some network mounts), the lock degrades to a no-op and the atomic
    ``os.replace`` below still guarantees readers never see a torn file.
    """
    try:
        import fcntl
    except ImportError:                      # pragma: no cover - non-POSIX
        yield
        return
    lock_path = path.with_suffix(path.suffix + ".lock")
    with open(lock_path, "w") as lock:
        try:
            fcntl.flock(lock, fcntl.LOCK_EX)
        except OSError:                      # pragma: no cover - odd mounts
            yield
            return
        try:
            yield
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


class CalibrationStore:
    def __init__(self, root: str | pathlib.Path):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    # ----------------------------------------------------------- fingerprint
    # Shared with repro_torch.serving.plan_cache.PlanCache so calibration paths and
    # plan-cache keys can never hash the cluster differently.
    fingerprint = staticmethod(cluster_fingerprint)

    def _dir(self, cluster: Cluster) -> pathlib.Path:
        return self.root / self.fingerprint(cluster)

    # ----------------------------------------------------------------- save
    def save(self, cluster: Cluster, model: LearnedCostModel,
             note: str = "") -> int:
        d = self._dir(cluster)
        d.mkdir(parents=True, exist_ok=True)
        version = (self.versions(cluster) or [0])[-1] + 1
        payload = {
            "fingerprint": self.fingerprint(cluster),
            "version": version,
            "note": note,
            "created_unix": time.time(),
            "model": model.to_dict(),
        }
        path = d / f"v{version:04d}.json"
        path.write_text(json.dumps(payload, sort_keys=True, indent=1))
        return version

    # ----------------------------------------------------------------- load
    def versions(self, cluster: Cluster) -> list[int]:
        d = self._dir(cluster)
        if not d.is_dir():
            return []
        return sorted(int(p.stem[1:]) for p in d.glob("v*.json"))

    def load(self, cluster: Cluster,
             version: int | None = None) -> LearnedCostModel:
        versions = self.versions(cluster)
        if not versions:
            raise FileNotFoundError(
                f"no calibration for fingerprint "
                f"{self.fingerprint(cluster)} under {self.root}")
        v = versions[-1] if version is None else version
        path = self._dir(cluster) / f"v{v:04d}.json"
        payload = json.loads(path.read_text())
        return LearnedCostModel.from_dict(payload["model"])

    # ------------------------------------------------------- plan frontiers
    def fronts_path(self, cluster: Cluster) -> pathlib.Path:
        """Where warm plan frontiers live for this cluster — right next to
        its ``v*.json`` calibrations."""
        return self._dir(cluster) / "fronts.json"

    def save_fronts(self, cluster: Cluster, entries: list[dict]) -> int:
        """Persist warm plan frontiers for ``cluster``.

        Each entry is an opaque JSON dict the writer (``PlanCache``) built:
        at minimum ``dag_fingerprint``, ``dag_name``, ``delta``,
        ``calibration_version``, and a serialized ``front``.  The write is
        atomic (per-process temp file + ``os.replace``), mirroring the
        cache's in-memory generation swap: a concurrent reader sees either
        the old table or the new one, never a torn file.  Writers
        additionally serialize on a best-effort advisory ``.lock`` file,
        so two serving processes persisting to one shared store never
        interleave (last writer wins whole-file, not field-by-field).
        Returns the entry count.
        """
        d = self._dir(cluster)
        d.mkdir(parents=True, exist_ok=True)
        payload = {
            "fingerprint": self.fingerprint(cluster),
            "created_unix": time.time(),
            "entries": list(entries),
        }
        path = self.fronts_path(cluster)
        tmp = path.with_suffix(f".json.{os.getpid()}.tmp")
        with _advisory_lock(path):
            tmp.write_text(json.dumps(payload, sort_keys=True))
            os.replace(tmp, path)
        return len(entries)

    def load_fronts(self, cluster: Cluster) -> list[dict]:
        """The persisted frontier entries for ``cluster`` (raw dicts), or
        ``[]`` when none were ever saved.  Filtering stale
        ``calibration_version`` entries is the *loader's* contract
        (``PlanCache.warm_from``) — the store returns what is on disk."""
        path = self.fronts_path(cluster)
        if not path.is_file():
            return []
        payload = json.loads(path.read_text())
        if payload.get("fingerprint") != self.fingerprint(cluster):
            return []
        return payload.get("entries", [])
