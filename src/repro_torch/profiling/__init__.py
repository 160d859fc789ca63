"""The port's copy of ``repro.profiling``: the paper's DNN Model Analyzer.

Closed loop with the rest of the port:

    Profiler  ──samples──▶  LearnedCostModel  ──versioned──▶  CalibrationStore
        ▲                        │
        │                 CalibratedCostProvider  ──▶  HiDP planner
        │                        ▲
    measured decode steps        │ EWMA blend + drift-triggered refit
    (serving engine)      ──▶  FeedbackLoop  ──on_drift──▶  re-plan

Every module but the kernel sweep (``Profiler.profile_kernels``, written on
torch) is a copy of its counterpart; the tests hold the two equal.
"""

from .learned import LearnedCostModel, Sample  # noqa: F401
from .profiler import (DEFAULT_KERNEL_SHAPES, Profiler,  # noqa: F401
                       SyntheticGroundTruth, block_traffic)
from .provider import CalibratedCostProvider  # noqa: F401
from .store import CalibrationStore  # noqa: F401
from .feedback import DriftEvent, FeedbackLoop  # noqa: F401


def calibrate(cluster, dags, deltas, *, ground_truth=None,
              mode: str = "linear", profiler: "Profiler | None" = None
              ) -> "CalibratedCostProvider":
    """One-call convenience: profile → fit → wrap as a CostProvider."""
    prof = profiler or Profiler()
    samples = prof.profile_cluster(cluster, dags, deltas,
                                   ground_truth=ground_truth)
    model = LearnedCostModel.fit(samples, mode=mode)
    return CalibratedCostProvider(model)


def calibrate_kernels(store: "CalibrationStore", cluster, *,
                      shapes=None, kinds=None, devices=None,
                      profiler: "Profiler | None" = None,
                      telemetry=None, mode: str = "linear",
                      note: str = "real-kernel sweep"
                      ) -> tuple["LearnedCostModel", int]:
    """Close the real-hardware calibration loop in one call: sweep the
    port's kernels through :meth:`Profiler.profile_kernels` on **every
    visible GPU** (per-device Sample keys ``cuda:<index>``; pass
    ``devices=`` to restrict the sweep, or ``devices=["cpu"]`` for the
    plain versions on the CPU, keyed ``cpu:0``),
    fit a :class:`LearnedCostModel` from the pooled measurements, and
    persist it through ``store`` for ``cluster``.  Returns
    ``(model, version)`` — the saved ``CalibrationStore`` version a
    ``PlanCache`` keys on.  Without a GPU and without ``devices=`` it
    raises: nothing falls back to the CPU.

    With ``telemetry`` each measured point lands as a ``profile.kernel``
    span and the save as a ``profile.calibration`` counter (attrs:
    version, devices, samples).
    """
    import torch

    from repro_torch.telemetry import active as _tel_active

    tel = _tel_active(telemetry)
    prof = profiler or Profiler()
    if devices is None:
        if torch.cuda.device_count() == 0:
            raise RuntimeError(
                "calibrate_kernels sweeps every visible GPU, and torch sees "
                "none; pass devices=['cpu'] to sweep the plain versions on "
                "the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    samples: list[Sample] = []
    for dev in devices:
        samples.extend(prof.profile_kernels(
            shapes=shapes, kinds=kinds, device=dev, telemetry=telemetry))
    model = LearnedCostModel.fit(samples, mode=mode)
    version = store.save(cluster, model, note=note)
    if tel is not None:
        tel.counter("profile.calibration", version=version,
                    devices=len(devices), samples=len(samples),
                    note=note)
    return model, version
