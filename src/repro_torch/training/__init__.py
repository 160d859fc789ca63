"""The port's training stack, ported from ``repro.training``: AdamW and its
schedules (``optimizer``), the train step (``train_loop``), checkpoints
(``checkpoint``) and the synthetic data (``data``)."""

from . import checkpoint, data, optimizer, train_loop  # noqa: F401
