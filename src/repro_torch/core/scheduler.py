"""Run-time Scheduler FSM states (Fig. 4 of the paper), copied from
``repro.core.scheduler.State``."""

from __future__ import annotations

import enum


class State(enum.Enum):
    ANALYZE = "analyze"
    EXPLORE = "explore"
    GLOBAL_OFFLOAD = "global_offload"
    LOCAL_MAP = "local_map"
    EXECUTE = "execute"
