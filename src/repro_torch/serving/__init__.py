"""Serving engine of the port and its copy of the plan cache.

The package exports the plan cache's names, as ``repro.serving`` does;
the engine (``repro_torch.serving.engine``), which imports torch, is
imported from its module."""

from .plan_cache import (CacheEntry, LRUEviction, PlanCache,  # noqa: F401
                         SpeculativePrewarmer)
