"""Observability of the port; port of ``repro/obs``. So far the per-lane
traversal counters (``obs/stats.py``, ``TraversalStats``); span tracing
and the metrics registry are ROADMAP A13."""
from repro_torch.obs.stats import TraversalStats

__all__ = ["TraversalStats"]
