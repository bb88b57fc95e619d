"""Observability of the port; port of ``repro/obs``: device-side
traversal counters (``obs/stats.py``, ``TraversalStats``), host-side span
tracing with Chrome-trace export (``obs/trace.py``, ``SpanTracer`` /
``traced``) and a unifying metrics registry (``obs/metrics.py``,
``MetricsRegistry``). All three are opt-in: with ``tracer=None`` and
``with_stats=False`` the port runs exactly as without them."""
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.stats import TraversalStats
from repro_torch.obs.trace import (Span, SpanTracer, load_chrome_trace,
                                   span_tree, traced)

__all__ = [
    "TraversalStats",
    "Span",
    "SpanTracer",
    "traced",
    "load_chrome_trace",
    "span_tree",
    "MetricsRegistry",
]
