"""Host-side span tracer with Chrome-trace-event export; port of
``repro/obs/trace.py``.

CUDA launches are asynchronous: a host clock around a call measures the
enqueue, not the work. Each :class:`Span` therefore carries an optional
FENCE, tensors (in any nesting of tuples, lists, NamedTuples and dicts)
that it drains before it closes: for a CUDA tensor it synchronizes its
device's current stream, the stream the port's work runs on (the
counterpart of ``jax.block_until_ready``); a CPU tensor needs nothing.
So a span's duration covers the device work it launched. Spans nest
through a plain stack; the export is the reference's Chrome trace event
JSON (``{"traceEvents": [...]}``, "X" complete events), which Perfetto
(ui.perfetto.dev) and ``chrome://tracing`` load.

Usage::

    tracer = SpanTracer()
    with tracer.span("dbscan", n=4096) as sp:
        res = fdbscan(pts, eps, 2)
        sp.fence(res)          # synchronize before the span closes
    tracer.export("trace.json")

``traced(tracer, name, fn, *args)`` is the one-liner of the pipeline
wiring (``halos/merge.py``, ``core/distributed.py``, ``analysis/insitu.py``):
with ``tracer=None`` it calls ``fn`` directly, with no fence, so tracing
stays opt-in.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Callable

import torch

__all__ = ["Span", "SpanTracer", "traced", "load_chrome_trace", "span_tree",
           "block_until_ready"]


def block_until_ready(value) -> None:
    """Wait for the device work behind every tensor in ``value`` (a tensor
    or any nesting of tuples, lists, NamedTuples and dicts; other leaves
    are ignored): one synchronize of the current stream per CUDA device."""
    devices, stack = set(), [value]
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                devices.add(v.device)
        elif isinstance(v, dict):
            stack.extend(v.values())
        elif isinstance(v, (tuple, list)):
            stack.extend(v)
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


class Span:
    """One open span; created by :meth:`SpanTracer.span`."""

    def __init__(self, tracer: "SpanTracer", name: str, depth: int,
                 args: dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.depth = depth
        self.args = args
        self.t0 = 0.0
        self._fences: list[Any] = []

    def fence(self, value):
        """Register tensors the span must drain before closing. Returns
        ``value`` so the call can wrap an expression in place."""
        self._fences.append(value)
        return value

    def __enter__(self) -> "Span":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            for v in self._fences:
                block_until_ready(v)
        self.tracer._close(self, time.perf_counter())


class SpanTracer:
    """Nested spans -> Chrome trace events. Single-threaded by design (one
    ``tid``): the sharded entry points open their spans in the caller's
    thread, around the whole mesh; nesting is encoded by timestamp
    containment, which is how Perfetto stacks "X" events on a track."""

    def __init__(self, process_name: str = "repro"):
        self.process_name = process_name
        self._epoch = time.perf_counter()
        self._stack: list[Span] = []
        self.events: list[dict] = []

    # --- recording ----------------------------------------------------------

    def span(self, name: str, **args) -> Span:
        sp = Span(self, name, depth=len(self._stack), args=args)
        self._stack.append(sp)
        return sp

    def _close(self, sp: Span, t1: float) -> None:
        # close any dangling children first (exception unwind safety)
        while self._stack and self._stack[-1] is not sp:
            self._stack.pop()
        if self._stack:
            self._stack.pop()
        self.events.append({
            "name": sp.name,
            "ph": "X",
            "ts": (sp.t0 - self._epoch) * 1e6,   # Chrome traces are in us
            "dur": (t1 - sp.t0) * 1e6,
            "pid": os.getpid(),
            "tid": 0,
            "cat": "repro",
            "args": {**sp.args, "depth": sp.depth},
        })

    def instant(self, name: str, **args) -> None:
        """A zero-duration marker event."""
        self.events.append({
            "name": name, "ph": "i", "s": "t",
            "ts": (time.perf_counter() - self._epoch) * 1e6,
            "pid": os.getpid(), "tid": 0, "cat": "repro", "args": args,
        })

    def counter(self, name: str, **series) -> None:
        """A counter track sample (Perfetto renders these as line plots)."""
        self.events.append({
            "name": name, "ph": "C",
            "ts": (time.perf_counter() - self._epoch) * 1e6,
            "pid": os.getpid(), "tid": 0, "cat": "repro",
            "args": {k: float(v) for k, v in series.items()},
        })

    # --- export -------------------------------------------------------------

    def to_chrome(self) -> dict:
        meta = {
            "name": "process_name", "ph": "M", "pid": os.getpid(), "tid": 0,
            "args": {"name": self.process_name},
        }
        return {"traceEvents": [meta] + self.events,
                "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        """Write the Chrome-trace JSON; returns ``path``."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1)
        return path


def traced(tracer: SpanTracer | None, name: str, fn: Callable, *args,
           span_args: dict | None = None, **kwargs):
    """Run ``fn(*args, **kwargs)`` inside a fenced span, or, with
    ``tracer=None``, call it directly."""
    if tracer is None:
        return fn(*args, **kwargs)
    with tracer.span(name, **(span_args or {})) as sp:
        return sp.fence(fn(*args, **kwargs))


# --- round-trip helpers (tests, tooling) ------------------------------------

def load_chrome_trace(path: str) -> list[dict]:
    """Load a Chrome-trace JSON and return its complete ("X") span events,
    sorted by start time."""
    with open(path) as f:
        tree = json.load(f)
    evs = [e for e in tree["traceEvents"] if e.get("ph") == "X"]
    return sorted(evs, key=lambda e: e["ts"])


def span_tree(events: list[dict]) -> dict[str, list[str]]:
    """Parent -> children mapping recovered purely from timestamp
    containment (the same rule Perfetto uses to stack the track)."""
    out: dict[str, list[str]] = {e["name"]: [] for e in events}
    for child in events:
        best = None
        for parent in events:
            if parent is child:
                continue
            if (parent["ts"] <= child["ts"]
                    and parent["ts"] + parent["dur"]
                    >= child["ts"] + child["dur"]):
                if best is None or parent["dur"] < best["dur"]:
                    best = parent
        if best is not None:
            out[best["name"]].append(child["name"])
    return out
