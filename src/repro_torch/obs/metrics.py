"""Metrics registry; port of ``repro/obs/metrics.py``: one sink for the
observability crumbs the engine already produces.

``DeviceCsr`` / ``BufferedCsr`` overflow flags and retry ``attempts``,
``GridAutoInfo`` capacity retries, the halo exchange's payload buffers,
``TraversalStats`` counters and the number of distinct argument
signatures of a sweep: one :class:`MetricsRegistry` that any pipeline can
``record`` into (Python numbers, numpy arrays or tensors on any device;
the conversion to host floats happens at :meth:`summary` time, so
recording costs no synchronisation), plus :meth:`observe`, which knows the
port's observability-bearing result types and explodes them into named
series.
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Any, Iterable

import numpy as np
import torch

__all__ = ["MetricsRegistry", "count_signatures"]


def _leaves(value) -> list:
    if isinstance(value, dict):
        return [x for v in value.values() for x in _leaves(v)]
    if isinstance(value, (tuple, list)):
        return [x for v in value for x in _leaves(v)]
    return [value]


def count_signatures(sweep: Iterable[tuple]) -> int:
    """Number of distinct (shape, dtype) signatures across a sweep of
    argument tuples (the reference counts each as one jit cache entry,
    ``repro/staticcheck/jaxpr_audit.py:176-185``)."""
    def signature(args) -> tuple:
        return tuple((tuple(np.shape(x)),
                      str(getattr(x, "dtype", type(x).__name__)))
                     for x in _leaves(args))
    return len({signature(args) for args in sweep})


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.ravel(np.asarray(value)).astype(np.float64)


class MetricsRegistry:
    """Append-only metric sink with lazy host aggregation.

    ``record(name, value)`` accepts Python numbers, numpy arrays and
    tensors (on the card too: they are read at summary time, not at
    record time). ``summary()`` aggregates each series over the FLATTENED
    elements of everything recorded under that name: per-shard columns
    recorded from a sharded entry point therefore aggregate to the global
    count/sum/max without any explicit collective.
    """

    def __init__(self):
        self._series: dict[str, list[Any]] = defaultdict(list)

    # --- recording ----------------------------------------------------------

    def record(self, name: str, value) -> None:
        self._series[name].append(value)

    def record_recompiles(self, name: str, sweep: Iterable[tuple]) -> None:
        """Record the number of distinct argument signatures a workload
        sweep has (the reference's count of compiled shapes)."""
        self.record(f"{name}/compile_signatures", count_signatures(sweep))

    def observe(self, name: str, obj) -> None:
        """Explode a known observability-bearing result into named series.

        Understands ``DeviceCsr`` / ``BufferedCsr`` / ``ShardedCsr`` (hit
        totals, overflow flags, retry attempts), ``GridAutoInfo`` (capacity
        retries), ``HaloExchange`` (ghost rows, payload bytes and overflow)
        and ``TraversalStats`` (the counter totals). Anything else falls
        back to ``record(name, obj)``.
        """
        from repro_torch.core.distributed import HaloExchange, ShardedCsr
        from repro_torch.core.fdbscan_grid import GridAutoInfo
        from repro_torch.core.query import BufferedCsr, DeviceCsr
        from repro_torch.obs.stats import TraversalStats

        if isinstance(obj, DeviceCsr):
            self.record(f"{name}/total", obj.total)
            self.record(f"{name}/overflowed", obj.overflowed)
        elif isinstance(obj, BufferedCsr):
            self.record(f"{name}/total", obj.offsets[-1])
            self.record(f"{name}/attempts", obj.attempts)
            self.record(f"{name}/overflowed", obj.overflowed)
        elif isinstance(obj, ShardedCsr):
            self.record(f"{name}/total", obj.total)       # per-shard column
            self.record(f"{name}/overflowed", obj.overflowed)
        elif isinstance(obj, GridAutoInfo):
            self.record(f"{name}/attempts", obj.attempts)
            self.record(f"{name}/capacity", obj.capacity)
            self.record(f"{name}/overflowed", obj.overflowed)
        elif isinstance(obj, HaloExchange):
            self.record(f"{name}/ghost_rows", obj.halo_valid.sum())
            self.record(f"{name}/payload_bytes",
                        obj.halo_pts.numel() * obj.halo_pts.element_size()
                        + obj.halo_gid.numel() * obj.halo_gid.element_size())
            self.record(f"{name}/overflowed", obj.overflow)
        elif isinstance(obj, TraversalStats):
            for key, val in obj.totals().items():
                self.record(f"{name}/{key}", val)
        else:
            self.record(name, obj)

    # --- aggregation --------------------------------------------------------

    def summary(self) -> dict[str, dict[str, float]]:
        """name -> {records, count, sum, min, max, last} over the flattened
        elements of every value recorded under the name. This is where
        device tensors are fetched to the host."""
        out: dict[str, dict[str, float]] = {}
        for name, values in self._series.items():
            flat = np.concatenate([_host(v) for v in values])
            out[name] = {
                "records": len(values),
                "count": int(flat.size),
                "sum": float(flat.sum()),
                "min": float(flat.min()),
                "max": float(flat.max()),
                "last": float(flat[-1]),
            }
        return out

    def to_json(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2, sort_keys=True)
        return path
