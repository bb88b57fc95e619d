"""In-situ halo finding; port of ``repro/analysis/insitu.py`` in
simulation mode: every ``cadence`` steps, particle phase space goes in and
a halo-catalog summary comes out, FDBSCAN then ``halo_catalog``, on the
card, under the reference's spans when a tracer is given. Training mode is
not ported yet."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.dbscan import fdbscan
from repro_torch.data.pipeline import hacc_benchmark_epsilon
from repro_torch.device import as_tensor_on, resolve_device
from repro_torch.halos.catalog import halo_catalog
from repro_torch.obs.trace import traced

__all__ = ["InsituConfig", "simulation_halo_stats", "InsituAnalyzer"]


@dataclasses.dataclass(frozen=True)
class InsituConfig:
    """The reference's configuration for simulation mode, the only mode
    that runs; training mode's fields come with its port."""
    cadence: int = 10
    min_pts: int = 2
    halo_capacity: int = 256
    halo_min_count: int = 10
    mode: str = "training"

    def __post_init__(self):
        if self.mode not in ("training", "simulation"):
            raise ValueError(f"unknown insitu mode {self.mode!r}")


def simulation_halo_stats(positions, velocities, cfg: InsituConfig, eps,
                          step: int = 0, *, device=None) -> dict[str, torch.Tensor]:
    """Particle phase space -> halo catalog summary, on ``device``
    (``None``: the CUDA card; raises without one)."""
    dev = resolve_device(device)
    positions = as_tensor_on(positions, torch.float32, dev)
    velocities = as_tensor_on(velocities, torch.float32, dev)
    res = fdbscan(positions, eps, cfg.min_pts, device=dev)
    cat = halo_catalog(positions, velocities, res.labels,
                       capacity=cfg.halo_capacity,
                       min_count=cfg.halo_min_count, device=dev)
    valid = cat.count > 0
    nh = torch.clamp(cat.num_halos, min=1)
    return {
        "insitu/halo_num": cat.num_halos,
        "insitu/halo_overflow": cat.overflow.to(torch.int32),
        "insitu/halo_largest": cat.count.max(),
        "insitu/halo_mass_frac": cat.count.sum() / positions.shape[0],
        "insitu/halo_vdisp_mean": torch.where(valid, cat.vdisp, 0.0).sum() / nh,
        "insitu/halo_rmax_max": cat.rmax.max(),
        "insitu/halo_union_rounds": res.num_rounds,
    }


class InsituAnalyzer:
    """Runs the halo-stats step at the configured cadence and keeps the
    host-side history, as the reference's analyzer does in simulation
    mode. ``params`` holds ``positions``, ``velocities`` and optionally
    ``eps`` (default: the paper's linking length for a unit box).

    ``tracer`` (a ``repro_torch.obs.SpanTracer``) puts each analysis under
    an ``insitu`` span (args ``step``, ``mode``) with the fenced children
    ``insitu/halo_stats`` and ``insitu/host_readback``, the reference's
    spans."""

    def __init__(self, cfg: InsituConfig, tracer=None, *, device=None):
        if cfg.mode != "simulation":
            raise NotImplementedError(
                "training mode (embedding and router clustering) is not "
                "ported yet (ROADMAP A14)")
        self.cfg = cfg
        self.tracer = tracer
        self.device = resolve_device(device)
        self.history: list[tuple[int, dict]] = []

    def maybe_run(self, params: dict, step: int) -> dict[str, Any]:
        if step % self.cfg.cadence != 0:
            return {}
        n = int(params["positions"].shape[0])
        eps = params.get("eps", hacc_benchmark_epsilon(1.0, n))

        def analyze():
            return traced(self.tracer, "insitu/halo_stats",
                          simulation_halo_stats, params["positions"],
                          params["velocities"], self.cfg, eps, step,
                          device=self.device)

        def readback(stats):
            return {k: float(v) for k, v in stats.items()}

        if self.tracer is None:
            host = readback(analyze())
        else:
            with self.tracer.span("insitu", step=step, mode=self.cfg.mode):
                stats = analyze()
                host = traced(self.tracer, "insitu/host_readback", readback,
                              stats)
        self.history.append((step, host))
        return host
