"""In-situ analysis, the paper's technique inside a loop; port of
``repro/analysis/insitu.py``. Every ``cadence`` steps, on the card:

* training mode: FDBSCAN over sampled token-embedding rows (collapse of
  representations; the clusters counted through ``halo_catalog``) and
  over MoE router columns (expert collapse), each after a random
  projection to 3-D;
* simulation mode: particle phase space -> FDBSCAN -> ``halo_catalog``
  summary, the HACC in-situ step.

Each analysis runs under the reference's spans when a tracer is given.

Random draws: the reference samples rows and projections with
``jax.random``, whose bits torch cannot reproduce. So each training-mode
statistic is a draw (``sample_embedding_draws``, ``router_projection``:
a ``torch.Generator`` on the device seeded from ``step``, or ``step + 7``
for routers) and a pure part that takes the sampled rows (or router
columns) and the projection matrix (``embedding_stats_from``,
``router_stats_from``); the tests feed the pure parts the reference's
own draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.core.dbscan import fdbscan
from repro_torch.data.pipeline import hacc_benchmark_epsilon
from repro_torch.device import as_tensor_on, resolve_device
from repro_torch.halos.catalog import halo_catalog
from repro_torch.obs.trace import traced
from repro_torch.tree import keystr, leaves_with_path

__all__ = ["InsituConfig", "sample_embedding_draws", "embedding_stats_from",
           "embedding_cluster_stats", "router_columns", "router_projection",
           "router_stats_from", "router_cluster_stats",
           "simulation_halo_stats", "InsituAnalyzer"]


@dataclasses.dataclass(frozen=True)
class InsituConfig:
    cadence: int = 10              # analysis every K steps
    sample_rows: int = 512         # embedding rows sampled per analysis
    eps_quantile: float = 0.01     # ε from the pairwise-distance quantile
    min_pts: int = 2               # FOF
    project_dim: int = 3           # random projection for the geometric core
    halo_capacity: int = 256       # catalog slots for simulation halo stats
    halo_min_count: int = 10       # HACC-style small-halo mass cut
    mode: str = "training"         # "training" (embed/router) | "simulation"

    def __post_init__(self):
        if self.mode not in ("training", "simulation"):
            raise ValueError(f"unknown insitu mode {self.mode!r}")


def _generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _projection(gen: torch.Generator, dim_in: int, d: int,
                device: torch.device) -> torch.Tensor:
    return torch.randn((dim_in, d), generator=gen, dtype=torch.float32,
                       device=device) / math.sqrt(dim_in)


def _project(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Random projection (``r``: (D, d), normal over sqrt(D)) to the
    low-dim space the geometric core indexes, scaled into the unit box
    (Johnson-Lindenstrauss: cluster structure survives)."""
    y = x.float() @ r
    lo = y.amin(dim=0)
    span = torch.clamp(y.amax(dim=0) - lo, min=1e-6)
    return (y - lo) / span


def _quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(x, q)`` of a 1-D float32 tensor by its default
    method, linear interpolation between the order statistics around
    ``q (n - 1)``, with the reference's float32 arithmetic for the
    position and weights (computed on the host: they depend on ``n``
    only). From a sort, so it has no size limit (``torch.quantile``
    refuses more than 2^24 elements, ROADMAP C12); a NaN anywhere gives
    NaN, as the reference's does."""
    n = x.shape[0]
    f32 = np.float32
    pos = f32(q) * (f32(n) - f32(1))
    lo, hi = np.floor(pos), np.ceil(pos)
    w_hi = pos - lo
    w_lo = f32(1) - w_hi
    lo, hi = (int(np.clip(i, 0, n - 1)) for i in (lo, hi))
    xs = torch.sort(x).values
    out = xs[lo] * float(w_lo) + xs[hi] * float(w_hi)
    return torch.where(torch.isnan(x).any(), torch.nan, out)


def _eps_from_quantile(pts: torch.Tensor, q: float) -> torch.Tensor:
    d2 = torch.sum((pts[:, None] - pts[None]) ** 2, dim=-1)
    n = pts.shape[0]
    iu = torch.triu_indices(n, n, 1, device=pts.device)
    return torch.sqrt(_quantile(d2[iu[0], iu[1]], q))


def sample_embedding_draws(table: torch.Tensor, cfg: InsituConfig, step: int):
    """The draws of one embedding analysis: ``cfg.sample_rows`` distinct
    rows of ``table`` and the (D, project_dim) projection, from one
    generator on the table's device seeded with ``step``."""
    gen = _generator(step, table.device)
    n = min(cfg.sample_rows, table.shape[0])
    idx = torch.randperm(table.shape[0], generator=gen, device=table.device)[:n]
    r = _projection(gen, table.shape[1], cfg.project_dim, table.device)
    return table[idx], r


def embedding_stats_from(rows: torch.Tensor, r: torch.Tensor,
                         cfg: InsituConfig) -> dict[str, torch.Tensor]:
    """Cluster the sampled rows after projecting them with ``r``; many
    clustered rows => collapsing representations. The cluster accounting
    goes through the catalog: ``embed_num_clusters`` counts clusters that
    keep >= min_pts members after border assignment."""
    dev = rows.device
    pts = _project(rows, r)
    eps = _eps_from_quantile(pts, cfg.eps_quantile)
    res = fdbscan(pts, eps, cfg.min_pts, device=dev)
    n = res.labels.shape[0]
    cat = halo_catalog(pts, torch.zeros_like(pts), res.labels, capacity=n,
                       min_count=cfg.min_pts, device=dev)
    return {
        "insitu/embed_eps": eps,
        "insitu/embed_clustered_frac": (res.labels >= 0).sum() / n,
        "insitu/embed_num_clusters": cat.num_halos,
        "insitu/embed_largest_cluster": cat.count.max(),
        "insitu/embed_union_rounds": res.num_rounds,
    }


def embedding_cluster_stats(params: dict, cfg: InsituConfig, step: int, *,
                            device=None) -> dict[str, torch.Tensor]:
    """Cluster sampled embedding rows of ``params["embed"]`` on ``device``
    (``None``: the CUDA card; raises without one)."""
    dev = resolve_device(device)
    rows, r = sample_embedding_draws(params["embed"].to(dev), cfg, step)
    return embedding_stats_from(rows, r, cfg)


def router_columns(params: dict) -> torch.Tensor | None:
    """Every router leaf's columns, (E*, D) f32, the leaves in the
    reference's order (sorted keys) and a leading group axis averaged
    away; None without a router."""
    routers = []
    for path, w in leaves_with_path(params):
        if "router" in keystr(path):
            if w.ndim == 3:      # group-stacked (G, D, E): mean over G
                w = w.mean(dim=0)
            routers.append(w.T.float())
    return torch.cat(routers) if routers else None


def router_projection(cols: torch.Tensor, cfg: InsituConfig, step: int) -> torch.Tensor:
    """The router analysis's projection, seeded with ``step + 7``."""
    return _projection(_generator(step + 7, cols.device), cols.shape[1],
                       cfg.project_dim, cols.device)


def router_stats_from(cols: torch.Tensor, r: torch.Tensor) -> dict[str, torch.Tensor]:
    """Cluster the projected router columns: experts whose columns land in
    one ε-cluster are redundant (expert collapse)."""
    pts = _project(cols, r)
    eps = _eps_from_quantile(pts, 0.05)
    res = fdbscan(pts, eps, 2, device=cols.device)
    return {
        "insitu/router_eps": eps,
        "insitu/router_collapsed_experts": (res.labels >= 0).sum(),
    }


def router_cluster_stats(params: dict, cfg: InsituConfig, step: int, *,
                         device=None) -> dict[str, torch.Tensor]:
    """Router-collapse stats on ``device``; ``{}`` for a model without
    routers."""
    dev = resolve_device(device)
    cols = router_columns(params)
    if cols is None:
        return {}
    cols = cols.to(dev)
    return router_stats_from(cols, router_projection(cols, cfg, step))


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
    """Runs at the configured cadence and keeps the host-side history, as
    the reference's analyzer does. Training mode reads ``params``, the
    model's parameter tree (``embed`` and any router leaves); simulation
    mode reads ``positions``, ``velocities`` and optionally ``eps``
    (default: the paper's linking length for a unit box).

    ``tracer`` (a ``repro_torch.obs.SpanTracer``) puts each analysis
    under an ``insitu`` span (args ``step``, ``mode``) with the fenced
    children of the reference: ``insitu/embed_stats`` and
    ``insitu/router_stats``, or ``insitu/halo_stats``; then
    ``insitu/host_readback``."""

    def __init__(self, cfg: InsituConfig, tracer=None, *, device=None):
        self.cfg = cfg
        self.tracer = tracer
        self.device = resolve_device(device)
        self.history: list[tuple[int, dict]] = []

    def _analyze(self, params: dict, step: int) -> dict[str, torch.Tensor]:
        if self.cfg.mode == "simulation":
            n = int(params["positions"].shape[0])
            eps = params.get("eps", hacc_benchmark_epsilon(1.0, n))
            return dict(traced(self.tracer, "insitu/halo_stats",
                               simulation_halo_stats, params["positions"],
                               params["velocities"], self.cfg, eps, step,
                               device=self.device))
        stats = dict(traced(self.tracer, "insitu/embed_stats",
                            embedding_cluster_stats, params, self.cfg, step,
                            device=self.device))
        stats.update(traced(self.tracer, "insitu/router_stats",
                            router_cluster_stats, params, self.cfg, step,
                            device=self.device))
        return stats

    def maybe_run(self, params: dict, step: int) -> dict[str, Any]:
        if step % self.cfg.cadence != 0:
            return {}

        def readback(stats):
            return {k: float(v) for k, v in stats.items()}

        if self.tracer is None:
            host = readback(self._analyze(params, step))
        else:
            with self.tracer.span("insitu", step=step, mode=self.cfg.mode):
                stats = self._analyze(params, step)
                host = traced(self.tracer, "insitu/host_readback", readback,
                              stats)
        self.history.append((step, host))
        return host
