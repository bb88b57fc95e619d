"""Moving least squares interpolation; port of
``repro/core/interpolate.py``: for each target, its k nearest sources (the
KNN epilogue of the nearest kernel on the card) weighted by the Wendland C2
function on a radius of 1.1 times the k-th distance, and a local degree-1
polynomial fitted by weighted least squares, one batched float32
``torch.linalg.solve`` of the (d+1)×(d+1) systems (the reference solves
them outside any Pallas kernel too). Linear fields are reproduced exactly.
"""
from __future__ import annotations

import torch

from repro_torch.core.bvh import build_bvh
from repro_torch.core.geometry import scene_bounds
from repro_torch.core.query import nearest, query
from repro_torch.device import as_tensor_on, resolve_device

__all__ = ["mls_interpolate", "wendland_c2"]


def wendland_c2(r: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    t = torch.clamp(r / torch.clamp(radius, min=1e-12), 0.0, 1.0)
    return (1.0 - t) ** 4 * (4.0 * t + 1.0)


def mls_interpolate(source_points, source_values, targets, k: int = 8, *,
                    device=None) -> torch.Tensor:
    """Scalar ``source_values`` (n,) at ``source_points`` (n, d)
    interpolated onto ``targets`` (q, d); (q,) float32 on ``device``
    (``None``: the CUDA card; raises without one). The Gram matrices are
    sums of products, not a matrix product, so no TF32 setting touches
    them."""
    dev = resolve_device(device)
    src = as_tensor_on(source_points, torch.float32, dev)
    vals = as_tensor_on(source_values, torch.float32, dev)
    tgt = as_tensor_on(targets, torch.float32, dev)
    n, d = src.shape
    assert k <= n, (k, n)
    bvh = build_bvh(src, *scene_bounds(src))
    # Morton thread order: it changes no result.
    nn = query(bvh, nearest(tgt, k), sort_queries=True)
    idx = nn.indices.long()
    radius = 1.1 * nn.distances.amax(1, keepdim=True) + 1e-12
    w = wendland_c2(nn.distances, radius)                        # (q, k)
    # Degree-1 basis centred at the target (conditioning).
    basis = torch.cat([torch.ones_like(w)[..., None], src[idx] - tgt[:, None]],
                      2)                                         # (q, k, d+1)
    a = basis * w[..., None]
    gram = (a[..., :, None] * basis[..., None, :]).sum(1) \
        + 1e-8 * torch.eye(d + 1, dtype=torch.float32, device=dev)
    rhs = (a * vals[idx][..., None]).sum(1)
    return torch.linalg.solve(gram, rhs)[:, 0]
