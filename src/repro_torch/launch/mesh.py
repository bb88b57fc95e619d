"""Production and host meshes; port of ``repro/launch/mesh.py``. Functions,
not module-level constants, so that importing touches no device.

The production meshes are abstract: the sharding rules and the dry run
read only their axis sizes, and one process cannot make a ``DeviceMesh``
of 256 ranks. The host mesh is a real ``DeviceMesh`` of this process's
one rank, on a process group set up from an in-process store (no
network).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Named axis sizes of a mesh that exists only on paper."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """One pod: 16x16 = 256 H100s ("data", "model"); multi-pod adds a
    leading "pod" axis (2 pods = 512 H100s). "pod" composes with "data"
    for DP/FSDP."""
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


def make_host_mesh(device=None):
    """A ``DeviceMesh`` of shape (1, n) over ("data", "model") of this
    process's n = 1 rank: on the card (``None``) over NCCL, with
    ``device="cpu"`` over gloo. The default process group is set up here
    from a ``HashStore`` if there is none; the caller ends it with
    ``torch.distributed.destroy_process_group()``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(torch.cuda.current_device() if dev.index is None
                                  else dev.index)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, "
                           f"not {backend} for {dev.type}")
    n = dist.get_world_size()
    return DeviceMesh(dev.type, torch.arange(n).reshape(1, n),
                      mesh_dim_names=("data", "model"))
