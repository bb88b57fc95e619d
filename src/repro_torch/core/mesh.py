"""An in-process mesh of shards: the port's counterpart of a one-axis
``jax.sharding.Mesh`` with ``shard_map`` (``repro/core/distributed.py``,
``repro/halos/merge.py``).

The reference is single-controller: one process drives every device of
the mesh, and its shard bodies are straight-line SPMD code that calls
collectives anywhere, inside loops (the ``psum``'d ``changed`` of the
union fixpoint) and inside callbacks (the SO bisection's ``count_fn``). A
lockstep loop over shards cannot run such a body, and NCCL refuses two
ranks on one GPU. So :class:`ShardMesh` runs the body in one thread per
shard, all on one device, and each collective of the handle the body
receives (:class:`ShardAxis`) meets the other shards at a barrier.

The shards take turns: a shard runs while it holds the mesh's baton and
hands it on only while it waits at a collective. So at most one shard
thread runs Python and dispatches torch ops at a time; threads that all
dispatch small torch ops at once lose most of their time handing the
interpreter lock back and forth (four threads of small CPU ops took
twenty times one thread's time, torch 2.13 on an 8-core x86 CPU).

A collective is two barrier phases, deposit then read, so its slots are
free again when it returns. An exception in any shard aborts the barrier:
the other shards raise instead of waiting, and :meth:`ShardMesh.run`
re-raises the first error. A barrier timeout turns a hang (shards that
disagree on the number of collectives) into an error.

A shard runs under the caller's dispatch modes (a ``TorchDispatchMode``
such as the op counter of ``launch/op_cost.py`` or the audits'
``staticcheck.op_audit.OpTrace`` sees every shard's ops), which are
thread-local in torch.

The collectives and the shard index are opaque calls
(``repro_torch.opaque``): a trace of ATen ops sees them whole, so the
scale-safety interpreter reads them at the symbolic size of the axis
(``ShardAxis.index_tensor`` in ``[0, size - 1]``, a ``psum`` scaled by the
shard count) rather than at the number of shards staged.

Every shard runs on the caller's current stream of the device: a tensor a
shard deposits was enqueued before the barrier, and a shard that reads it
enqueues its own work after, so stream order keeps them apart with no
event. The collectives are torch ops in a fixed order (shard 0 first), so
every shard gets the same bits.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from repro_torch import opaque
from repro_torch.device import resolve_device

__all__ = ["ShardMesh", "ShardAxis", "AXIS_NAME"]

# The mesh's one axis, named as the reference names its mesh axis.
AXIS_NAME = "data"


class ShardAxis:
    """The handle a shard body receives in place of the reference's axis
    name: the axis ``name``, this shard's ``index`` (a Python int, and
    ``index_tensor``, the reference's ``axis_index``), the mesh ``size``
    and the collectives the reference calls (``ppermute``, ``psum``,
    ``pmax``, ``all_gather``)."""

    def __init__(self, mesh: "ShardMesh", index: int):
        self._mesh = mesh
        self.name = AXIS_NAME
        self.index = index
        self.size = mesh.n_shards
        self._index_tensor = None

    @property
    def index_tensor(self) -> torch.Tensor:
        """This shard's index as a 0-dim int64 tensor on the mesh's device,
        made once per shard (no host sync): arithmetic on it stays a value
        of the trace, which a Python int folded into a literal would
        not."""
        if self._index_tensor is None:
            with opaque.hidden():
                self._index_tensor = torch.full(
                    (), self.index, dtype=torch.int64, device=self._mesh.device)
            opaque.announce("axis_index", self.name, self._index_tensor,
                            size=self.size)
        return self._index_tensor

    def _exchange(self, value) -> list:
        m = self._mesh
        m._slots[self.index] = value
        m._baton.release()
        try:
            m._barrier.wait()
            out = list(m._slots)
            m._barrier.wait()
        finally:
            m._baton.acquire()
        return out

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        """``jax.lax.ppermute``: shard ``src`` sends ``x`` to ``dst`` for
        each ``(src, dst)`` in ``perm``; a shard no pair sends to receives
        zeros. A received tensor is the sender's own: read it, never write
        it in place (so are the results of the other collectives)."""
        perm = tuple((int(src), int(dst)) for src, dst in perm)
        with opaque.hidden():
            got = self._exchange(x)
            out = next((got[src] for src, dst in perm if dst == self.index),
                       None)
            if out is None:
                out = torch.zeros_like(x)
        return self._announce("ppermute", x, out, perm)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise sum over the shards, shard 0 first."""
        with opaque.hidden():
            got = self._exchange(x)
            out = got[0]
            for v in got[1:]:
                out = out + v
        return self._announce("psum", x, out)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over the shards."""
        with opaque.hidden():
            got = self._exchange(x)
            out = got[0]
            for v in got[1:]:
                out = torch.maximum(out, v)
        return self._announce("pmax", x, out)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard's ``x`` stacked in shard order, (size, ...)."""
        with opaque.hidden():
            out = torch.stack(self._exchange(x))
        return self._announce("all_gather", x, out)

    def _announce(self, prim: str, x, out, perm=()):
        opaque.announce("collective", prim, out, operand=x, axis=self.name,
                        size=self.size, perm=perm)
        return out


class ShardMesh:
    """``n_shards`` shards of one device (``None``: the CUDA card; raises
    without one) along one axis, ``AXIS_NAME``. :meth:`run` calls a body in
    one thread per shard. ``timeout`` (seconds) bounds each wait at a
    collective."""

    def __init__(self, n_shards: int, device=None, *, timeout: float = 600.0):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.n_shards = int(n_shards)
        self.device = resolve_device(device)
        self.timeout = float(timeout)
        self._slots: list = []
        self._barrier: threading.Barrier | None = None
        self._lock = threading.Lock()
        self._baton = threading.Lock()

    def split(self, x: torch.Tensor) -> list[torch.Tensor]:
        """``x`` cut along its first dimension into ``n_shards`` equal
        parts (the reference's ``P(axis, ...)``)."""
        if x.shape[0] % self.n_shards:
            raise ValueError(f"the leading dimension {x.shape[0]} is not "
                             f"divisible by {self.n_shards} shards")
        return list(torch.tensor_split(x, self.n_shards))

    def run(self, body: Callable, *sharded: torch.Tensor) -> list:
        """``body(axis, *parts)`` in every shard at once, ``parts`` this
        shard's slab of each of ``sharded`` (:meth:`split`); returns the
        per-shard results in shard order. One run at a time per mesh."""
        parts = [self.split(x) for x in sharded]
        with self._lock:
            return self._run(body, parts)

    def _run(self, body, parts) -> list:
        n = self.n_shards
        self._slots = [None] * n
        self._barrier = threading.Barrier(n, timeout=self.timeout)
        results, errors = [None] * n, []
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        modes = _get_current_dispatch_mode_stack()

        def shard(k: int) -> None:
            self._baton.acquire()
            try:
                with contextlib.ExitStack() as ctx:
                    if stream is not None:
                        ctx.enter_context(torch.cuda.stream(stream))
                    for mode in modes:
                        ctx.enter_context(mode)
                    results[k] = body(ShardAxis(self, k), *(p[k] for p in parts))
            except BaseException as exc:  # re-raised by the caller below
                errors.append(exc)
                self._barrier.abort()
            finally:
                self._baton.release()

        threads = [threading.Thread(target=shard, args=(k,),
                                    name=f"shard-{k}") for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self._slots = [None] * n
        if errors:
            first = next((e for e in errors
                          if not isinstance(e, threading.BrokenBarrierError)),
                         None)
            if first is None:
                raise RuntimeError(
                    f"a collective waited more than {self.timeout} s: the "
                    "shards did not all reach it") from errors[0]
            raise first
        return results
