"""Calls that a trace of ATen ops must take whole.

Two kinds of call stand for something a ``TorchDispatchMode`` cannot see
as it is:

* a kernel wrapper (``repro_torch.kernels``): on the card its kernel is a
  ``ctypes`` launch that dispatch never sees, so a trace would see only the
  buffers the wrapper allocates; on the CPU it runs the kernel's plain
  version, whose ops stand for the launch;
* a collective of ``core.mesh.ShardAxis``: torch ops over the shards the
  mesh staged, which stand for a collective over however many shards the
  mesh would have.

While such a call runs, :func:`inside` is true in its thread. When it
returns, each dispatch mode on the current stack that defines
``opaque_result(kind, name, result, info)`` hears of it, once, with the
call's result (kinds: ``"kernel"``, ``"collective"``, ``"axis_index"``).
The scale-safety interpreter (``staticcheck.absint``) skips the ops inside
and gives the result the interval the call's kind warrants, the same on
the card and on the CPU. Without such a mode this costs one check of the
mode stack per call.
"""
from __future__ import annotations

import contextlib
import functools
import threading

from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

__all__ = ["inside", "hidden", "announce", "kernel_call"]

_depth = threading.local()


def inside() -> bool:
    """Whether this thread is inside an opaque call."""
    return getattr(_depth, "n", 0) > 0


@contextlib.contextmanager
def hidden():
    """The block is (part of) an opaque call."""
    n = getattr(_depth, "n", 0)
    _depth.n = n + 1
    try:
        yield
    finally:
        _depth.n = n


def announce(kind: str, name: str, result, **info) -> None:
    """Tell the listening dispatch modes that an opaque call returned
    ``result``; nothing inside another opaque call is announced."""
    if inside():
        return
    for mode in _get_current_dispatch_mode_stack():
        hook = getattr(mode, "opaque_result", None)
        if hook is not None:
            hook(kind, name, result, info)


def kernel_call(fn):
    """Mark ``fn`` as a kernel wrapper: its ops are hidden and its result
    is announced as a kernel's outputs."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        with hidden():
            out = fn(*args, **kwargs)
        announce("kernel", fn.__name__, out)
        return out
    return call
