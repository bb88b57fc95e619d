"""Op-level cost counter: FLOPs and an HBM-traffic proxy of what one step
actually dispatches; the port's counterpart of ``repro/launch/hlo_cost.py``.

The reference parses XLA's post-SPMD HLO and multiplies loop bodies by
their trip counts. The port has no HLO: a ``TorchDispatchMode`` sees every
ATen op the step runs (on ``meta`` tensors for a plan at any size, or on
the card around a real step), and the port's scans are Python loops, so
every iteration is dispatched and counted.

  flops    — the formulas of ``torch.utils.flop_counter`` (``mm``,
             ``bmm``, ``addmm``, ``baddbmm``, ``_scaled_dot_product_*``,
             ``convolution``): 2 * prod(out) * contraction, the dot FLOPs
             the reference's walker counts
  traffic  — op output bytes x2 (read + write amortized), skipping views,
             no-op aliases and a backend's scratch outputs: the analogue
             of the reference's ``hlo_traffic_bytes``
  top      — the top-k ops by FLOPs and by traffic, keyed by op and
             output shape

The counts are of the whole step on the devices it runs on; the dry run
divides them by the mesh's chip count.
"""
from __future__ import annotations

from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# Ops that move no data: their outputs alias an input or are fresh,
# unwritten buffers.
NO_TRAFFIC = frozenset({"_unsafe_view", "alias", "detach", "empty",
                        "empty_like", "empty_strided", "new_empty",
                        "new_empty_strided"})
# Not counted at all: ``torch.tensor(c)`` wraps its constant in a
# ``lift_fresh`` where the constant holds data, and not on ``meta``.
UNCOUNTED = frozenset({"lift_fresh"})
# Ops whose trailing outputs are a backend's scratch, not data: the number
# of leading outputs counted. ``log_sigmoid_forward``'s buffer is full-size
# on the CPU and on ``meta``, and empty on CUDA.
DATA_OUTPUTS = {"log_sigmoid_forward": 1}


def _out_bytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (tuple, list)):
        return sum(_out_bytes(o) for o in out)
    return 0


def _out_shape(out) -> str:
    if isinstance(out, torch.Tensor):
        return f"{str(out.dtype).removeprefix('torch.')}{list(out.shape)}"
    if isinstance(out, (tuple, list)):
        return "(" + ", ".join(_out_shape(o) for o in out) + ")"
    return ""


class OpCounter(TorchDispatchMode):
    """Counts the FLOPs and traffic of the ops dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.traffic = 0
        self.ops = 0
        # (op, output shape) -> [flops, bytes, calls], every op dispatched
        self.detail: dict = defaultdict(lambda: [0, 0, 0])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        name = packet.__name__
        if name in UNCOUNTED:
            return out
        count = flop_registry.get(packet)
        flops = count(*args, **kwargs, out_val=out) if count is not None else 0
        data = out[:DATA_OUTPUTS[name]] if name in DATA_OUTPUTS else out
        moved = 0 if func.is_view or name in NO_TRAFFIC else 2 * _out_bytes(data)
        self.ops += 1
        self.flops += flops
        self.traffic += moved
        cell = self.detail[(name, _out_shape(data))]
        cell[0] += flops
        cell[1] += moved
        cell[2] += 1
        return out

    def result(self, top_k: int = 0) -> dict:
        out = {"flops": float(self.flops), "traffic": float(self.traffic),
               "ops": self.ops}
        if top_k:
            for key, i in (("top_flops", 0), ("top_traffic", 1)):
                items = sorted(self.detail.items(), key=lambda kv: -kv[1][i])[:top_k]
                out[key] = [{"op": op, "shape": shape, "flops": v[0], "bytes": v[1]}
                            for (op, shape), v in items if v[i]]
        return out


def op_cost(fn, *args, top_k: int = 0, **kwargs) -> dict:
    """``fn(*args, **kwargs)`` run under an ``OpCounter``: ``{"flops",
    "traffic", "ops"}`` and, with ``top_k``, ``top_flops`` and
    ``top_traffic``. The result of ``fn`` is dropped."""
    with OpCounter() as counter:
        fn(*args, **kwargs)
    return counter.result(top_k)
