"""Fault-tolerant training runtime; port of ``repro/runtime/supervisor.py``.

The supervisor owns the train loop: periodic async checkpoints, automatic
restart from the last committed step after a failure, straggler detection,
and an injectable fault hook used by the tests (the moral equivalent of
pulling a node). A step's time runs from its start to the end of its
device work (a synchronize of the metrics' device, the counterpart of
``jax.block_until_ready``).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable

import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.tree import leaves

log = logging.getLogger("repro_torch.supervisor")


@dataclasses.dataclass
class SupervisorConfig:
    total_steps: int
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
    max_restarts: int = 10
    # straggler watchdog: flag steps slower than ewma * threshold
    straggler_threshold: float = 2.5
    ewma_alpha: float = 0.1


@dataclasses.dataclass
class StepStats:
    step: int
    seconds: float
    is_straggler: bool
    metrics: dict


class StragglerWatchdog:
    """Per-step wall-clock EWMA; flags outliers (the single-process analogue
    of cross-host slow-rank detection)."""

    def __init__(self, threshold: float, alpha: float):
        self.threshold = threshold
        self.alpha = alpha
        self.ewma: float | None = None
        self.flagged: list[int] = []

    def observe(self, step: int, seconds: float) -> bool:
        if self.ewma is None:
            self.ewma = seconds
            return False
        is_slow = seconds > self.threshold * self.ewma
        if is_slow:
            self.flagged.append(step)
            log.warning("straggler step %d: %.3fs vs ewma %.3fs",
                        step, seconds, self.ewma)
        # slow steps don't poison the baseline
        if not is_slow:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * seconds
        return is_slow


def _block_until_ready(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


class Supervisor:
    def __init__(self, cfg: SupervisorConfig, store: CheckpointStore):
        self.cfg = cfg
        self.store = store
        self.stats: list[StepStats] = []
        self.restarts = 0

    def run(self, *, init_state_fn: Callable[[], Any],
            step_fn: Callable[[Any, int], tuple[Any, dict]],
            fault_hook: Callable[[int], None] | None = None) -> Any:
        """Run to total_steps with restart-on-failure.

        init_state_fn: builds fresh state (step 0).
        step_fn(state, step) -> (state, metrics) — one optimizer step.
        fault_hook(step): test hook; may raise to simulate a node failure.
        """
        watchdog = StragglerWatchdog(self.cfg.straggler_threshold,
                                     self.cfg.ewma_alpha)
        while True:
            try:
                state, start = self._restore_or_init(init_state_fn)
                for step in range(start, self.cfg.total_steps):
                    t0 = time.time()
                    if fault_hook is not None:
                        fault_hook(step)
                    state, metrics = step_fn(state, step)
                    _block_until_ready(leaves(metrics)[0])
                    dt = time.time() - t0
                    slow = watchdog.observe(step, dt)
                    self.stats.append(StepStats(step, dt, slow, {
                        k: float(v) for k, v in metrics.items()}))
                    next_step = step + 1
                    if next_step % self.cfg.checkpoint_every == 0:
                        self.store.save_async(next_step, state)
                        self.store.prune(self.cfg.keep_checkpoints)
                self.store.wait()
                self.store.save(self.cfg.total_steps, state)
                return state
            except KeyboardInterrupt:
                raise
            except Exception as e:  # noqa: BLE001 — restart-on-anything
                self.restarts += 1
                log.error("step failure (%s); restart %d/%d", e,
                          self.restarts, self.cfg.max_restarts)
                self.store.wait()
                if self.restarts > self.cfg.max_restarts:
                    raise

    def _restore_or_init(self, init_state_fn):
        latest = self.store.latest_step()
        if latest is None:
            return init_state_fn(), 0
        # No abstract evaluation in torch: one fresh state is the template
        # (its leaves' devices and dtypes), and the restore fills it.
        state, step = self.store.restore(init_state_fn(), latest)
        log.info("restored step %d", step)
        return state, step
