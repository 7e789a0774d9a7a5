"""Fault tolerance and straggler detection for the training loop
(``repro/runtime/fault.py``).

The recovery contract: all state lives in checkpoints plus the
deterministic data pipeline, and the supervisor restarts the step loop
from the last published checkpoint. A failure-injection hook lets tests
exercise it on the CPU.

Straggler detection: a watchdog keeps a running median of step times over
a window; a step slower than ``threshold x median`` is recorded.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

from repro_torch.checkpoint import checkpointer as ckpt


@dataclasses.dataclass
class StragglerWatchdog:
    threshold: float = 3.0
    window: int = 64
    _times: deque = dataclasses.field(default_factory=deque)
    slow_steps: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self._times = deque(self._times, maxlen=self.window)

    def observe(self, step: int, duration_s: float) -> bool:
        """Record a step; returns True if it was a straggler."""
        med = self.median()
        self._times.append(duration_s)
        if med is not None and duration_s > self.threshold * med:
            self.slow_steps.append((step, duration_s, med))
            return True
        return False

    def median(self):
        if len(self._times) < 8:
            return None
        xs = sorted(self._times)
        return xs[len(xs) // 2]


class FaultInjector:
    """Deterministic failure schedule for tests: fail at given steps once."""

    def __init__(self, fail_at: tuple[int, ...] = ()):
        self.pending = set(fail_at)

    def maybe_fail(self, step: int):
        if step in self.pending:
            self.pending.discard(step)
            raise RuntimeError(f"injected node failure at step {step}")


@dataclasses.dataclass
class SupervisorReport:
    restarts: int = 0
    completed_steps: int = 0
    straggler_events: int = 0


def run_supervised(
    *,
    total_steps: int,
    step_fn: Callable[[int], dict],
    state_provider: Callable[[], object],
    state_restorer: Callable[[object, int], None],
    ckpt_root: str,
    ckpt_every: int = 50,
    keep: int = 3,
    max_restarts: int = 8,
    watchdog: StragglerWatchdog | None = None,
    injector: FaultInjector | None = None,
) -> SupervisorReport:
    """Checkpoint/restart step-loop supervisor.

    ``step_fn(step)`` runs one training step. ``state_provider()`` returns
    the checkpointable tree (for a port ``TrainState``,
    ``bridge.train_state_tree``); ``state_restorer(tree, step)`` installs a
    restored one. A step that raises restarts the loop from the latest
    checkpoint (from step 0 if there is none), up to ``max_restarts``
    times. Steps replayed after a restore count once in
    ``completed_steps``, and the first step after a restore is kept from
    the watchdog: its time is a restart's, not a straggler's.
    """
    manager = ckpt.CheckpointManager(ckpt_root, keep=keep)
    watchdog = watchdog or StragglerWatchdog()
    report = SupervisorReport()

    start = 0
    latest = manager.latest_step()
    if latest is not None:
        tree, step = ckpt.load(ckpt_root, state_provider(), step=latest)
        state_restorer(tree, step)
        start = step

    step = start
    completed: set[int] = set()
    skip_watchdog = latest is not None
    while step < total_steps:
        try:
            if injector is not None:
                injector.maybe_fail(step)
            t0 = time.monotonic()
            step_fn(step)
            if skip_watchdog:
                skip_watchdog = False
            elif watchdog.observe(step, time.monotonic() - t0):
                report.straggler_events += 1
            completed.add(step)
            report.completed_steps = len(completed)
            step += 1
            if step % ckpt_every == 0 or step == total_steps:
                manager.save_sync(step, state_provider())
        except Exception:
            report.restarts += 1
            if report.restarts > max_restarts:
                raise
            skip_watchdog = True
            latest = manager.latest_step()
            if latest is None:
                step = 0  # no checkpoint yet: restart from scratch
                continue
            tree, ckstep = ckpt.load(ckpt_root, state_provider(), step=latest)
            state_restorer(tree, ckstep)
            step = ckstep
    manager.wait()
    return report
