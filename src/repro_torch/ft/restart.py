"""Fault-tolerant training loop: checkpoint/restart with bit-exact
resume.

Because the data pipeline is stateless (batch = f(seed, step)), the
checkpoint needs only (params, opt_state) and the step counter; a
restarted run replays from the last complete step and produces the same
trajectory as an uninterrupted run (asserted by tests).

Port of ``repro/ft/restart.py`` with its imports rewritten. The port's
train step (``train/step.py``) updates the state it is given in place,
and the store copies it to the host before each save returns.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.ft.straggler import StragglerMonitor


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 50
    async_ckpt: bool = True
    log_every: int = 10


class TrainLoop:
    """Drives train_step with periodic checkpoints; resumable."""

    def __init__(self, step_fn: Callable, batch_fn: Callable,
                 store: CheckpointStore, cfg: LoopConfig,
                 monitor: StragglerMonitor | None = None):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.store = store
        self.cfg = cfg
        self.monitor = monitor or StragglerMonitor()
        self.history: list[dict] = []

    def run(self, params, opt_state, start_step: int = 0,
            fail_at: int | None = None):
        """Run to total_steps. ``fail_at`` injects a crash (tests)."""
        step = start_step
        while step < self.cfg.total_steps:
            if fail_at is not None and step == fail_at:
                self.store.wait()
                raise RuntimeError(f"injected failure at step {step}")
            t0 = time.perf_counter()
            batch = self.batch_fn(step)
            params, opt_state, metrics = self.step_fn(
                params, opt_state, batch)
            self.monitor.record(rank=0, step=step,
                                seconds=time.perf_counter() - t0)
            step += 1
            if step % self.cfg.log_every == 0 or \
                    step == self.cfg.total_steps:
                self.history.append(
                    {"step": step,
                     **{k: float(v) for k, v in metrics.items()}})
            if step % self.cfg.ckpt_every == 0 or \
                    step == self.cfg.total_steps:
                self.store.save(
                    step, {"params": params, "opt": opt_state},
                    blocking=not self.cfg.async_ckpt)
        self.store.wait()
        return params, opt_state

    def resume(self, params_like, opt_like, fail_at: int | None = None):
        """Restore the latest checkpoint and continue."""
        step, state = self.store.restore(
            {"params": params_like, "opt": opt_like})
        return self.run(state["params"], state["opt"],
                        start_step=step, fail_at=fail_at)
