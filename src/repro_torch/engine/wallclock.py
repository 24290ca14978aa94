"""Wall-clock evaluation backend: schedules measured on the device.

Per canonical-unique schedule :class:`ExecutorEvaluator`

  1. builds the runner (:func:`repro_torch.core.executor.build_runner`:
     real streams and events on a card);
  2. runs it once after ``reset()`` (which overwrites the buffers the
     ops write) and holds **every** output to the reference outputs
     (relative tolerance :data:`RTOL`),
     computed once from :func:`reference_schedule` — any valid schedule
     must compute the same values, so a sync that failed to order two
     ops shows here. The gate cannot be turned off;
  3. runs ``warmup - 1`` more calls, then times ``repeats`` calls and
     keeps the **median**: ``torch.cuda.synchronize()``, the host clock,
     the run, ``torch.cuda.synchronize()``, the host clock. A schedule
     holds host syncs (CES), so host wall time is the objective, as in
     the paper.

The objective key names the platform (card and compute capability, or
``cpu``), so times from different hardware never mix.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.dag import BoundOp, Graph, OpKind, Schedule
from repro_torch.core.executor import OpImpl, build_runner
from repro_torch.device import platform_string, resolve_device
from repro_torch.engine.base import EvaluatorBase

# Every output of every schedule must match the reference schedule's to
# this relative tolerance; the same kernels on the same inputs give the
# same bits, so any divergence is a sync that failed to order two ops.
RTOL = 1e-5


def reference_schedule(graph: Graph) -> Schedule:
    """A canonical valid schedule: topological order, all on stream 0."""
    return Schedule(tuple(
        BoundOp(n, 0 if graph.ops[n].kind is OpKind.GPU else None)
        for n in graph.topological_order()))


def _host(v) -> np.ndarray:
    """A host copy (a tensor's buffer may be overwritten by later runs)."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32, copy=True).numpy()
    return np.asarray(v)


def _as_output_map(out) -> dict[str, np.ndarray]:
    """Normalize outputs (mapping / sequence / single array or tensor,
    on any device) to named host arrays for comparison."""
    if isinstance(out, Mapping):
        return {str(k): _host(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return {f"out{i}": _host(v) for i, v in enumerate(out)}
    return {"out": _host(out)}


def assert_outputs_close(got, ref, *, rtol: float, atol: float = 0.0,
                         context: str = "") -> None:
    """The value-correctness gate: every reference output must be
    reproduced within tolerance; ``context`` names the failing
    candidate in the assertion message."""
    ref_map = _as_output_map(ref)
    got_map = _as_output_map(got)
    missing = sorted(set(ref_map) - set(got_map))
    if missing:
        raise AssertionError(
            f"candidate is missing reference output(s) {missing}"
            f"{context}")
    for k, r in ref_map.items():
        np.testing.assert_allclose(
            got_map[k], r, rtol=rtol, atol=atol,
            err_msg=f"output {k!r} diverged{context}")


def tensor_outputs(env: Mapping, inputs: Mapping) -> dict[str, np.ndarray]:
    """Host copies of the tensors a run added to its environment."""
    return {k: _host(v) for k, v in env.items()
            if k not in inputs and isinstance(v, torch.Tensor)}


class ExecutorEvaluator(EvaluatorBase):
    """Evaluation backend measuring schedules on real streams.

    ``impls`` maps op names to :func:`repro_torch.core.executor.op_impl`
    implementations, ``env`` is the initial environment, and ``reset``
    overwrites every buffer the ops write (with NaN, say) before each
    gated run, so a run that reads before a write cannot pass on an
    earlier run's values. Ops without an impl (start/end) are skipped
    by the runner. ``graph`` may be a schedule space; ``base_kwargs``
    (``store=``, ``store_path=``) go to :class:`EvaluatorBase`.
    """

    backend = "torch_wallclock"

    def __init__(self, graph: Graph, *, impls: Mapping[str, OpImpl],
                 env: Mapping, reset: Callable[[], None],
                 repeats: int = 5, warmup: int = 1,
                 device: "str | torch.device | None" = None,
                 **base_kwargs):
        super().__init__(graph, **base_kwargs)
        self.device = resolve_device(device)
        self.platform = platform_string(self.device)
        self.impls = dict(impls)
        self.env = dict(env)
        self.reset = reset
        self.repeats = max(1, repeats)
        self.warmup = max(1, warmup)
        self.n_checked = 0
        self._reference: dict | None = None

    def objective_key(self) -> str:
        """What the measurements estimate, and on what hardware."""
        return (f"{self.backend}:{self.platform}:repeats={self.repeats}"
                f":warmup={self.warmup}")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _gated_run(self, run: Callable[[dict], dict]) -> dict:
        self.reset()
        self._sync()
        env = run(self.env)
        self._sync()
        return tensor_outputs(env, self.env)

    def reference_outputs(self) -> dict[str, np.ndarray]:
        """Outputs of :func:`reference_schedule` (computed once)."""
        if self._reference is None:
            self._reference = self._gated_run(build_runner(
                self.graph, reference_schedule(self.graph), self.impls,
                self.device))
        return self._reference

    def check(self, run: Callable[[dict], dict], what: str) -> None:
        """Raise ``AssertionError`` unless ``run`` reproduces the
        reference outputs."""
        ref = self.reference_outputs()
        got = self._gated_run(run)
        assert_outputs_close(
            {k: got[k] for k in ref if k in got}, ref, rtol=RTOL,
            context=f" under {what} — a sync failed to order two ops")
        self.n_checked += 1

    def timed(self, run: Callable[[dict], dict]) -> float:
        """Host seconds of one call of ``run``, the device drained on
        both sides."""
        self._sync()
        t0 = time.perf_counter()
        run(self.env)
        self._sync()
        return time.perf_counter() - t0

    def measure(self, run: Callable[[dict], dict]) -> list[float]:
        """Seconds of each of ``repeats`` timed calls of ``run``, after
        ``warmup - 1`` untimed ones (the gated run is the first)."""
        for _ in range(self.warmup - 1):
            self.timed(run)
        return [self.timed(run) for _ in range(self.repeats)]

    def _measure_batch(self, schedules: Sequence[Schedule]) -> list[float]:
        out: list[float] = []
        for sched in schedules:
            run = build_runner(self.graph, sched, self.impls, self.device)
            self.check(run, f"schedule {[str(i) for i in sched.items]}")
            out.append(statistics.median(self.measure(run)))
        return out
