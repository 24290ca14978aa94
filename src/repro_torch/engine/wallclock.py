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
  3. runs ``warmup - 1`` more calls, then takes ``repeats`` samples and
     keeps their **median**. With ``t_measure_s=None`` (the default) a
     sample is one call between two drains of the device:
     ``torch.cuda.synchronize()``, the host clock, the run,
     ``torch.cuda.synchronize()``, the host clock. With a float, a
     sample is the paper's §III-C3 measurement
     (:func:`repro_torch.core.bench.measure_cuda`): the program run back
     to back for ``t_measure_s`` seconds, elapsed / runs. A schedule
     holds host syncs (CES), so host wall time is the objective, as in
     the paper.

With ``cuda_graph=True`` step 1 is :func:`repro_torch.core.executor.
jit_runner` instead, called once (it warms up, captures the schedule
into one CUDA graph and replays it), and every later call, the gated run
included, is a replay of that graph: the JAX package's objective, which
times ``jax.jit(build_runner(...))``. The captures of one evaluator
share one memory pool, and each schedule's graph is released once the
next one is captured (a pool lives while a graph captured into it
does). Its objective key holds ``:graph``, so stores of the two
objectives never mix.

With a telemetry registry current (:mod:`repro_torch.obs`), each
schedule's phases are spans under ``engine.measure``: ``executor.
capture`` (its graph runner's first call) and ``executor.release`` (the
previous schedule's graph let go), ``engine.gate`` (:meth:`~
ExecutorEvaluator.check`, with ``engine.reference`` inside it where the
reference outputs are computed) and ``engine.timing`` (:meth:`~
ExecutorEvaluator.measure`), each with the schedule's ``design`` (a
digest of its cache key); the counter ``engine.gate_bytes`` adds up the
bytes each gated run copies to the host.

The objective key names the platform (card and compute capability, or
``cpu``), the protocol and the kernels' build
(:func:`repro_torch.kernels.build.source_hash`), so times from
different hardware or from an earlier build of the kernels never mix.
Distinct impl/env sets on the same graph must be told apart with
``store_tag=``; an SpMV program's is
``repro_torch.spmv.distributed.DistributedSpmv.store_tag``, which names
the matrix it multiplies.
"""
from __future__ import annotations

import hashlib
import statistics
import time
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.bench import measure_cuda
from repro_torch.core.dag import BoundOp, Graph, OpKind, Schedule
from repro_torch.core.executor import (OpImpl, build_runner, host_wait,
                                       jit_runner, op_impl)
from repro_torch.device import platform_string, resolve_device
from repro_torch.engine.base import EvaluatorBase
from repro_torch.kernels.build import source_hash

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
    (``store=``, ``store_path=``, ``store_tag=``) go to
    :class:`EvaluatorBase`. The graph alone does not say what the impls
    compute, so an evaluator that shares a store with another program
    passes a ``store_tag`` that names its own. ``cuda_graph=True``
    measures replays of each schedule's CUDA graph (the module's
    docstring).
    """

    backend = "torch_wallclock"

    def __init__(self, graph: Graph, *, impls: Mapping[str, OpImpl],
                 env: Mapping, reset: Callable[[], None],
                 repeats: int = 5, warmup: int = 1,
                 t_measure_s: float | None = None,
                 device: "str | torch.device | None" = None,
                 cuda_graph: bool = False,
                 **base_kwargs):
        super().__init__(graph, **base_kwargs)
        self.device = resolve_device(device)
        self.platform = platform_string(self.device)
        self.impls = dict(impls)
        self.env = dict(env)
        self.reset = reset
        self.repeats = max(1, repeats)
        self.warmup = max(1, warmup)
        if t_measure_s is not None and not t_measure_s >= 0:
            raise ValueError(f"t_measure_s must be >= 0, got {t_measure_s}")
        self.t_measure_s = t_measure_s
        self.cuda_graph = cuda_graph
        self._pool = None
        self._held = None  # the last schedule's graph runner
        self.n_checked = 0
        self._reference: dict | None = None

    def objective_key(self) -> str:
        """What the measurements estimate, on what hardware, under which
        protocol, with which build of the kernels."""
        protocol = ("" if self.t_measure_s is None
                    else f":t_measure={self.t_measure_s}")
        graph = ":graph" if self.cuda_graph else ""
        return (f"{self.backend}:{self.platform}:repeats={self.repeats}"
                f":warmup={self.warmup}{protocol}{graph}"
                f":build={source_hash()}")

    def close(self) -> None:
        """Release the last schedule's graph, then close the store."""
        if self._held is not None:
            self._held.release()
            self._held = None
        super().close()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _gated_run(self, run: Callable[[dict], dict]) -> dict:
        self.reset()
        self._sync()
        env = run(self.env)
        self._sync()
        out = tensor_outputs(env, self.env)
        obs.counter("engine.gate_bytes").add(
            sum(a.nbytes for a in out.values()))
        return out

    def reference_outputs(self) -> dict[str, np.ndarray]:
        """Outputs of :func:`reference_schedule` (computed once)."""
        if self._reference is None:
            with obs.span("engine.reference"):
                self._reference = self._gated_run(build_runner(
                    self.graph, reference_schedule(self.graph), self.impls,
                    self.device))
        return self._reference

    def check(self, run: Callable[[dict], dict], what: str,
              **attrs) -> None:
        """Raise ``AssertionError`` unless ``run`` reproduces the
        reference outputs (the span ``engine.gate``, with ``attrs``)."""
        with obs.span("engine.gate", **attrs):
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

    def measure(self, run: Callable[[dict], dict],
                **attrs) -> list[float]:
        """Seconds of each of ``repeats`` samples of ``run`` under the
        protocol, after ``warmup - 1`` untimed calls (the gated run is
        the first): the span ``engine.timing``, with ``attrs``."""
        with obs.span("engine.timing", **attrs):
            for _ in range(self.warmup - 1):
                self.timed(run)
            if self.t_measure_s is None:
                return [self.timed(run) for _ in range(self.repeats)]
            return [measure_cuda(lambda: run(self.env), self.device,
                                 self.t_measure_s)
                    for _ in range(self.repeats)]

    def _measure_batch(self, schedules: Sequence[Schedule],
                       encoded: np.ndarray | None = None) -> list[float]:
        out: list[float] = []
        if encoded is None or not obs.enabled():
            encoded = [None] * len(schedules)
        for sched, row in zip(schedules, encoded):
            what = f"schedule {[str(i) for i in sched.items]}"
            tag = {} if row is None else {"design": hashlib.blake2b(
                row.tobytes(), digest_size=8).hexdigest()}
            if not self.cuda_graph:
                run = build_runner(self.graph, sched, self.impls,
                                   self.device)
                self.check(run, what, **tag)
                out.append(statistics.median(self.measure(run, **tag)))
                continue
            if self._pool is None and self.device.type == "cuda":
                self._pool = torch.cuda.graph_pool_handle()
            run = jit_runner(self.graph, sched, self.impls, self.device,
                             pool=self._pool, attrs=tag)
            run(self.env)  # warm-up, capture, a first replay
            # A pool lives while a graph captured into it does, so the
            # last schedule's graph is released only now, once this one
            # holds the pool.
            if self._held is not None:
                self._held.release()
            self._held = run
            self.check(run, f"{what} (CUDA graph)", **tag)
            out.append(statistics.median(self.measure(run, **tag)))
        return out


def demo_spmv_impls(graph: Graph, n: int = 16, seed: int = 0,
                    device: "str | torch.device | None" = None
                    ) -> tuple[dict, dict]:
    """(impls, env) realizing the coarse SpMV DAG with tiny dense ops.

    The JAX package's demo: small enough that a wall-clock search of
    every schedule takes seconds; the dataflow (pack -> send ->
    recv-wait -> remote multiply) follows the DAG, so the value gate
    is meaningful. ``AL``, ``AR`` and ``xL`` are drawn by
    ``np.random.default_rng(seed).normal`` in the JAX package's order
    and rounded to float32, so both packages hold the same bits; the
    products are ``torch.matmul``. On a card the receive buffer is
    allocated once, here, and WaitRecv, a host wait
    (:func:`~repro_torch.core.executor.host_wait`), returns once its
    sum is on the card: a CPU op's device work runs on the current
    stream, which no sync item orders before yR.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    AL, AR, xL = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  .to(dev) for s in ((n, n), (n, n), (n,)))
    recvbuf = torch.zeros(n, dtype=torch.float32, device=dev)
    summed = torch.cuda.Event() if dev.type == "cuda" else None

    def wait_recv(wire: torch.Tensor, recv: torch.Tensor) -> torch.Tensor:
        xR = wire + recv
        if summed is not None:
            summed.record(torch.cuda.current_stream(dev))
        host_wait(summed)
        return xR

    impls = {
        "Pack": op_impl(lambda x: x * 1.0, ["xL"], ["sendbuf"]),
        "PostSend": op_impl(lambda b: b, ["sendbuf"], ["wire"]),
        "PostRecv": op_impl(lambda: recvbuf, [], ["recvbuf"]),
        "WaitSend": op_impl(lambda w: w, ["wire"], ["sent"]),
        "WaitRecv": op_impl(wait_recv, ["wire", "recvbuf"], ["xR"]),
        "yL": op_impl(lambda x: AL @ x, ["xL"], ["yL"]),
        "yR": op_impl(lambda x: AR @ x, ["xR"], ["yR"]),
    }
    return impls, {"xL": xL}
