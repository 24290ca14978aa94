"""Execute a scheduled DAG on real CUDA streams and events.

:func:`build_runner` issues the expanded schedule
(:func:`repro_torch.core.sync.expand`) item by item, in schedule order,
from the host thread:

  * a GPU op runs under ``torch.cuda.stream(s)`` for its stream id —
    one ``torch.cuda.Stream`` per id, created once per runner;
  * a CPU op (PostSend, PostRecv, WaitSend, WaitRecv) runs on the host;
  * CER  -> ``event.record(stream)``, CES -> ``event.synchronize()``
    (the host blocks), CSWE -> ``stream.wait_event(event)``; the runner
    owns one ``torch.cuda.Event`` per CER, created once and recorded
    again on every run (within a run each record precedes every wait on
    it, so a wait never sees an earlier run's record).

Nothing else orders the ops: that is what the measurement measures. So
an op implementation must not synchronise or wait on its own, and the
buffers it reads and writes across streams belong to the environment,
allocated once outside the timed call. An op that waits for device work
on the host (WaitSend, WaitRecv) does so through :func:`host_wait`. On
the CPU the items run in order and the sync items are ignored.

:func:`jit_runner` is the JAX package's compiled runner: on a card it
captures the same items into one CUDA graph and later calls replay it.
The JAX package's token chains become stream dependencies: one capture
stream is the host chain, so a CES is that stream waiting on the events
and a host wait inside an op is :func:`host_wait`'s stream wait, and
every GPU op joins the host chain at its launch point.

Op implementations are plain ``impl(env) -> {name: value}`` callables;
:func:`op_impl` lifts a function of named inputs into one.
"""
from __future__ import annotations

from typing import Callable, Mapping, Sequence

import torch

from repro_torch import obs
from repro_torch.core.dag import Graph, OpKind, Schedule
from repro_torch.core.sync import ExpandedItem, expand
from repro_torch.device import resolve_device

OpImpl = Callable[[dict], dict]


def op_impl(fn: Callable, inputs: list[str], outputs: list[str]) -> OpImpl:
    """Lift ``fn(*input_values)`` into an op impl.

    ``fn`` returns the single output's value, a tuple of values for
    several outputs, and anything (ignored) for none.
    """

    def impl(env: dict) -> dict:
        outs = fn(*[env[k] for k in inputs])
        if len(outputs) == 1:
            outs = (outs,)
        elif not outputs:
            outs = ()
        return dict(zip(outputs, outs, strict=True))

    return impl


def host_wait(event: "torch.cuda.Event | None") -> None:
    """Wait for ``event`` where the host chain is: the host blocks on it
    (``event.synchronize()``), or, while a stream is being captured, the
    capturing stream waits on it (a host block is illegal there, and in
    the graph the capture stream is the host chain). ``None`` (what an
    op on the CPU gets) waits on nothing."""
    if event is None:
        return
    if torch.cuda.is_current_stream_capturing():
        torch.cuda.current_stream().wait_event(event)
    else:
        event.synchronize()


def _gpu_ops(graph: Graph) -> set[str]:
    return {n for n, op in graph.ops.items() if op.kind is OpKind.GPU}


def _streams_and_events(items: Sequence[ExpandedItem], gpu: set[str],
                        dev: torch.device) -> tuple[dict, dict]:
    """One stream per stream id of a GPU op and one event per CER."""
    # PyTorch hands streams out round-robin from a pool of 32 per
    # priority; ids drawn together here are distinct (checked), and an
    # environment's own streams (a comm stream) come from another
    # priority's pool so they never alias these.
    streams = {s: torch.cuda.Stream(device=dev)
               for s in sorted({it.stream for it in items
                                if it.kind == "op" and it.name in gpu})}
    if len({st.cuda_stream for st in streams.values()}) != len(streams):
        raise RuntimeError(f"{len(streams)} stream ids share CUDA streams")
    events = {it.anchor: torch.cuda.Event() for it in items
              if it.kind == "CER"}
    return streams, events


def _run_in_order(items: Sequence[ExpandedItem],
                  impls: Mapping[str, OpImpl], env: dict) -> dict:
    """The items' ops in order, the sync items ignored (the CPU)."""
    env = dict(env)
    for it in items:
        impl = impls.get(it.name) if it.kind == "op" else None
        if impl is not None:
            env.update(impl(env))
    return env


def _issue(items: Sequence[ExpandedItem], impls: Mapping[str, OpImpl],
           gpu: set[str], streams: dict, events: dict, env: dict,
           host: "torch.cuda.Stream | None" = None) -> dict:
    """Issue the items once from the host, the sync items as CUDA calls.

    With ``host``, the stream being captured, that stream is the host
    chain: a CES is it waiting on the events, and each GPU op's stream
    first joins it (the JAX package's ``_join(stream_tok, cpu_tok)``).
    """
    env = dict(env)
    for it in items:
        if it.kind == "CER":
            events[it.anchor].record(streams[it.stream])
        elif it.kind == "CES":
            for w in it.waits:
                if host is None:
                    events[w].synchronize()
                else:
                    host.wait_event(events[w])
        elif it.kind == "CSWE":
            for w in it.waits:
                streams[it.stream].wait_event(events[w])
        else:
            impl = impls.get(it.name)
            if impl is None:  # start / end / pure-control CPU ops
                continue
            if it.name in gpu:
                if host is not None:
                    streams[it.stream].wait_stream(host)
                with torch.cuda.stream(streams[it.stream]):
                    env.update(impl(env))
            else:
                env.update(impl(env))
    return env


def run_items(graph: Graph, items: Sequence[ExpandedItem],
              impls: Mapping[str, OpImpl],
              device: "str | torch.device | None" = None
              ) -> Callable[[dict], dict]:
    """Return ``run(env) -> env`` issuing ``items`` as they stand.

    :func:`build_runner` passes the full expansion; a check that a
    missing sync is caught passes the expansion with one item removed.
    """
    dev = resolve_device(device)
    items = list(items)
    if dev.type == "cpu":
        return lambda env: _run_in_order(items, impls, env)
    gpu = _gpu_ops(graph)
    streams, events = _streams_and_events(items, gpu, dev)
    return lambda env: _issue(items, impls, gpu, streams, events, env)


def build_runner(graph: Graph, schedule: Schedule,
                 impls: Mapping[str, OpImpl],
                 device: "str | torch.device | None" = None
                 ) -> Callable[[dict], dict]:
    """Return ``run(env) -> env`` executing the expanded schedule."""
    return run_items(graph, expand(graph, schedule), impls, device)


class GraphRunner:
    """``run(env) -> env`` of :func:`jit_runner` over ``items``.

    On a card the first call runs the items once as :func:`run_items`
    does, on the same streams (a warm-up: it builds the kernels and
    loads the libraries), captures them into one ``torch.cuda.CUDAGraph``
    (allocating from ``pool``, a ``torch.cuda.graph_pool_handle()``,
    when given), replays it once and returns the capture's environment.
    Later calls replay the graph. The graph reads the first call's input
    tensors in place: a later call that passes other tensors of the same
    shape, dtype and device has their values copied into those first;
    another shape, dtype, device or set of inputs raises ``ValueError``.
    The returned environment holds the tensors the capture allocated or
    was given, and every replay rewrites them. A capture that fails
    raises: nothing falls back to the eager runner.

    In the capture one stream is the host chain (the JAX package's cpu
    token): CPU ops run on it, a CES is it waiting on the events, and
    each GPU op's stream first waits on an event recorded on it at the
    op's launch point. Each stream is forked from it at the start and
    joined back at the end. On the CPU each call runs the items in
    order, as :func:`run_items` does there.

    The first call is the span ``executor.capture`` and :meth:`release`
    the span ``executor.release``, each with ``attrs`` as attributes.
    """

    def __init__(self, graph: Graph, items: Sequence[ExpandedItem],
                 impls: Mapping[str, OpImpl],
                 device: "str | torch.device | None" = None, pool=None,
                 attrs: Mapping | None = None):
        self.device = resolve_device(device)
        self.items = list(items)
        self.impls = impls
        self.pool = pool
        self.attrs = dict(attrs or {})
        self.cuda_graph: "torch.cuda.CUDAGraph | None" = None
        self._gpu = _gpu_ops(graph)
        self._inputs: dict | None = None
        self._env: dict = {}
        if self.device.type == "cuda":
            self._streams, self._events = _streams_and_events(
                self.items, self._gpu, self.device)
            self._host = torch.cuda.Stream(device=self.device)

    def __call__(self, env: Mapping) -> dict:
        if self._inputs is None:
            with obs.span("executor.capture", **self.attrs):
                out = (_run_in_order(self.items, self.impls, env)
                       if self.device.type == "cpu" else self._capture(env))
            self._inputs = dict(env)
            return out
        self._stage(env)
        if self.device.type == "cpu":
            return _run_in_order(self.items, self.impls, env)
        self.cuda_graph.replay()
        return {**self._env, **env}

    def _stage(self, env: Mapping) -> None:
        """Hold ``env`` to the first call's inputs; copy the values of
        other tensors into those the graph reads."""
        if set(env) != set(self._inputs):
            raise ValueError(f"inputs {sorted(env)}, captured with "
                             f"{sorted(self._inputs)}")
        for k, v in env.items():
            c = self._inputs[k]
            if v is c:
                continue
            if not (isinstance(v, torch.Tensor)
                    and isinstance(c, torch.Tensor)):
                raise ValueError(f"input {k!r} is not the object the "
                                 "runner was first called with")
            if (v.shape, v.dtype, v.device) != (c.shape, c.dtype, c.device):
                raise ValueError(
                    f"input {k!r}: {tuple(v.shape)} {v.dtype} on "
                    f"{v.device}, captured as {tuple(c.shape)} {c.dtype} "
                    f"on {c.device}")
            if self.device.type == "cuda":
                c.copy_(v)

    def _capture(self, env: Mapping) -> dict:
        _issue(self.items, self.impls, self._gpu, self._streams,
               self._events, env)
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        host = self._host
        with torch.cuda.stream(host):
            graph.capture_begin(pool=self.pool)
            try:
                for st in self._streams.values():
                    st.wait_stream(host)
                out = _issue(self.items, self.impls, self._gpu,
                             self._streams, self._events, env, host)
                for st in self._streams.values():
                    host.wait_stream(st)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture was invalidated; report the cause
                raise
            graph.capture_end()
        self.cuda_graph, self._env = graph, out
        graph.replay()
        return dict(out)

    def release(self) -> None:
        """Free the graph and the environment it wrote; the next call
        captures again."""
        with obs.span("executor.release", **self.attrs):
            if self.cuda_graph is not None:
                self.cuda_graph.reset()
            self.cuda_graph, self._inputs, self._env = None, None, {}


def jit_runner(graph: Graph, schedule: Schedule,
               impls: Mapping[str, OpImpl],
               device: "str | torch.device | None" = None,
               pool=None, attrs: Mapping | None = None) -> GraphRunner:
    """The expanded schedule as one CUDA graph (:class:`GraphRunner`):
    the JAX package's ``jax.jit(build_runner(...))``. ``attrs`` go on
    its telemetry spans."""
    return GraphRunner(graph, expand(graph, schedule), impls, device, pool,
                       attrs)
