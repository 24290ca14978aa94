"""Execute a scheduled DAG on real CUDA streams and events.

The expanded schedule (:func:`repro_torch.core.sync.expand`) is issued
item by item, in schedule order, from the host thread:

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
allocated once outside the timed call. There is no CUDA-graph capture,
because a CES is a host sync. On the CPU the items run in order and
the sync items are ignored.

Op implementations are plain ``impl(env) -> {name: value}`` callables;
:func:`op_impl` lifts a function of named inputs into one.
"""
from __future__ import annotations

from typing import Callable, Mapping, Sequence

import torch

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
    gpu = {n for n, op in graph.ops.items() if op.kind is OpKind.GPU}

    if dev.type == "cpu":
        def run_cpu(env: dict) -> dict:
            env = dict(env)
            for it in items:
                impl = impls.get(it.name) if it.kind == "op" else None
                if impl is not None:
                    env.update(impl(env))
            return env

        return run_cpu

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

    def run(env: dict) -> dict:
        env = dict(env)
        for it in items:
            if it.kind == "CER":
                events[it.anchor].record(streams[it.stream])
            elif it.kind == "CES":
                for w in it.waits:
                    events[w].synchronize()
            elif it.kind == "CSWE":
                for w in it.waits:
                    streams[it.stream].wait_event(events[w])
            else:
                impl = impls.get(it.name)
                if impl is None:  # start / end / pure-control CPU ops
                    continue
                if it.name in gpu:
                    with torch.cuda.stream(streams[it.stream]):
                        env.update(impl(env))
                else:
                    env.update(impl(env))
        return env

    return run


def build_runner(graph: Graph, schedule: Schedule,
                 impls: Mapping[str, OpImpl],
                 device: "str | torch.device | None" = None
                 ) -> Callable[[dict], dict]:
    """Return ``run(env) -> env`` executing the expanded schedule."""
    return run_items(graph, expand(graph, schedule), impls, device)
