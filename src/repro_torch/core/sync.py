"""Synchronization-op insertion (paper Table III).

Given a complete :class:`Schedule` (traversal order + stream binding), the
schedule is *expanded* into the actual executed item sequence by inserting
the synchronization operations the CUDA runtime requires:

  u kind      v kind        inserted
  ----------  ------------  ----------------------------------------------
  CPU         CPU/BoundGPU  none (CPU ops are synchronous)
  BoundGPU_i  CPU           CER-after-u  ->  CES-b4-v
  BoundGPU_i  BoundGPU_i    none (same stream: implicit ordering)
  BoundGPU_i  BoundGPU_j    CER-after-u  ->  CSWE-b4-v     (i != j)

CER = cudaEventRecord (on u's stream, right after u)
CES = cudaEventSynchronize (host blocks until the event)
CSWE = cudaStreamWaitEvent (v's stream waits for the event)

The names mirror the paper's automatically generated names
("CES-b4-PostSend", "CER-after-Pack"), so generated rules read the same.

:mod:`repro_torch.core.executor` issues them as the CUDA calls above on
real streams.
"""
from __future__ import annotations

import dataclasses
import weakref

from repro_torch.core.dag import BoundOp, Graph, OpKind, Schedule


@dataclasses.dataclass(frozen=True)
class ExpandedItem:
    """One item of an expanded schedule.

    kind:   'op'   — an original DAG vertex (stream set for GPU ops)
            'CER'  — event record, anchored after ``anchor`` (on its stream)
            'CES'  — host event sync before ``anchor``, waiting on ``waits``
            'CSWE' — stream wait event before ``anchor`` (on ``stream``),
                     waiting on ``waits``
    """

    name: str
    kind: str
    stream: int | None = None
    anchor: str | None = None
    waits: tuple[str, ...] = ()


def expand(graph: Graph, schedule: Schedule) -> list[ExpandedItem]:
    """Insert Table III sync ops into ``schedule``.

    Insertion is deterministic given (order, streams): a single CER per
    recorded GPU op (immediately after it), and a single CES/CSWE per
    consumer (immediately before it) that waits on all required events.
    """
    streams = schedule.streams()
    expanded: list[ExpandedItem] = []
    recorded: set[str] = set()  # GPU ops that already have a CER

    for item in schedule.items:
        op = graph.ops[item.name]
        # Which predecessors require an event wait before this op?
        ces_waits: list[str] = []
        cswe_waits: list[str] = []
        for u in sorted(graph.preds[item.name]):
            uop = graph.ops[u]
            if uop.kind is not OpKind.GPU:
                continue  # CPU->anything: no sync needed
            if op.kind is OpKind.GPU and streams[u] == item.stream:
                continue  # same stream: implicit ordering
            if op.kind is OpKind.GPU:
                cswe_waits.append(u)
            else:
                ces_waits.append(u)

        # Events must have been recorded right after their producing op; we
        # retro-check: the producing op appears earlier in the traversal, so
        # its CER is already in `expanded` (inserted below when u was seen).
        for w in ces_waits + cswe_waits:
            assert w in recorded, f"event for {w} not recorded"

        if ces_waits:
            expanded.append(ExpandedItem(
                name=f"CES-b4-{item.name}", kind="CES",
                anchor=item.name, waits=tuple(ces_waits)))
        if cswe_waits:
            expanded.append(ExpandedItem(
                name=f"CSWE-b4-{item.name}", kind="CSWE",
                anchor=item.name, stream=item.stream,
                waits=tuple(cswe_waits)))

        expanded.append(ExpandedItem(
            name=item.name, kind="op", stream=item.stream))

        # Record an event after every GPU op whose completion any later
        # differently-synchronized consumer might need. A CER is cheap; the
        # paper inserts it for every GPU op that feeds a CPU op or a
        # different stream. We insert lazily-but-eagerly: if ANY successor
        # is CPU or could land on another stream, record now (succ streams
        # are known since the schedule is complete).
        if op.kind is OpKind.GPU and item.name not in recorded:
            needs_event = False
            for v in graph.succs[item.name]:
                vop = graph.ops[v]
                if vop.kind is not OpKind.GPU:
                    needs_event = True
                elif streams.get(v) != item.stream:
                    needs_event = True
            if needs_event:
                expanded.append(ExpandedItem(
                    name=f"CER-after-{item.name}", kind="CER",
                    anchor=item.name, stream=item.stream))
                recorded.add(item.name)

    return expanded


# Featurization expands every schedule in a corpus, and only needs the
# item *names*; constructing ExpandedItem records for each of them is
# the dominant cost of :func:`repro_torch.core.features.featurize`. The fast
# path below re-derives just the name sequence from per-graph tables
# (cached weakly, so graphs stay collectable). It is locked to
# :func:`expand` by tests/test_torch_core.py::test_expanded_names_
# matches_expand.

_SYNC_TABLES: "weakref.WeakKeyDictionary[Graph, tuple]" = \
    weakref.WeakKeyDictionary()


def _sync_tables(graph: Graph) -> tuple:
    cached = _SYNC_TABLES.get(graph)
    if cached is not None and cached[0] == graph.version:
        return cached[1]
    is_gpu = {n: op.kind is OpKind.GPU for n, op in graph.ops.items()}
    gpu_preds = {n: tuple(u for u in sorted(p) if is_gpu[u])
                 for n, p in graph.preds.items()}
    succ_info = {n: tuple((v, is_gpu[v]) for v in graph.succs[n])
                 for n in graph.ops}
    ces = {n: f"CES-b4-{n}" for n in graph.ops}
    cswe = {n: f"CSWE-b4-{n}" for n in graph.ops}
    cer = {n: f"CER-after-{n}" for n in graph.ops}
    tables = (is_gpu, gpu_preds, succ_info, ces, cswe, cer)
    _SYNC_TABLES[graph] = (graph.version, tables)
    return tables


def expanded_names(graph: Graph, schedule: Schedule) -> list[str]:
    """Names of the expanded sequence (fast path of :func:`expand`)."""
    is_gpu, gpu_preds, succ_info, ces, cswe, cer = _sync_tables(graph)
    streams = {it.name: it.stream for it in schedule.items
               if it.stream is not None}
    out: list[str] = []
    for it in schedule.items:
        name = it.name
        gp = gpu_preds[name]
        if is_gpu[name]:
            st = it.stream
            for u in gp:
                if streams[u] != st:
                    out.append(cswe[name])
                    break
            out.append(name)
            for v, v_gpu in succ_info[name]:
                if not v_gpu or streams.get(v) != st:
                    out.append(cer[name])
                    break
        else:
            if gp:
                out.append(ces[name])
            out.append(name)
    return out
