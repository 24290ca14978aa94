"""Analytic machine model: simulate an expanded schedule's makespan.

A deterministic, fast objective for the search, beside the measured one
(:mod:`repro_torch.engine.wallclock`). This discrete-event model
simulates:

  * a host control thread executing the expanded item sequence in order,
  * N device streams (serialization chains) with FIFO semantics,
  * asynchronous point-to-point transfers with rendezvous semantics
    (a transfer starts once both the local post and the symmetric remote
    post have happened; ranks are modeled as symmetric, which is exact for
    the paper's uniform band SpMV),
  * CUDA-event sync ops as produced by :mod:`repro_torch.core.sync`.

Durations come from op metadata (flops / HBM bytes / comm bytes) and the
:class:`Machine` roofline constants. The defaults describe the port on
one NVIDIA H100 80GB HBM3 at a 700.00 W power limit: its data sheet's
float32 and HBM rates, the halo exchange of
:mod:`repro_torch.spmv.distributed` (device-to-device copies between
ranks in one process), and the host costs of
:mod:`repro_torch.core.executor` issuing a schedule. Each constant names
its source. The model runs on the host in numpy-free Python; it takes no
device.

The JAX package's ``repro/core/costmodel.py`` with its imports rewritten
and another ``Machine()`` default (the reference's is TPU v5e-like).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.dag import CommRole, Graph, OpKind, Schedule
from repro_torch.core.sync import ExpandedItem, expand


@dataclasses.dataclass(frozen=True)
class Machine:
    # NVIDIA H100 SXM data sheet, float32 outside the tensor cores (the
    # SpMV and pack kernels run there); the card measured below is an
    # NVIDIA H100 80GB HBM3 at a 700.00 W power limit, the data sheet's.
    flops_per_s: float = 67e12
    # NVIDIA H100 SXM data sheet, HBM3.
    hbm_bytes_per_s: float = 3.35e12
    # The halo exchange (spmv/distributed.py: 8 device-to-device copies
    # on one comm stream): PostSend's bytes land comm_latency_s +
    # bytes / link_bytes_per_s after the post. The straight line through
    # the 8 copies' CUDA-event time at blocks of 37.5-600 KB (18.7 us
    # at 0 bytes, 3.98e-6 us per byte of one block), fitted by
    # examples/torch_profile_schedules.py on an NVIDIA H100 80GB HBM3 at
    # 700.00 W (PERF.md section 5).
    link_bytes_per_s: float = 251.0e9
    # Host costs of core/executor.py issuing a schedule, the same run:
    # the host clock around 400 calls of each item, averaged over the
    # items of each kind.
    launch_overhead_s: float = 38.68e-6  # Pack, yL, yR: 34.5, 41.0, 40.5 us
    cpu_op_s: float = 46.07e-6           # PostSend 175.9 (8 copies),
    #                                      PostRecv 1.1, WaitSend 3.5,
    #                                      WaitRecv 3.7 us
    sync_op_s: float = 2.46e-6           # CER 2.5, CES 2.3, CSWE 2.5 us
    comm_latency_s: float = 18.68e-6     # the halo fit's intercept

    def gpu_duration(self, flops: float, bytes_hbm: float) -> float:
        t = 0.0
        if flops:
            t = max(t, flops / self.flops_per_s)
        if bytes_hbm:
            t = max(t, bytes_hbm / self.hbm_bytes_per_s)
        return max(t, 1e-7)

    def transfer_duration(self, nbytes: float) -> float:
        return self.comm_latency_s + nbytes / self.link_bytes_per_s


@dataclasses.dataclass
class SimResult:
    makespan: float
    op_start: dict[str, float]
    op_end: dict[str, float]


def op_durations(graph: Graph, machine: Machine | None = None
                 ) -> dict[str, float]:
    """Duration of every DAG op under ``machine``.

    Schedule-independent, so batched evaluation
    (:class:`repro_torch.engine.base.BatchEvaluator` and friends)
    computes this once and passes it to :func:`simulate` for every
    schedule in the batch.
    The expressions mirror the per-op fallback inside :func:`simulate`
    exactly, keeping batched results bit-identical to unbatched ones.
    """
    m = machine or Machine()
    out: dict[str, float] = {}
    for name, op in graph.ops.items():
        if op.duration is not None:
            out[name] = op.duration
        elif op.kind is OpKind.GPU:
            out[name] = m.gpu_duration(op.flops, op.bytes_hbm)
        else:
            out[name] = m.cpu_op_s
    return out


def simulate(graph: Graph, schedule: Schedule,
             machine: Machine | None = None,
             durations: dict[str, float] | None = None) -> SimResult:
    """Simulate the expanded schedule; return its makespan (seconds).

    ``durations`` optionally supplies precomputed per-op durations (from
    :func:`op_durations`) so batch callers skip the per-op roofline math.
    """
    m = machine or Machine()
    items: list[ExpandedItem] = expand(graph, schedule)

    cpu_t = 0.0
    stream_t: dict[int, float] = {}
    stream_wait: dict[int, float] = {}   # pending CSWE floor per stream
    event_t: dict[str, float] = {}       # recorded-op name -> event time
    op_start: dict[str, float] = {}
    op_end: dict[str, float] = {}

    # Rendezvous bookkeeping (symmetric-rank model). Multiple channels
    # (per-neighbor fine-grained DAGs) are keyed by the op-name suffix
    # after PostSend/PostRecv; the symmetric remote send for our recv on
    # channel s is our own send on the *twin* channel (l <-> r; same
    # channel when there is only one).
    post_send_t: dict[str, float] = {}
    post_recv_t: dict[str, float] = {}
    send_bytes: dict[str, float] = {}
    recv_bytes: dict[str, float] = {}
    _twin = {"_l": "_r", "_r": "_l",
             # 3-D halo faces: our recv on the -d face pairs with the
             # symmetric neighbor's +d send (== our own +d send).
             "_xn": "_xp", "_xp": "_xn", "_yn": "_yp", "_yp": "_yn",
             "_zn": "_zp", "_zp": "_zn"}

    def transfer_done(kind: str, suffix: str) -> float:
        if kind == "send":
            # Eager/buffered semantics: the send buffer is reusable once
            # the wire transfer finishes, independent of the remote post.
            assert suffix in post_send_t, "WaitSend before PostSend"
            return post_send_t[suffix] + \
                m.transfer_duration(send_bytes[suffix])
        twin = _twin.get(suffix, suffix)
        if twin not in post_send_t:
            twin = suffix
        assert twin in post_send_t and suffix in post_recv_t, \
            "WaitRecv before both posts - DAG should prevent this"
        return max(post_send_t[twin], post_recv_t[suffix]) + \
            m.transfer_duration(recv_bytes[suffix])

    for it in items:
        if it.kind == "CER":
            # Event enqueued on the producer's stream right after it: event
            # fires when everything currently in that stream completes.
            event_t[it.anchor] = stream_t.get(it.stream, 0.0)
            cpu_t += m.sync_op_s
            continue
        if it.kind == "CES":
            cpu_t += m.sync_op_s
            for w in it.waits:
                cpu_t = max(cpu_t, event_t[w])
            continue
        if it.kind == "CSWE":
            cpu_t += m.sync_op_s
            floor = max(event_t[w] for w in it.waits)
            s = it.stream
            stream_wait[s] = max(stream_wait.get(s, 0.0), floor)
            continue

        op = graph.ops[it.name]
        if op.kind is OpKind.GPU:
            cpu_t += m.launch_overhead_s  # async launch
            s = it.stream
            start = max(cpu_t, stream_t.get(s, 0.0),
                        stream_wait.pop(s, 0.0))
            dur = durations[it.name] if durations is not None else (
                op.duration if op.duration is not None else
                m.gpu_duration(op.flops, op.bytes_hbm))
            op_start[it.name] = start
            op_end[it.name] = start + dur
            stream_t[s] = start + dur
            continue

        # Synchronous CPU op.
        dur = durations[it.name] if durations is not None else (
            op.duration if op.duration is not None else m.cpu_op_s)
        op_start[it.name] = cpu_t
        if op.comm_role is CommRole.POST_SEND:
            cpu_t += dur
            sfx = it.name.removeprefix("PostSend")
            post_send_t[sfx] = cpu_t
            send_bytes[sfx] = op.comm_bytes
        elif op.comm_role is CommRole.POST_RECV:
            cpu_t += dur
            sfx = it.name.removeprefix("PostRecv")
            post_recv_t[sfx] = cpu_t
            recv_bytes[sfx] = op.comm_bytes
        elif op.comm_role is CommRole.WAIT_SEND:
            cpu_t += dur
            cpu_t = max(cpu_t, transfer_done(
                "send", it.name.removeprefix("WaitSend")))
        elif op.comm_role is CommRole.WAIT_RECV:
            cpu_t += dur
            cpu_t = max(cpu_t, transfer_done(
                "recv", it.name.removeprefix("WaitRecv")))
        else:
            cpu_t += dur
        op_end[it.name] = cpu_t

    makespan = max([cpu_t] + list(stream_t.values()))
    return SimResult(makespan=makespan, op_start=op_start, op_end=op_end)


def makespan(graph: Graph, schedule: Schedule,
             machine: Machine | None = None) -> float:
    return simulate(graph, schedule, machine).makespan
