"""Numpy batch simulator: the discrete-event model as array ops.

:func:`repro_torch.core.costmodel.simulate` replays one expanded schedule at a
time through a Python loop. This backend replays a whole *batch* of
schedules at once: every schedule of a graph is a permutation of the
same N ops, so the batch packs into an ``(B, N)`` op-id matrix plus an
``(B, N)`` stream matrix, and one pass over the N positions updates all
B simulations with vectorized numpy ops —

  * per-stream FIFO times and pending stream-wait floors are ``(B, S)``
    arrays updated by fancy-indexed prefix-max;
  * CUDA-event times are a ``(B, N+1)`` array (slot N is a zero-valued
    sentinel that pads variable-length wait sets — harmless under
    ``max`` since all event times are >= 0);
  * rendezvous (PostSend/PostRecv/WaitSend/WaitRecv) is a gather from
    ``(B, C)`` per-channel post-time arrays plus precomputed wire-time
    constants.

Sync-op *insertion* (Table III) is also derived in array form: CES
presence is static per op (any GPU predecessor), CSWE/CER presence is a
vectorized stream comparison over padded predecessor/successor id
tables. No :class:`~repro_torch.core.sync.ExpandedItem` objects are
built.

Every floating-point operation mirrors the serial simulator's exact
sequence of IEEE adds/maxes per element, so results are **bit-identical**
to :func:`~repro_torch.core.costmodel.simulate` — locked by an
exhaustive cross-check on the paper SpMV space and seeded samples of
the fine-grained and halo3d spaces (tests/test_torch_analytic.py).

One static precondition replaces the serial simulator's runtime
rendezvous asserts: for every WaitRecv channel the matching posts (and
the twin-channel PostSend, when the twin exists in the graph) must be
DAG ancestors of the wait, so they are posted in *every* valid
traversal. All repo graphs guarantee this via their deadlock-avoidance
edges; :class:`VectorizedEvaluator` raises at construction otherwise.

It runs in numpy on the host and takes no device. The JAX package's
``repro/engine/vectorized.py`` with its imports rewritten.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.costmodel import Machine
from repro_torch.core.dag import CommRole, Graph, OpKind, Schedule
from repro_torch.engine.base import EvaluatorBase

_ROLE_NONE, _ROLE_PS, _ROLE_PR, _ROLE_WS, _ROLE_WR = range(5)
_ROLE_PREFIX = {_ROLE_PS: "PostSend", _ROLE_PR: "PostRecv",
                _ROLE_WS: "WaitSend", _ROLE_WR: "WaitRecv"}
# Twin channels of the symmetric-rank rendezvous model (mirrors
# costmodel.simulate's _twin table).
_TWIN = {"_l": "_r", "_r": "_l",
         "_xn": "_xp", "_xp": "_xn", "_yn": "_yp", "_yp": "_yn",
         "_zn": "_zp", "_zp": "_zn"}


def _ancestors(graph: Graph, name: str) -> set[str]:
    out: set[str] = set()
    frontier = list(graph.preds[name])
    while frontier:
        u = frontier.pop()
        if u not in out:
            out.add(u)
            frontier.extend(graph.preds[u])
    return out


def _pad(rows: list[list[int]], sentinel: int) -> np.ndarray:
    width = max(1, max((len(r) for r in rows), default=0))
    out = np.full((len(rows), width), sentinel, dtype=np.int32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


class GraphTables:
    """Schedule-independent encoding of (graph, machine) for the batch
    simulator; built once per evaluator, reused by every batch."""

    def __init__(self, graph: Graph, machine: Machine,
                 durations: dict[str, float]):
        names = list(graph.ops)
        self.op_id = {n: i for i, n in enumerate(names)}
        n = self.n_ops = len(names)
        ops = [graph.ops[name] for name in names]

        self.is_gpu = np.array([op.kind is OpKind.GPU for op in ops])
        self.dur = np.array([durations[name] for name in names])
        # What each op adds to the host clock when it executes: async
        # launch overhead for GPU ops, the op duration for CPU ops.
        self.cpu_add = np.where(self.is_gpu, machine.launch_overhead_s,
                                self.dur)

        gpu_pred_rows = [[self.op_id[u] for u in sorted(graph.preds[name])
                          if graph.ops[u].kind is OpKind.GPU]
                         for name in names]
        gpu_succ_rows = [[self.op_id[v] for v in sorted(graph.succs[name])
                          if graph.ops[v].kind is OpKind.GPU]
                         for name in names]
        self.gpu_preds = _pad(gpu_pred_rows, sentinel=n)
        self.gpu_succs = _pad(gpu_succ_rows, sentinel=n)
        self.has_gpu_pred = np.array([bool(r) for r in gpu_pred_rows])
        # CER is unconditionally required when any successor is a CPU op;
        # GPU successors contribute a per-schedule stream comparison.
        self.cer_static = np.array(
            [any(graph.ops[v].kind is not OpKind.GPU
                 for v in graph.succs[name]) for name in names])

        role_of = {CommRole.POST_SEND: _ROLE_PS,
                   CommRole.POST_RECV: _ROLE_PR,
                   CommRole.WAIT_SEND: _ROLE_WS,
                   CommRole.WAIT_RECV: _ROLE_WR}
        self.role = np.array([role_of.get(op.comm_role, _ROLE_NONE)
                              for op in ops], dtype=np.int8)
        self.is_post = (self.role == _ROLE_PS) | (self.role == _ROLE_PR)
        self.is_wait = (self.role == _ROLE_WS) | (self.role == _ROLE_WR)

        # Channels: the op-name suffix after the role prefix (exactly
        # what simulate() strips at runtime), one slot per suffix.
        suffixes: dict[str, int] = {}
        chan = np.zeros(n, dtype=np.int32)
        for i, (name, op) in enumerate(zip(names, ops)):
            r = int(self.role[i])
            if r == _ROLE_NONE:
                continue
            sfx = name.removeprefix(_ROLE_PREFIX[r])
            chan[i] = suffixes.setdefault(sfx, len(suffixes))
        self.chan = chan
        c = max(1, len(suffixes))
        send_bytes = np.zeros(c)
        recv_bytes = np.zeros(c)
        self.twin = np.arange(c, dtype=np.int32)
        for i, (name, op) in enumerate(zip(names, ops)):
            r = int(self.role[i])
            if r == _ROLE_PS:
                send_bytes[chan[i]] = op.comm_bytes
            elif r == _ROLE_PR:
                recv_bytes[chan[i]] = op.comm_bytes
        # Wire times are schedule-independent; precompute them with the
        # same transfer_duration() call the serial simulator makes.
        self.send_xfer = np.array(
            [machine.transfer_duration(b) for b in send_bytes])
        self.recv_xfer = np.array(
            [machine.transfer_duration(b) for b in recv_bytes])

        # Static rendezvous resolution + the ancestor precondition that
        # replaces simulate()'s runtime asserts (see module docstring).
        # Post/wait ops collapse to slot arithmetic on one (B, 2C) post
        # array — send channel c at slot c, recv channel c at slot C+c:
        #   post op  -> write cpu_t to post_slot[op]
        #   wait op  -> cpu_t = max(cpu_t,
        #                   max(post[wait_a[op]], post[wait_b[op]])
        #                   + wait_xfer[op])
        # (for WaitSend both slots are the send slot; max(x, x) == x).
        self.post_slot = np.zeros(n, dtype=np.int32)
        self.wait_a = np.zeros(n, dtype=np.int32)
        self.wait_b = np.zeros(n, dtype=np.int32)
        self.wait_xfer = np.zeros(n)
        for i, name in enumerate(names):
            r = int(self.role[i])
            ci = chan[i]
            if r == _ROLE_PS:
                self.post_slot[i] = ci
            elif r == _ROLE_PR:
                self.post_slot[i] = c + ci
            elif r in (_ROLE_WS, _ROLE_WR):
                sfx = name.removeprefix(_ROLE_PREFIX[r])
                anc = _ancestors(graph, name)
                if r == _ROLE_WS:
                    if f"PostSend{sfx}" not in anc:
                        raise ValueError(
                            f"vectorized backend: PostSend{sfx} must be "
                            f"a DAG ancestor of {name}")
                    self.wait_a[i] = self.wait_b[i] = ci
                    self.wait_xfer[i] = self.send_xfer[ci]
                    continue
                twin_sfx = _TWIN.get(sfx, sfx)
                if f"PostSend{twin_sfx}" not in graph.ops:
                    twin_sfx = sfx
                if (f"PostSend{twin_sfx}" not in anc
                        or f"PostRecv{sfx}" not in anc):
                    raise ValueError(
                        f"vectorized backend: PostSend{twin_sfx} and "
                        f"PostRecv{sfx} must be DAG ancestors of {name} "
                        "(add rendezvous edges, or use backend='sim')")
                self.twin[ci] = suffixes[twin_sfx]
                self.wait_a[i] = self.twin[ci]
                self.wait_b[i] = c + ci
                self.wait_xfer[i] = self.recv_xfer[ci]

        self.sync_op_s = machine.sync_op_s


class _Section:
    """Per-position slices of the rows where a (B, N) mask is True.

    One global ``nonzero`` + ``searchsorted`` replaces the per-column
    ``np.nonzero(mask[:, i])`` the inner loop would otherwise pay N
    times; :meth:`split` groups any aligned per-(row, position) value
    array the same way, so the loop body only does gathers on
    pre-sliced views.
    """

    def __init__(self, mask: np.ndarray):
        n = mask.shape[1]
        self._cols, self._rows = np.nonzero(mask.T)
        self._bounds = np.searchsorted(self._cols, np.arange(n + 1))
        self.rows = self._slices(self._rows)

    def _slices(self, values: np.ndarray) -> list[np.ndarray]:
        b = self._bounds
        return [values[b[i]:b[i + 1]] for i in range(len(b) - 1)]

    def split(self, arr: np.ndarray) -> list[np.ndarray]:
        """Group ``arr[(b, i), ...]`` values by position ``i``."""
        return self._slices(np.moveaxis(arr, 0, 1)[self._cols, self._rows])


def simulate_encoded(tables: GraphTables, encoded: np.ndarray
                     ) -> np.ndarray:
    """Makespans for a ``(B, 2, N)`` encoded batch (op ids row 0,
    streams row 1; see
    :meth:`~repro_torch.space.schedule.ScheduleSpace.encode_batch`),
    bit-identical to per-schedule
    :func:`repro_torch.core.costmodel.simulate`."""
    T = tables
    B, N = encoded.shape[0], encoded.shape[2]
    if B == 0:
        return np.zeros(0)
    order = encoded[:, 0, :]                     # (B, N) op ids
    streams = encoded[:, 1, :]                   # (B, N) stream or -1
    rows = np.arange(B, dtype=np.intp)[:, None]
    en = N + 1
    ev_base = (rows * en)[:, :, None]            # (B, 1, 1) event rows

    # stream_of[b, op] = the stream op runs on in schedule b (-9 for the
    # sentinel op slot; unused CPU slots keep -1).
    stream_of = np.full((B, en), -9, dtype=np.int32)
    np.put_along_axis(stream_of, order, streams, axis=1)
    so_flat = stream_of.ravel()

    gp = T.gpu_preds[order]                      # (B, N, P)
    gs = T.gpu_succs[order]                      # (B, N, Q)
    own = streams[:, :, None]
    is_gpu_at = T.is_gpu[order]                  # (B, N)
    # Table III in array form: which positions carry a CES / CSWE / CER.
    cswe_mask = (gp < N) & (so_flat[ev_base + gp] != own)   # per-wait
    has_cswe = is_gpu_at & cswe_mask.any(axis=2)
    has_ces = ~is_gpu_at & T.has_gpu_pred[order]
    has_cer = is_gpu_at & (
        T.cer_static[order]
        | ((gs < N) & (so_flat[ev_base + gs] != own)).any(axis=2))

    n_streams = max(1, int(streams.max()) + 1)
    n_chan = T.send_xfer.shape[0]

    # Bulk flat-index arrays (state buffers are 1-D: slot b*width+col;
    # fancy indexing on 1-D arrays beats 2-D index pairs), grouped into
    # per-position views up front so the loop body is pure arithmetic.
    sidx = rows * n_streams + np.maximum(streams, 0)     # GPU stream slot
    ev_gather = ev_base + np.where(cswe_mask, gp, N)
    ces_gather = ev_base + gp                    # sentinel -> 0.0
    pidx = rows * (2 * n_chan) + T.post_slot[order]
    aidx = rows * (2 * n_chan) + T.wait_a[order]
    bidx = rows * (2 * n_chan) + T.wait_b[order]

    ces = _Section(has_ces)
    ces_ev = ces.split(ces_gather)
    cswe = _Section(has_cswe)
    cswe_ev = cswe.split(ev_gather)
    cswe_sidx = cswe.split(sidx)
    gpu = _Section(is_gpu_at)
    gpu_sidx = gpu.split(sidx)
    gpu_dur = gpu.split(T.dur[order])
    post = _Section(T.is_post[order])
    post_pidx = post.split(pidx)
    wait = _Section(T.is_wait[order])
    wait_aidx = wait.split(aidx)
    wait_bidx = wait.split(bidx)
    wait_xf = wait.split(T.wait_xfer[order])
    cer = _Section(has_cer)
    cer_widx = cer.split(rows * en + order)
    cer_sidx = cer.split(sidx)

    cpu_add_t = np.ascontiguousarray(T.cpu_add[order].T)  # (N, B)
    cpu_t = np.zeros(B)
    stream_t = np.zeros(B * n_streams)
    stream_wait = np.zeros(B * n_streams)
    event_t = np.zeros(B * en)                   # op-id slots; slot N is
    post_t = np.zeros(B * 2 * n_chan)            # the 0.0 pad sentinel
    sync = T.sync_op_s

    for i in range(N):
        # CES-b4-op: host blocks on every GPU predecessor's event.
        m = ces.rows[i]
        if m.size:
            cpu_t[m] += sync
            ev = event_t[ces_ev[i]]              # (k, P); pads read 0.0
            cpu_t[m] = np.maximum(cpu_t[m], ev.max(axis=1))

        # CSWE-b4-op: op's stream waits on cross-stream pred events.
        m = cswe.rows[i]
        if m.size:
            cpu_t[m] += sync
            floor = event_t[cswe_ev[i]].max(axis=1)
            idx = cswe_sidx[i]
            stream_wait[idx] = np.maximum(stream_wait[idx], floor)

        # The op itself: one fused host-clock add (launch overhead for
        # GPU, duration for CPU), then kind/role-specific effects.
        cpu_t += cpu_add_t[i]
        m = gpu.rows[i]
        if m.size:
            idx = gpu_sidx[i]
            start = np.maximum(np.maximum(cpu_t[m], stream_t[idx]),
                               stream_wait[idx])
            stream_wait[idx] = 0.0
            stream_t[idx] = start + gpu_dur[i]

        m = post.rows[i]
        if m.size:
            post_t[post_pidx[i]] = cpu_t[m]
        m = wait.rows[i]
        if m.size:
            arrived = np.maximum(post_t[wait_aidx[i]],
                                 post_t[wait_bidx[i]]) + wait_xf[i]
            cpu_t[m] = np.maximum(cpu_t[m], arrived)

        # CER-after-op: snapshot the producer stream's completion time.
        m = cer.rows[i]
        if m.size:
            event_t[cer_widx[i]] = stream_t[cer_sidx[i]]
            cpu_t[m] += sync

    return np.maximum(cpu_t, stream_t.reshape(B, n_streams).max(axis=1))


def simulate_batch(tables: GraphTables,
                   schedules: Sequence[Schedule]) -> np.ndarray:
    """Makespans for a batch of complete valid schedules, bit-identical
    to per-schedule :func:`repro_torch.core.costmodel.simulate`."""
    T = tables
    n = T.n_ops
    encoded = np.empty((len(schedules), 2, n), dtype=np.int32)
    op_id = T.op_id
    for b, sched in enumerate(schedules):
        items = sched.items
        if len(items) != n:
            raise ValueError(
                f"schedule has {len(items)} items, graph has {n} ops")
        encoded[b, 0, :] = [op_id[i.name] for i in items]
        encoded[b, 1, :] = [-1 if i.stream is None else i.stream
                            for i in items]
    return simulate_encoded(tables, encoded)


class VectorizedEvaluator(EvaluatorBase):
    """Evaluation backend running :func:`simulate_batch` on all cache
    misses of a batch at once."""

    backend = "vectorized"

    def __init__(self, graph: Graph, machine: Machine | None = None,
                 noise_sigma: float = 0.0, noise_seed: int = 0,
                 **base_kwargs):
        super().__init__(graph, machine, noise_sigma, noise_seed,
                         **base_kwargs)
        if self.graph is None:
            raise TypeError(
                "the vectorized backend simulates schedules of a "
                f"Graph; design space {self.space.name!r} has no graph "
                "(use backend='sim' for spaces with an analytic cost, "
                "or 'wallclock' for kernel runners)")
        self._tables = GraphTables(self.graph, self.machine,
                                   self._durations)

    def _measure_batch(self, schedules: Sequence[Schedule],
                       encoded: np.ndarray | None = None) -> list[float]:
        if encoded is None:
            return simulate_batch(self._tables, schedules).tolist()
        return simulate_encoded(self._tables, encoded).tolist()
