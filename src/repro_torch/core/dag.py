"""DAG program model (paper §III-A).

A CUDA+MPI program is a directed acyclic
graph whose vertices are operations and whose edges are dependencies.
Vertex types follow Table II of the paper:

  * ``CPU``       — synchronous host operation (e.g. posting an Isend,
                    an MPI_Wait, an optimizer bookkeeping step).
  * ``GPU``       — asynchronous device operation not yet bound to a stream.
  * ``BoundGPU``  — a GPU vertex assigned to execution stream ``s``
                    (represented here by :class:`BoundOp` with ``stream``).

Artificial ``start``/``end`` CPU vertices bracket the program.

An *implementation* of the program is a topological traversal of the DAG
plus a stream assignment for every GPU vertex (a :class:`Schedule`).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Iterable, Mapping


class OpKind(enum.Enum):
    CPU = "CPU"
    GPU = "GPU"
    # Sync ops are generated during schedule expansion (Table III), never
    # authored by users, but they are first-class items in feature vectors.
    SYNC = "SYNC"


class CommRole(enum.Enum):
    """Communication role of a CPU op (drives the cost model)."""

    NONE = "none"
    POST_SEND = "post_send"
    POST_RECV = "post_recv"
    WAIT_SEND = "wait_send"
    WAIT_RECV = "wait_recv"


@dataclasses.dataclass(frozen=True)
class Op:
    """A program operation (DAG vertex).

    Cost metadata feeds an analytic machine model; it is ignored by
    the search/labeling/rules pipeline, which only sees names and orderings.
    """

    name: str
    kind: OpKind
    flops: float = 0.0
    bytes_hbm: float = 0.0
    comm_bytes: float = 0.0
    comm_role: CommRole = CommRole.NONE
    # Optional fixed duration override (seconds); None -> derived from
    # flops/bytes by the machine model.
    duration: float | None = None

    def __str__(self) -> str:  # pragma: no cover - debugging nicety
        return self.name


@dataclasses.dataclass(frozen=True)
class BoundOp:
    """A schedule item: an op, bound to a stream if it is a GPU op."""

    name: str
    stream: int | None = None

    def __str__(self) -> str:  # pragma: no cover
        if self.stream is None:
            return self.name
        return f"{self.name}@s{self.stream}"


class Graph:
    """A DAG of :class:`Op` with explicit ``start``/``end`` vertices."""

    START = "start"
    END = "end"

    def __init__(self) -> None:
        self.ops: dict[str, Op] = {}
        self.preds: dict[str, set[str]] = {}
        self.succs: dict[str, set[str]] = {}
        # Bumped on every mutation; derived-table caches (e.g. the sync
        # expansion tables in repro_torch.core.sync) key on it so a graph
        # mutated after first use is never served stale data.
        self.version = 0
        self.add_op(Op(self.START, OpKind.CPU, duration=0.0))
        self.add_op(Op(self.END, OpKind.CPU, duration=0.0))

    # -- construction -----------------------------------------------------
    def add_op(self, op: Op) -> Op:
        if op.name in self.ops:
            raise ValueError(f"duplicate op name {op.name!r}")
        self.version += 1
        self.ops[op.name] = op
        self.preds[op.name] = set()
        self.succs[op.name] = set()
        return op

    def add_edge(self, u: str, v: str) -> None:
        if u not in self.ops or v not in self.ops:
            raise KeyError(f"unknown op in edge {u!r}->{v!r}")
        self.version += 1
        self.preds[v].add(u)
        self.succs[u].add(v)

    def finalize(self) -> "Graph":
        """Wire ``start``/``end`` so every vertex is on a start->end path."""
        interior = [n for n in self.ops if n not in (self.START, self.END)]
        for n in interior:
            if not self.preds[n]:
                self.add_edge(self.START, n)
            if not (self.succs[n] - {self.END}):
                self.succs[n].discard(self.END)
                self.preds[self.END].discard(n)
                self.add_edge(n, self.END)
        self._check_acyclic()
        return self

    # -- queries ----------------------------------------------------------
    def _check_acyclic(self) -> None:
        order = self.topological_order()
        if len(order) != len(self.ops):
            raise ValueError("graph has a cycle")

    def topological_order(self) -> list[str]:
        indeg = {n: len(p) for n, p in self.preds.items()}
        frontier = sorted(n for n, d in indeg.items() if d == 0)
        out: list[str] = []
        while frontier:
            n = frontier.pop(0)
            out.append(n)
            for s in sorted(self.succs[n]):
                indeg[s] -= 1
                if indeg[s] == 0:
                    frontier.append(s)
        return out

    def gpu_ops(self) -> list[str]:
        return [n for n, o in self.ops.items() if o.kind is OpKind.GPU]

    def eligible(self, scheduled: Iterable[str]) -> list[str]:
        """Vertices whose predecessors are all in ``scheduled``."""
        done = set(scheduled)
        out = []
        for n in self.ops:
            if n in done:
                continue
            if self.preds[n] <= done:
                out.append(n)
        return sorted(out)

    def n_vertices(self) -> int:
        return len(self.ops)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A complete implementation: traversal order + stream assignment."""

    items: tuple[BoundOp, ...]

    def order(self) -> tuple[str, ...]:
        return tuple(i.name for i in self.items)

    def streams(self) -> dict[str, int]:
        return {i.name: i.stream for i in self.items if i.stream is not None}

    def key(self) -> tuple:
        """Hashable identity (canonical under stream relabeling is enforced
        at construction time by the enumerator / MCTS expansion)."""
        return tuple((i.name, i.stream) for i in self.items)


def validate_schedule(graph: Graph, schedule: Schedule) -> None:
    """Raise if ``schedule`` is not a topological traversal of ``graph``."""
    seen: set[str] = set()
    for item in schedule.items:
        op = graph.ops.get(item.name)
        if op is None:
            raise ValueError(f"unknown op {item.name!r}")
        if not (graph.preds[item.name] <= seen):
            missing = graph.preds[item.name] - seen
            raise ValueError(f"{item.name!r} scheduled before preds {missing}")
        if op.kind is OpKind.GPU and item.stream is None:
            raise ValueError(f"GPU op {item.name!r} has no stream")
        if op.kind is not OpKind.GPU and item.stream is not None:
            raise ValueError(f"non-GPU op {item.name!r} bound to stream")
        seen.add(item.name)
    if seen != set(graph.ops):
        raise ValueError(f"schedule missing ops {set(graph.ops) - seen}")


def canonicalize_streams(items: Iterable[BoundOp]) -> tuple[BoundOp, ...]:
    """Relabel streams in first-use order (bijection canonical form).

    Two schedules that differ only by a bijection of stream names are the
    same implementation (paper §III-C2); the canonical form names streams
    0,1,2,... in order of first use.
    """
    mapping: dict[int, int] = {}
    out = []
    for it in items:
        if it.stream is None:
            out.append(it)
            continue
        if it.stream not in mapping:
            mapping[it.stream] = len(mapping)
        out.append(BoundOp(it.name, mapping[it.stream]))
    return tuple(out)


# ---------------------------------------------------------------------------
# The paper's demonstration workload: distributed SpMV (Fig. 3).
# ---------------------------------------------------------------------------

def spmv_dag(
    *,
    rows_per_rank: int = 150_000 // 4,
    nnz_per_rank: int = 1_500_000 // 4,
    local_frac: float = 0.5,
    value_bytes: int = 8,
    index_bytes: int = 4,
) -> Graph:
    """Build the SpMV op-DAG of Fig. 3c.

    Vertices (GPU ops are unbound; streams are an implementation choice):

      Pack (GPU)      gather x_L entries into per-neighbor send buffers
      PostSend (CPU)  MPI_Isend the packed buffers
      PostRecv (CPU)  MPI_Irecv into x_R
      WaitSend (CPU)  MPI_Wait on sends
      WaitRecv (CPU)  MPI_Wait on recvs
      yL (GPU)        y_L = A_L x_L   (local multiply)
      yR (GPU)        y_R = A_R x_R   (remote multiply, needs x_R)

    Edges: Pack->PostSend->WaitSend, PostRecv->WaitRecv->yR; yL independent.
    """
    nnz_local = nnz_per_rank * local_frac
    nnz_remote = nnz_per_rank * (1.0 - local_frac)
    # Remote x entries exchanged with neighbors: with a band of width n/4 and
    # contiguous row blocks, a rank needs ~half a block from each neighbor.
    halo_entries = rows_per_rank
    halo_bytes = halo_entries * value_bytes

    def spmv_bytes(nnz: float) -> float:
        # val + col index per nnz, x gather, y write (row ptr amortized).
        return nnz * (value_bytes + index_bytes + value_bytes) + \
            rows_per_rank * value_bytes

    g = Graph()
    g.add_op(Op("Pack", OpKind.GPU, flops=0.0,
                bytes_hbm=2 * halo_bytes + halo_entries * index_bytes))
    g.add_op(Op("PostSend", OpKind.CPU, comm_bytes=halo_bytes,
                comm_role=CommRole.POST_SEND))
    g.add_op(Op("PostRecv", OpKind.CPU, comm_bytes=halo_bytes,
                comm_role=CommRole.POST_RECV))
    g.add_op(Op("WaitSend", OpKind.CPU, comm_role=CommRole.WAIT_SEND))
    g.add_op(Op("WaitRecv", OpKind.CPU, comm_role=CommRole.WAIT_RECV))
    g.add_op(Op("yL", OpKind.GPU, flops=2 * nnz_local,
                bytes_hbm=spmv_bytes(nnz_local)))
    g.add_op(Op("yR", OpKind.GPU, flops=2 * nnz_remote,
                bytes_hbm=spmv_bytes(nnz_remote)))
    g.add_edge("Pack", "PostSend")
    g.add_edge("PostSend", "WaitSend")
    g.add_edge("PostRecv", "WaitRecv")
    g.add_edge("WaitRecv", "yR")
    # Deadlock-avoidance under SPMD symmetry: all ranks run the same
    # schedule, so WaitRecv before PostSend would have every rank blocking
    # on a message no rank has sent. Such traversals are not valid
    # implementations and are excluded from the design space.
    g.add_edge("PostSend", "WaitRecv")
    return g.finalize()


def spmv_dag_fine(
    *,
    rows_per_rank: int = 150_000 // 4,
    nnz_per_rank: int = 1_500_000 // 4,
    value_bytes: int = 8,
    index_bytes: int = 4,
) -> Graph:
    """Fine-grained SpMV DAG: per-neighbor Pack/Send/Recv vertices.

    The paper (§III-A) discusses this granularity trade-off — separate
    vertices per neighbor remove false dependencies ("not being able to
    send to rank 1 before the pack for rank 2 is completed") at the cost
    of a larger search space — but evaluates only the coarse DAG. This
    builder enables the ablation (EXPERIMENTS §Paper, granularity row).

    Two neighbors (left/right of the circulant band). Deadlock-avoidance
    under SPMD symmetry: our recv from the left neighbor is their
    right-send, i.e. our own PostSend_r's symmetric twin — so WaitRecv_l
    requires PostSend_r to have been posted (and vice versa).
    """
    halo_bytes = rows_per_rank * value_bytes / 2
    nnz_half = nnz_per_rank / 4  # remote split across two neighbors

    def spmv_bytes(nnz: float) -> float:
        return nnz * (2 * value_bytes + index_bytes) + \
            rows_per_rank * value_bytes

    g = Graph()
    for side in ("l", "r"):
        g.add_op(Op(f"Pack_{side}", OpKind.GPU,
                    bytes_hbm=2 * halo_bytes))
        g.add_op(Op(f"PostSend_{side}", OpKind.CPU,
                    comm_bytes=halo_bytes,
                    comm_role=CommRole.POST_SEND))
        g.add_op(Op(f"PostRecv_{side}", OpKind.CPU,
                    comm_bytes=halo_bytes,
                    comm_role=CommRole.POST_RECV))
        g.add_op(Op(f"WaitSend_{side}", OpKind.CPU,
                    comm_role=CommRole.WAIT_SEND))
        g.add_op(Op(f"WaitRecv_{side}", OpKind.CPU,
                    comm_role=CommRole.WAIT_RECV))
        g.add_edge(f"Pack_{side}", f"PostSend_{side}")
        g.add_edge(f"PostSend_{side}", f"WaitSend_{side}")
        g.add_edge(f"PostRecv_{side}", f"WaitRecv_{side}")
    g.add_op(Op("yL", OpKind.GPU, flops=2 * nnz_per_rank / 2,
                bytes_hbm=spmv_bytes(nnz_per_rank / 2)))
    g.add_op(Op("yR", OpKind.GPU, flops=2 * 2 * nnz_half,
                bytes_hbm=spmv_bytes(2 * nnz_half)))
    g.add_edge("WaitRecv_l", "yR")
    g.add_edge("WaitRecv_r", "yR")
    g.add_edge("PostSend_r", "WaitRecv_l")   # symmetric-twin rendezvous
    g.add_edge("PostSend_l", "WaitRecv_r")
    return g.finalize()


def halo3d_dag(
    *,
    local_extent: int = 128,
    halo_width: int = 2,
    value_bytes: int = 8,
    flops_per_cell: float = 8.0,
) -> Graph:
    """3-D halo-exchange stencil DAG — the paper's named future-work
    direction (§VI: "currently being extended to 3D halo-exchange
    communication modeling fine-grained communication operations in
    each dimension").

    Per face f in {xn, xp, yn, yp, zn, zp}: Pack_f (GPU) -> PostSend_f
    -> WaitSend_f and PostRecv_f -> WaitRecv_f -> Bnd_f (the face's
    boundary stencil update). Inner (GPU) is the halo-independent bulk
    update, free to overlap all communication. Symmetric-twin
    rendezvous edges (PostSend_xp -> WaitRecv_xn etc.) exclude
    SPMD-deadlocking traversals.
    """
    n = local_extent
    face_cells = n * n * halo_width
    face_bytes = face_cells * value_bytes

    g = Graph()
    g.add_op(Op("Inner", OpKind.GPU,
                flops=flops_per_cell * (n - 2 * halo_width) ** 3,
                bytes_hbm=2 * value_bytes * n ** 3))
    faces = ("xn", "xp", "yn", "yp", "zn", "zp")
    for f in faces:
        g.add_op(Op(f"Pack_{f}", OpKind.GPU,
                    bytes_hbm=2 * face_bytes))
        g.add_op(Op(f"PostSend_{f}", OpKind.CPU,
                    comm_bytes=face_bytes,
                    comm_role=CommRole.POST_SEND))
        g.add_op(Op(f"PostRecv_{f}", OpKind.CPU,
                    comm_bytes=face_bytes,
                    comm_role=CommRole.POST_RECV))
        g.add_op(Op(f"WaitSend_{f}", OpKind.CPU,
                    comm_role=CommRole.WAIT_SEND))
        g.add_op(Op(f"WaitRecv_{f}", OpKind.CPU,
                    comm_role=CommRole.WAIT_RECV))
        g.add_op(Op(f"Bnd_{f}", OpKind.GPU,
                    flops=flops_per_cell * face_cells,
                    bytes_hbm=3 * face_bytes))
        g.add_edge(f"Pack_{f}", f"PostSend_{f}")
        g.add_edge(f"PostSend_{f}", f"WaitSend_{f}")
        g.add_edge(f"PostRecv_{f}", f"WaitRecv_{f}")
        g.add_edge(f"WaitRecv_{f}", f"Bnd_{f}")
    twin = {"xn": "xp", "xp": "xn", "yn": "yp", "yp": "yn",
            "zn": "zp", "zp": "zn"}
    for f in faces:
        g.add_edge(f"PostSend_{twin[f]}", f"WaitRecv_{f}")
    return g.finalize()
