"""The paper's distributed SpMV on one device, one process playing R ranks.

One H100 cannot host several NCCL ranks, so all R ranks' buffers live on
the one card and the halo exchange is device-to-device copies on a
dedicated comm stream. Each rank's halo is [left block, right block]
(the JAX package's ``_halo_exchange``): rank r sends its x block to its
right neighbour's left slot and to its left neighbour's right slot.

One launch per DAG op covers all ranks: the ranks' ELL arrays are
stacked K-major over the rank-major row axis, local columns offset by
``rank * m`` into the whole x and halo columns by ``rank * 2m`` into
the stacked halo buffer, once, at set-up. The DAG's vertices
(:func:`repro_torch.core.dag.spmv_dag`) then map to:

    Pack      pack kernel: each rank's send buffer from its x block
    PostSend  enqueue the 2R halo copies on the comm stream, record an
              event (the host does not wait)
    PostRecv  nothing: the halo buffer is preallocated
    WaitSend  :func:`~repro_torch.core.executor.host_wait` on the
              copies (the host blocks; in a CUDA graph the host chain's
              stream waits)
    WaitRecv  the same: in one process our receives are the
              neighbours' sends, i.e. those very copies
    yL        ELL SpMV kernel over the local parts
    yR        ELL SpMV kernel over the halo parts

and y = yL + yR. :func:`make_distributed_spmv` runs one of the JAX
package's two orderings (:func:`ordering`): the local multiply issued
while the halo copies are in flight, or after the remote one. Both
products read the sorted-slice layout
(:func:`repro_torch.kernels.spmv.ops.sliced_operands`), its CTAs' row
blocks dealt out rank by rank (:func:`~repro_torch.kernels.spmv.ops.
deal_blocks`), built once at set-up with a permutation of its own for
each part: a row's local and remote lengths add up to its whole, so
they sort differently. Every buffer is allocated once here, so no op
allocates memory that crosses streams, and none of them synchronises
beyond what its vertex means: ordering comes from the schedule's sync
items alone.

The JAX package's own form is one body per rank under ``shard_map``
(``spmv_shard`` over the mesh axis :data:`AXIS`), and so is this
module's second one, the MPI program the paper studies: one process per
rank, each with its own device, over a ``torch.distributed`` group.
:func:`halo_exchange` is the reference's ``_halo_exchange`` (two
``ppermute`` shifts) as one ``batch_isend_irecv``; :func:`spmv_shard`
is the reference's body; :func:`make_rank_spmv` runs it on one rank's
:class:`~repro_torch.spmv.matrix.RankPartition` in the sorted-slice
layout, with its buffers allocated once. On NCCL a wait makes the
current stream wait on the transfer and leaves the host free, so the
local product issued before it can run while the halo is in flight.
"""
from __future__ import annotations

import hashlib
from functools import cached_property
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.dag import (BoundOp, Graph, OpKind, Schedule,
                                  spmv_dag, validate_schedule)
from repro_torch.core.executor import (OpImpl, build_runner, host_wait,
                                       jit_runner, op_impl)
from repro_torch.device import resolve_device
from repro_torch.kernels.pack.ops import pack, pack_plain
from repro_torch.kernels.spmv.kernel import SLICE_ROWS
from repro_torch.kernels.spmv.ops import (BLOCK_N, WINDOW, SlicedEll,
                                          check_permutation, deal_blocks,
                                          ell_matvec, ell_spmv_plain,
                                          sliced_matvec, sliced_operands)
from repro_torch.spmv.matrix import (EllMatrix, RankPartition,
                                     stack_partitions)

# The 1-D mesh dimension whose group carries the halo exchange.
AXIS = "ranks"


def _sliced_product(a: SlicedEll, x: torch.Tensor, out: torch.Tensor,
                   use_kernel: bool = True) -> torch.Tensor:
    """``out`` = ``a`` x ``x`` in the sorted-slice layout: the kernel on a
    card, or with ``use_kernel=False`` its plain version on the same
    device (the JAX package's ``ell_matvec_ref``); the plain version on
    the CPU either way."""
    if not use_kernel:
        return out.copy_(ell_spmv_plain(a.vals_t, a.cols_t, x, a.slice_k,
                                        a.perm))
    return sliced_matvec(a, x, out)


class DistributedSpmv:
    """Device state of the R-rank SpMV and the DAG's op implementations.

    Build it with :func:`from_reference`. ``x`` is the input the ops
    read; ``sendbuf``, ``halo``, ``yL`` and ``yR`` are written by them.
    With ``use_kernel=False`` Pack, yL and yR run the kernels' plain
    PyTorch versions on the same operands and device (the JAX package's
    ``ell_matvec_ref``); on the CPU both take the plain versions.
    """

    def __init__(self, local: SlicedEll, remote: SlicedEll,
                 x: torch.Tensor, n_ranks: int, use_kernel: bool = True):
        n, dev = x.numel(), x.device
        for part in (local, remote):
            check_permutation(part.perm, n)
        self.device = dev
        self.n_ranks = n_ranks
        self.use_kernel = use_kernel
        self.m = n // n_ranks
        self.local = local
        self.remote = remote
        self.x = x
        # Each rank sends its whole block (half-bandwidth == m); the
        # kernel takes any index set.
        self.send_idx = torch.arange(n, dtype=torch.int32, device=dev)
        self.sendbuf = torch.empty(n, dtype=x.dtype, device=dev)
        self.halo = torch.empty(2 * n, dtype=x.dtype, device=dev)
        self.yL = torch.empty(n, dtype=torch.float32, device=dev)
        self.yR = torch.empty(n, dtype=torch.float32, device=dev)
        # High priority: drawn from another pool than the executor's
        # schedule streams, so a copy never lands on a compute stream
        # (which would order it after Pack without any sync).
        self.comm = torch.cuda.Stream(device=dev, priority=-1) \
            if dev.type == "cuda" else None

    @cached_property
    def store_tag(self) -> str:
        """What this program multiplies, for an evaluator's ``store_tag=``:
        n, the non-zero values, the ranks, the value dtype, the layout's
        constants and a digest of both parts' operands (values, columns,
        slice widths, permutation), so that schedule times of two
        matrices never share a store address, even at one size. Copies
        the operands to the host once."""
        digest = hashlib.sha256()
        nnz = 0
        for part in (self.local, self.remote):
            nnz += int((part.vals_t != 0).sum())
            for t in part:
                digest.update(t.detach().cpu().contiguous().numpy().tobytes())
        return (f"spmv:n={self.x.numel()}:nnz={nnz}:ranks={self.n_ranks}:"
                f"dtype={str(self.local.vals_t.dtype).removeprefix('torch.')}"
                f":window={WINDOW}:block_n={BLOCK_N}:slice_rows={SLICE_ROWS}"
                f":operands={digest.hexdigest()[:16]}")

    def poison(self) -> None:
        """Fill every buffer the ops write with NaN, so that a run that
        reads before a write cannot pass on an earlier run's values."""
        for t in (self.sendbuf, self.halo, self.yL, self.yR):
            t.fill_(float("nan"))

    # -- the DAG's ops -------------------------------------------------------
    def pack(self, x: torch.Tensor) -> torch.Tensor:
        if not self.use_kernel:
            return self.sendbuf.copy_(pack_plain(x, self.send_idx))
        return pack(x, self.send_idx, out=self.sendbuf)

    def post_send(self, sendbuf: torch.Tensor):
        m, r_n = self.m, self.n_ranks
        blocks = sendbuf.view(r_n, m)
        halo = self.halo.view(r_n, 2, m)

        def copies() -> None:
            for r in range(r_n):
                halo[(r + 1) % r_n, 0].copy_(blocks[r], non_blocking=True)
                halo[(r - 1) % r_n, 1].copy_(blocks[r], non_blocking=True)

        if self.comm is None:
            copies()
            return None
        if torch.cuda.is_current_stream_capturing():
            # The graph's form of "the host issues the copies after its
            # CES": the comm stream joins the host chain here. An eager
            # run adds no sync: the host issued them after it waited.
            self.comm.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.comm):
            copies()
        done = torch.cuda.Event()
        done.record(self.comm)
        return done

    def post_recv(self) -> torch.Tensor:
        return self.halo

    @staticmethod
    def wait(done) -> None:
        host_wait(done)

    def wait_recv(self, done, halo: torch.Tensor) -> torch.Tensor:
        self.wait(done)
        return halo

    def multiply_local(self, x: torch.Tensor) -> torch.Tensor:
        return _sliced_product(self.local, x, self.yL, self.use_kernel)

    def multiply_remote(self, halo: torch.Tensor) -> torch.Tensor:
        return _sliced_product(self.remote, halo, self.yR, self.use_kernel)

    def impls(self) -> dict[str, OpImpl]:
        """Op implementations for the vertices of ``spmv_dag()``."""
        return {
            "Pack": op_impl(self.pack, ["x"], ["sendbuf"]),
            "PostSend": op_impl(self.post_send, ["sendbuf"], ["sent"]),
            "PostRecv": op_impl(self.post_recv, [], ["halo"]),
            "WaitSend": op_impl(self.wait, ["sent"], []),
            "WaitRecv": op_impl(self.wait_recv, ["sent", "halo"], ["xR"]),
            "yL": op_impl(self.multiply_local, ["x"], ["yL"]),
            "yR": op_impl(self.multiply_remote, ["xR"], ["yR"]),
        }

    def env(self) -> dict:
        """The runner's initial environment."""
        return {"x": self.x}


def from_reference(stacked: dict[str, np.ndarray], x: np.ndarray,
                   device: "str | torch.device | None" = None,
                   use_kernel: bool = True) -> DistributedSpmv:
    """Device state from :func:`repro_torch.spmv.matrix.stack_partitions`'
    arrays (leading rank axis, the JAX package's shard_map layout) and
    the global x (R*m,). Each part is stacked K-major with rank-offset
    columns, then put in the sorted-slice layout with its blocks dealt
    out rank by rank."""
    dev = resolve_device(device)
    r_n, m, _ = stacked["local_vals"].shape
    x = np.asarray(x, dtype=np.float32).reshape(-1)
    if x.size != r_n * m:
        raise ValueError(f"x has {x.size} entries, the partition "
                         f"{r_n} x {m} rows")
    rank = np.arange(r_n, dtype=np.int64)[:, None, None]

    def ell_t(vals: np.ndarray, cols: np.ndarray, width: int):
        if cols.size and (cols.min() < 0 or cols.max() >= width):
            raise ValueError(f"column index outside [0, {width})")
        k = vals.shape[2]
        gcols = (cols.astype(np.int64) + rank * width).astype(np.int32)
        return deal_blocks(sliced_operands(
            torch.from_numpy(np.ascontiguousarray(
                vals.reshape(r_n * m, k).T)).to(dev),
            torch.from_numpy(np.ascontiguousarray(
                gcols.reshape(r_n * m, k).T)).to(dev)), m)

    local = ell_t(stacked["local_vals"], stacked["local_cols"], m)
    remote = ell_t(stacked["remote_vals"], stacked["remote_cols"], 2 * m)
    return DistributedSpmv(local, remote, torch.from_numpy(x).to(dev), r_n,
                           use_kernel)


def ordering(graph: Graph, overlap_local: bool = True) -> Schedule:
    """The JAX package's two orderings of ``spmv_dag()`` (its
    ``spmv_shard``), every GPU op on stream 0.

    ``overlap_local``: yL is issued after PostSend and PostRecv and
    before the waits, so the local multiply runs while the halo copies
    are in flight (the paper's fast class). Otherwise the remote path
    comes first: the waits, yR, then yL.
    """
    tail = (("yL", "WaitSend", "WaitRecv", "yR") if overlap_local
            else ("WaitSend", "WaitRecv", "yR", "yL"))
    sched = Schedule(tuple(
        BoundOp(n, 0 if graph.ops[n].kind is OpKind.GPU else None)
        for n in ("start", "Pack", "PostSend", "PostRecv", *tail, "end")))
    validate_schedule(graph, sched)
    return sched


def make_distributed_spmv(parts: list[RankPartition],
                          device: "str | torch.device | None" = None, *,
                          use_kernel: bool = True,
                          overlap_local: bool = True
                          ) -> Callable[[np.ndarray], np.ndarray]:
    """``run(x) -> y`` for the partitioned matrix: one direct SpMV step.

    Runs :func:`ordering`'s schedule compiled, as the JAX package
    jit-compiles its step: :func:`~repro_torch.core.executor.jit_runner`
    captures it into a CUDA graph on the first call and replays it on
    later ones. Returns y = yL + yR on the host. ``use_kernel=False``
    multiplies and packs with the kernels' plain versions on ``device``
    (the JAX package's ``ell_matvec_ref``); otherwise a card launches
    the kernels, and one that fails to build or launch raises.
    ``run.spmv`` is the device state; ``run.step()`` is one step on its
    ``x`` through the eager runner and ``run.replay()`` one through the
    graph, both without the host copies (what a timing loop calls).
    """
    r_n, m = len(parts), parts[0].m
    spmv = from_reference(stack_partitions(parts),
                          np.zeros(r_n * m, np.float32), device, use_kernel)
    g = spmv_dag()
    sched = ordering(g, overlap_local)
    runner = build_runner(g, sched, spmv.impls(), spmv.device)
    compiled = jit_runner(g, sched, spmv.impls(), spmv.device)
    cuda = spmv.device.type == "cuda"

    def step() -> dict:
        return runner(spmv.env())

    def replay() -> dict:
        return compiled(spmv.env())

    def run(x: np.ndarray) -> np.ndarray:
        spmv.x.copy_(torch.from_numpy(
            np.asarray(x, dtype=np.float32).reshape(-1)))
        if cuda:
            torch.cuda.synchronize(spmv.device)
        env = replay()
        if cuda:
            torch.cuda.synchronize(spmv.device)
        return (env["yL"] + env["yR"]).cpu().numpy()

    run.spmv, run.step, run.replay = spmv, step, replay
    return run


# -- one process per rank ------------------------------------------------------

def halo_exchange(x_block: torch.Tensor, group=None,
                  out: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, list]:
    """Start the exchange of this rank's ``x_block`` (m,) over ``group``
    (the default group when None): the JAX package's ``_halo_exchange``.

    Returns ``(halo, works)``. Once every work has been waited on, halo
    (2m,) (``out`` when given) holds [the left neighbour's block, the
    right neighbour's block], left as in the reference: its shift
    i -> i+1 means rank j receives from j-1. Both shifts go in one
    ``batch_isend_irecv``, each with a tag of its own, so that in a
    world of two, where both neighbours are one peer, gloo (by tag) and
    NCCL (by order in the batch) put each block in its slot. In a world
    of one the halo is [x_block, x_block], copied (``ppermute`` over an
    axis of one is the identity; torch refuses a send to self), and
    there is nothing to wait on. The first point-to-point call of a group
    must involve every rank of it.
    """
    m = x_block.numel()
    halo = out if out is not None else torch.empty(
        2 * m, dtype=x_block.dtype, device=x_block.device)
    from_left, from_right = halo[:m], halo[m:]
    n = dist.get_world_size(group)
    if n == 1:
        from_left.copy_(x_block)
        from_right.copy_(x_block)
        return halo, []
    rank = dist.get_rank(group)
    whole = dist.group.WORLD if group is None else group
    left = dist.get_global_rank(whole, (rank - 1) % n)
    right = dist.get_global_rank(whole, (rank + 1) % n)
    return halo, dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x_block, right, group, tag=0),
        dist.P2POp(dist.irecv, from_left, left, group, tag=0),
        dist.P2POp(dist.isend, x_block, left, group, tag=1),
        dist.P2POp(dist.irecv, from_right, right, group, tag=1)])


def _wait(works: list) -> None:
    """On NCCL the current stream waits on the transfer (the host does
    not); on gloo the host waits."""
    for work in works:
        work.wait()


def _ordered(exchange: Callable, multiply_local: Callable,
             multiply_remote: Callable, overlap_local: bool
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One step in one of the JAX package's two orderings: (yL, yR)."""
    halo, works = exchange()
    if overlap_local:
        y_local = multiply_local()
        _wait(works)
        return y_local, multiply_remote(halo)
    _wait(works)
    y_remote = multiply_remote(halo)
    return multiply_local(), y_remote


def spmv_shard(local_vals: torch.Tensor, local_cols: torch.Tensor,
               remote_vals: torch.Tensor, remote_cols: torch.Tensor,
               x_block: torch.Tensor, *, use_kernel: bool = True,
               overlap_local: bool = True, group=None) -> torch.Tensor:
    """One rank's distributed SpMV step: the JAX package's per-shard body.

    Row-major ELL operands (m, K): local columns index ``x_block`` (m,),
    remote ones the halo (2m,). ``overlap_local``: start the exchange,
    multiply the local part while it is in flight, then wait and multiply
    the remote part; otherwise exchange, wait, remote, then local. The
    products are :func:`~repro_torch.kernels.spmv.ops.ell_matvec` (the
    kernel on a card), or with ``use_kernel=False`` its plain version on
    the same device. ``group`` is the reference's ``axis``: None is the
    default group. Returns y_block = yL + yR, float32 (m,).
    """
    def multiply(vals, cols, x):
        if use_kernel:
            return ell_matvec(vals, cols, x)
        return ell_spmv_plain(vals.T, cols.T, x)

    y_local, y_remote = _ordered(
        lambda: halo_exchange(x_block, group),
        lambda: multiply(local_vals, local_cols, x_block),
        lambda halo: multiply(remote_vals, remote_cols, halo),
        overlap_local)
    return y_local + y_remote


def rank_device(n_ranks: int, device: "str | torch.device | None" = None
                ) -> torch.device:
    """The device of one rank's process: a card unless the caller asks
    for the CPU. Raises where CUDA is asked for and absent, and where a
    group of ``n_ranks`` would need more cards than the machine has
    (one card a rank: NCCL refuses two ranks on one device)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and n_ranks > torch.cuda.device_count():
        raise RuntimeError(
            f"a group of {n_ranks} ranks needs {n_ranks} cards, one a "
            f"rank; this machine has {torch.cuda.device_count()}")
    return dev


def _rank_operands(part: EllMatrix, width: int,
                   dev: torch.device) -> SlicedEll:
    """One part of a rank's matrix in the sorted-slice layout on ``dev``;
    its columns must index a vector of ``width``."""
    if part.cols.size and (part.cols.min() < 0 or part.cols.max() >= width):
        raise ValueError(f"column index outside [0, {width})")
    return sliced_operands(
        torch.from_numpy(np.ascontiguousarray(part.vals.T)).to(dev),
        torch.from_numpy(np.ascontiguousarray(part.cols.T)).to(dev))


def make_rank_spmv(part: RankPartition, mesh: DeviceMesh,
                   device: "str | torch.device | None" = None, *,
                   use_kernel: bool = True, overlap_local: bool = True
                   ) -> Callable[[np.ndarray], np.ndarray]:
    """``run(x_block) -> y_block`` for this process's rank of the
    distributed SpMV: the JAX package's ``make_distributed_spmv`` as the
    program of one rank.

    ``mesh`` is 1-D over :data:`AXIS`, one process a rank
    (``init_device_mesh(dev.type, (R,), mesh_dim_names=(AXIS,))``), and
    ``part`` is this rank's :func:`~repro_torch.spmv.matrix.partition`
    entry. The
    device is this process's current card unless the caller asks for the
    CPU; the mesh must be of its type and, on a card, over NCCL. Nothing
    falls back: a group of more ranks than cards raises, and so does a
    kernel that fails to build or launch. The operands are put on the
    device once, in the sorted-slice layout, and the halo and outputs
    allocated once; one exchange at set-up is the group's first
    point-to-point call (every rank makes it; NCCL connects there).
    ``run.step()`` is one step on the device's ``x`` without host copies
    or a sync (what a timing loop calls); it returns y on the device.
    """
    n_ranks = mesh.size()
    dev = rank_device(n_ranks, device)
    if mesh.mesh_dim_names != (AXIS,):
        raise ValueError(f"the mesh's dimensions are {mesh.mesh_dim_names}"
                         f", not ({AXIS!r},)")
    if mesh.device_type != dev.type:
        raise ValueError(f"the mesh is on {mesh.device_type}, the data on "
                         f"{dev.type}")
    group = mesh.get_group(AXIS)
    if dev.type == "cuda":
        if dist.get_backend(group) != "nccl":
            raise ValueError(f"a card's ranks exchange over NCCL, not "
                             f"{dist.get_backend(group)}")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    rank = mesh.get_local_rank(AXIS)
    if (part.rank, part.n_ranks) != (rank, n_ranks):
        raise ValueError(f"rank {rank} of {n_ranks} was given the part of "
                         f"rank {part.rank} of {part.n_ranks}")
    m = part.m
    local = _rank_operands(part.local, m, dev)
    remote = _rank_operands(part.remote, 2 * m, dev)
    x = torch.zeros(m, dtype=torch.float32, device=dev)
    halo = torch.empty(2 * m, dtype=torch.float32, device=dev)
    y_local, y_remote, y = (torch.empty(m, dtype=torch.float32, device=dev)
                            for _ in range(3))

    def step() -> torch.Tensor:
        yl, yr = _ordered(
            lambda: halo_exchange(x, group, out=halo),
            lambda: _sliced_product(local, x, y_local, use_kernel),
            lambda h: _sliced_product(remote, h, y_remote, use_kernel),
            overlap_local)
        return torch.add(yl, yr, out=y)

    _wait(halo_exchange(x, group, out=halo)[1])

    def run(x_block: np.ndarray) -> np.ndarray:
        x.copy_(torch.from_numpy(
            np.asarray(x_block, dtype=np.float32).reshape(-1)))
        return step().cpu().numpy()

    run.step, run.group = step, group
    return run
