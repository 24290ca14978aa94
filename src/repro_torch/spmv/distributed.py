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
"""
from __future__ import annotations

import hashlib
from functools import cached_property
from typing import Callable

import numpy as np
import torch

from repro_torch.core.dag import (BoundOp, Graph, OpKind, Schedule,
                                  spmv_dag, validate_schedule)
from repro_torch.core.executor import (OpImpl, build_runner, host_wait,
                                       jit_runner, op_impl)
from repro_torch.device import resolve_device
from repro_torch.kernels.pack.ops import pack, pack_plain
from repro_torch.kernels.spmv.kernel import SLICE_ROWS
from repro_torch.kernels.spmv.ops import (BLOCK_N, WINDOW, SlicedEll,
                                          check_permutation, deal_blocks,
                                          ell_spmv_plain, sliced_matvec,
                                          sliced_operands)
from repro_torch.spmv.matrix import RankPartition, stack_partitions


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

    def _matvec(self, a: SlicedEll, x: torch.Tensor,
                out: torch.Tensor) -> torch.Tensor:
        if not self.use_kernel:
            return out.copy_(ell_spmv_plain(a.vals_t, a.cols_t, x, a.slice_k,
                                             a.perm))
        return sliced_matvec(a, x, out)

    def multiply_local(self, x: torch.Tensor) -> torch.Tensor:
        return self._matvec(self.local, x, self.yL)

    def multiply_remote(self, halo: torch.Tensor) -> torch.Tensor:
        return self._matvec(self.remote, halo, self.yR)

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
    graph, both without the host copies (what ``chip_smoke.py`` times).
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
