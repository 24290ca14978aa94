"""Launch wrappers of the hand-written AdamW kernels (csrc/adamw.cu).

Replaces no Pallas kernel: the JAX package's optimizer is ``jnp`` that
XLA fuses. :func:`sumsq` gives each leaf's sum of squares of its
gradient and their sum, :func:`update` updates one leaf's parameter,
moments and master copy in place; both launch on the current stream and
do not synchronise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels._launch import (FLOAT_SUFFIX, check_cuda_args,
                                         stream_handle)

# Blocks of csrc/adamw.cu's 256 threads: at most 8 a streaming
# multiprocessor on the H100's 132, so a grid-stride loop keeps the card
# full; each leaf's sum of squares keeps one float64 partial a block.
THREADS = 256
MAX_BLOCKS = 8 * 132
_VEC_BYTES = 16
_fns: dict = {}


def _fn(name: str, n_ptr: int, n_int: int, n_float: int = 0):
    fn = _fns.get(name)
    if fn is None:
        fn = _fns[name] = build.declare(build.library("adamw"), name, n_ptr,
                                        n_int, n_float)
    return fn


def _split(n: int, width: int, *tensors: torch.Tensor) -> tuple[int, int]:
    """(head, vectors): the first element at which every tensor's address
    is 16-byte aligned, and how many whole vectors of ``width`` elements
    follow it. Where no head below ``width`` aligns them all, every
    element goes one by one: (n, 0)."""
    for head in range(min(width, n + 1)):
        if all((t.data_ptr() + head * t.element_size()) % _VEC_BYTES == 0
               for t in tensors):
            return head, (n - head) // width
    return n, 0


def _blocks(work: int) -> int:
    return max(1, min(MAX_BLOCKS, -(-work // THREADS)))


def _dense(g: torch.Tensor) -> torch.Tensor:
    """A gradient in its parameter's element order (a non-contiguous one,
    a mesh's transposed local shard, copied)."""
    return g if g.is_contiguous() else g.contiguous()


def _check_count(what: str, n: int) -> None:
    if n >= 2 ** 31:
        raise ValueError(f"{what}: a leaf must have fewer than 2**31 "
                         f"elements, got {n}")


def sumsq(gs: list[torch.Tensor]) -> torch.Tensor:
    """``out[k]`` = sum of ``gs[k]``'s squares, float32, and ``out[L]``
    = those L sums added in order, from 0. Each gradient float32 or
    bfloat16, all on one CUDA device. Deterministic: the same gradients
    give the same bits."""
    for g in gs:
        if g.dtype not in FLOAT_SUFFIX:
            raise TypeError(f"adamw sumsq: gradients must be float32 or "
                            f"bfloat16, got {g.dtype}")
        _check_count("adamw sumsq", g.numel())
    gs = [_dense(g) for g in gs]
    check_cuda_args("adamw sumsq", *gs)
    dev = gs[0].device
    stream = stream_handle(dev)
    partials = torch.zeros(len(gs) * MAX_BLOCKS, dtype=torch.float64,
                           device=dev)
    out = torch.empty(len(gs) + 1, dtype=torch.float32, device=dev)
    base = partials.data_ptr()
    for k, g in enumerate(gs):
        n = g.numel()
        if n == 0:
            continue
        width = _VEC_BYTES // g.element_size()
        head, nvec = _split(n, width, g)
        fn = _fn(f"adamw_sumsq_{FLOAT_SUFFIX[g.dtype]}", 2, 4)
        err = fn(g.data_ptr(), base + k * MAX_BLOCKS * 8, n, head, nvec,
                 _blocks(max(nvec, n - nvec * width)), stream)
        build.check(err, "adamw sumsq")
        sumsq.launches += 1
    fn = _fn("adamw_sumsq_finish", 2, 2)
    build.check(fn(base, out.data_ptr(), MAX_BLOCKS, len(gs), stream),
                "adamw sumsq finish")
    sumsq.launches += 1
    return out


sumsq.launches = 0


def update_function(p: torch.Tensor, g: torch.Tensor,
                    master: torch.Tensor | None) -> str:
    """The exported C function for these dtypes, or TypeError: float32
    parameters, or float32 or bfloat16 ones with a float32 master copy;
    float32 or bfloat16 gradients. Reads only dtypes (no card needed)."""
    if g.dtype not in FLOAT_SUFFIX or p.dtype not in FLOAT_SUFFIX or (
            p.dtype != torch.float32 and master is None) or (
            master is not None and master.dtype != torch.float32):
        raise TypeError(
            "adamw update: takes float32 parameters, or float32/bfloat16 "
            "ones with a float32 master copy, and float32 or bfloat16 "
            f"gradients; got parameter {p.dtype}, gradient {g.dtype}, "
            f"master {None if master is None else master.dtype}")
    return (f"adamw_update_p{FLOAT_SUFFIX[p.dtype]}_"
            f"g{FLOAT_SUFFIX[g.dtype]}" + ("" if master is None
                                           else "_master"))


def update(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
           nu: torch.Tensor, master: torch.Tensor | None,
           scale: torch.Tensor | None, bc1: torch.Tensor,
           bc2: torch.Tensor, lr: torch.Tensor, *, b1: float, b2: float,
           eps: float, weight_decay: float) -> None:
    """One leaf's AdamW update in place (csrc/adamw.cu's arithmetic):
    ``mu``, ``nu``, ``master`` (when given) and ``p``. ``scale`` (None:
    no clip), ``bc1``, ``bc2`` and ``lr`` are float32 scalars on the
    card, read there."""
    name = update_function(p, g, master)
    if mu.dtype != torch.float32 or nu.dtype != torch.float32:
        raise TypeError(f"adamw update: moments must be float32, got "
                        f"{mu.dtype}/{nu.dtype}")
    state = [p, mu, nu] + ([] if master is None else [master])
    if any(t.shape != p.shape for t in (g, *state)):
        raise ValueError("adamw update: parameter, gradient, moments and "
                         "master copy must have one shape, got " + str(
                             [tuple(t.shape) for t in (g, *state)]))
    _check_count("adamw update", p.numel())
    g = _dense(g)
    scalars = [s for s in (scale, bc1, bc2, lr) if s is not None]
    if any(s.dtype != torch.float32 or s.numel() != 1 for s in scalars):
        raise TypeError("adamw update: scale, bc1, bc2 and lr must be "
                        "float32 scalars")
    check_cuda_args("adamw update", g, *state, *scalars)
    n = p.numel()
    if n == 0:
        return
    width = 4 if all(t.element_size() == 4 for t in (p, g)) else 8
    head, nvec = _split(n, width, g, *state)
    err = _fn(name, 9, 4, 6)(
        p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(),
        None if master is None else master.data_ptr(),
        None if scale is None else scale.data_ptr(), bc1.data_ptr(),
        bc2.data_ptr(), lr.data_ptr(), n, head, nvec,
        _blocks(max(nvec, n - nvec * width)), b1, 1 - b1, b2, 1 - b2, eps,
        weight_decay, stream_handle(p.device))
    build.check(err, "adamw update")
    update.launches += 1


update.launches = 0
