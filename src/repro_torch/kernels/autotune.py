"""Parameter design spaces for the port's hand-written kernels.

The block sizes of :mod:`repro_torch.kernels` become searchable
:class:`~repro_torch.space.params.ParamSpace` instances, evaluated
through the param-space ``wallclock`` backend
(:class:`repro_torch.engine.params.KernelWallclockEvaluator`: value gate
against the kernel's reference, batch-ahead first calls, persistent
:class:`~repro_torch.engine.store.EvalStore` warm starts) and distilled
into block-size design rules by :func:`repro_torch.rules.distill`.

Each factory closes the kernel over one fixed, seeded problem instance
drawn from ``np.random.default_rng(seed)`` in the same order as the JAX
package's factory (``repro/kernels/autotune.py``), so for the same
arguments both packages measure the same problem; the instance's shape
and seed go into the ``signature`` hashed by the store fingerprint. The
grids are the card's own:

  * ``flash_attention`` — ``(block_q, block_k)``: query rows per CTA and
    KV rows per shared-memory tile;
  * ``spmv_mulsum`` — ``block_n``: rows (threads) per CTA of the ELL
    SpMV, run on the K-major operands the kernel reads;
  * ``pack`` — ``block_c``: outputs (threads) per CTA. The TPU grid's
    ``chunk`` (the one-hot x-chunk) has no counterpart on a card that
    gathers, so the space has no such dimension and its signature says
    so.

``device=None`` means CUDA (and raises without it); the CPU runs the
plain versions.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.space.params import KernelRunner, ParamSpace

__all__ = ["flash_attention_space", "spmv_mulsum_space", "pack_space"]


def _divisors_of(seq: int, values) -> tuple[int, ...]:
    out = tuple(int(v) for v in values if seq % int(v) == 0)
    if not out:
        raise ValueError(
            f"no candidate block size in {tuple(values)} divides "
            f"sequence length {seq}")
    return out


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(a).to(dev)


def flash_attention_space(*, batch: int = 1, heads: int = 2,
                          seq: int = 128, head_dim: int = 64,
                          block_values=(16, 32, 64, 128),
                          causal: bool = True, seed: int = 0,
                          device=None) -> ParamSpace:
    """(block_q, block_k) grid for :func:`repro_torch.kernels.
    flash_attention.ops.mha` on one seeded float32 self-attention
    instance.

    Block values are filtered to divisors of ``seq`` so the padded and
    unpadded paths measure the same problem (and causal right-aligned
    masking needs equal q/kv padding anyway).
    """
    from repro_torch.kernels.flash_attention.ops import mha
    from repro_torch.kernels.flash_attention.ref import attention_ref

    dev = resolve_device(device)
    blocks = _divisors_of(seq, block_values)
    rng = np.random.default_rng(seed)
    shape = (batch, heads, seq, head_dim)
    q = _tensor(rng.standard_normal(shape).astype(np.float32), dev)
    k = _tensor(rng.standard_normal(shape).astype(np.float32), dev)
    v = _tensor(rng.standard_normal(shape).astype(np.float32), dev)

    def build(params: dict):
        bq, bk = params["block_q"], params["block_k"]

        def run():
            return mha(q, k, v, causal=causal, block_q=bq, block_k=bk)
        return run

    return ParamSpace(
        "flash_attention",
        [("block_q", blocks), ("block_k", blocks)],
        runner=KernelRunner(
            build=build,
            reference=lambda: attention_ref(q, k, v, causal=causal)),
        signature=(f"mha:b={batch}:h={heads}:sq={seq}:skv={seq}:"
                   f"d={head_dim}:causal={causal}:dtype=float32:"
                   f"seed={seed}"))


def spmv_mulsum_space(*, n: int = 1024, k: int = 8,
                      block_values=(64, 128, 256, 512),
                      seed: int = 0, device=None) -> ParamSpace:
    """block_n grid for the ELL SpMV (:func:`repro_torch.kernels.spmv.
    ops.ell_matvec_t`) on one seeded matrix with uniform columns.

    The operands are transposed once, to the K-major layout the kernel
    reads; the JAX factory's wrapper gathered and transposed on every
    call. The space keeps the JAX factory's problem: every row padded to
    K, in row order. Its best block_n does not feed the distributed
    SpMV, which multiplies the sorted-slice layout at the fixed
    :data:`repro_torch.kernels.spmv.ops.BLOCK_N` that its dealt blocks
    are built for.
    """
    from repro_torch.kernels.spmv.ops import ell_matvec_t
    from repro_torch.kernels.spmv.ref import ell_matvec_ref

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    vals = _tensor(rng.standard_normal((n, k)).astype(np.float32), dev)
    cols = _tensor(rng.integers(0, n, size=(n, k)).astype(np.int32), dev)
    x = _tensor(rng.standard_normal(n).astype(np.float32), dev)
    vals_t, cols_t = vals.T.contiguous(), cols.T.contiguous()
    out = torch.empty(n, dtype=torch.float32, device=dev)

    def build(params: dict):
        bn = params["block_n"]

        def run():
            return ell_matvec_t(vals_t, cols_t, x, out=out, block_n=bn)
        return run

    return ParamSpace(
        "spmv_mulsum",
        [("block_n", tuple(int(v) for v in block_values))],
        runner=KernelRunner(
            build=build,
            reference=lambda: ell_matvec_ref(vals, cols, x)),
        signature=(f"ell_matvec:n={n}:k={k}:dtype=float32:"
                   f"seed={seed}"))


def pack_space(*, n: int = 4096, m: int = 512,
               block_c_values=(64, 128, 256),
               seed: int = 0, device=None) -> ParamSpace:
    """block_c grid for the pack (gather) kernel
    (:func:`repro_torch.kernels.pack.ops.pack`) on one seeded index
    set. No ``chunk`` dimension: see the module docstring."""
    from repro_torch.kernels.pack.ops import pack
    from repro_torch.kernels.pack.ref import pack_ref

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x = _tensor(rng.standard_normal(n).astype(np.float32), dev)
    idx = _tensor(rng.integers(0, n, size=m).astype(np.int32), dev)
    out = torch.empty(m, dtype=torch.float32, device=dev)

    def build(params: dict):
        bc = params["block_c"]

        def run():
            return pack(x, idx, out=out, block_c=bc)
        return run

    return ParamSpace(
        "pack",
        [("block_c", tuple(int(v) for v in block_c_values))],
        runner=KernelRunner(
            build=build,
            reference=lambda: pack_ref(x, idx)),
        signature=(f"pack:n={n}:m={m}:dtype=float32:seed={seed}"
                   ":chunk=none(gather)"))
