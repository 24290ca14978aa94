"""Launch wrapper of the hand-written flash-attention kernel
(csrc/flash_attention.cu).

Replaces the TPU kernel
``repro/kernels/flash_attention/kernel.py:flash_attention``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels._launch import (FLOAT_SUFFIX, MAX_SMEM_BYTES,
                                         check_cuda_args, stream_handle)

HEAD_DIMS = (64, 128)      # the kernel's templates; ops.py pads D to one
BLOCK_K_VALUES = (16, 32, 64, 128)   # templates too: S lives in registers
ROWS_PER_WARP = 16         # one m16n8k8 row block per warp
MAX_BLOCK_Q = 128          # 256 threads per CTA

_fns: dict = {}


def smem_bytes(d: int, block_q: int, block_k: int) -> int:
    """Dynamic shared memory of one CTA: the Q tile, a K tile and a V
    tile, float32, rows padded to D+4 words (conflict-free fragment
    loads)."""
    return 4 * (block_q + 2 * block_k) * (d + 4)


def check_blocks(d: int, block_q: int, block_k: int) -> None:
    """Raise ``ValueError`` unless the kernel can launch this block pair
    at head dim ``d``."""
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} is not one of "
                         f"{HEAD_DIMS} (ops.mha pads to one)")
    if block_q % ROWS_PER_WARP or not ROWS_PER_WARP <= block_q <= \
            MAX_BLOCK_Q:
        raise ValueError(f"flash_attention: block_q={block_q} must be a "
                         f"multiple of {ROWS_PER_WARP} in "
                         f"[{ROWS_PER_WARP}, {MAX_BLOCK_Q}]")
    if block_k not in BLOCK_K_VALUES:
        raise ValueError(f"flash_attention: block_k={block_k} is not one "
                         f"of {BLOCK_K_VALUES}")
    if smem_bytes(d, block_q, block_k) > MAX_SMEM_BYTES:
        raise ValueError(
            f"flash_attention: tiles of block_q={block_q}, "
            f"block_k={block_k} at D={d} need "
            f"{smem_bytes(d, block_q, block_k)} bytes of shared memory, "
            f"more than the {MAX_SMEM_BYTES} a CTA can have")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, *, causal: bool, block_q: int,
                    block_k: int, scale: float) -> torch.Tensor:
    """Forward attention on the card, heads pre-flattened.

    ``q`` (BH, Sq, D), ``k``/``v`` (BH, Skv, D), ``out`` (BH, Sq, D),
    all float32 or all bfloat16, contiguous and 16-byte aligned on one
    CUDA device; D in
    :data:`HEAD_DIMS`; Sq a multiple of ``block_q`` and Skv of
    ``block_k`` (ops.mha pads). Causal masking is right-aligned: query
    i sees keys ``j <= i + Skv - Sq``. ``scale`` multiplies q . k.
    Launches on the current stream and does not synchronise.
    """
    suffix = FLOAT_SUFFIX.get(q.dtype)
    if suffix is None or not q.dtype == k.dtype == v.dtype == out.dtype:
        raise TypeError(f"flash_attention: q/k/v/out must all be float32 "
                        f"or all bfloat16, got {q.dtype}/{k.dtype}/"
                        f"{v.dtype}/{out.dtype}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape or \
            out.shape != q.shape or k.shape[0] != q.shape[0] or \
            k.shape[2] != q.shape[2]:
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, out {tuple(out.shape)}"
            " do not fit (BH, Sq, D), (BH, Skv, D), (BH, Skv, D), "
            "(BH, Sq, D)")
    bh, sq, d = q.shape
    skv = k.shape[1]
    check_blocks(d, block_q, block_k)
    if sq % block_q or skv % block_k:
        raise ValueError(f"flash_attention: Sq={sq} and Skv={skv} must be "
                         f"multiples of block_q={block_q} and "
                         f"block_k={block_k}")
    if bh * (sq // block_q) >= 2 ** 31 or max(sq, skv) >= 2 ** 31:
        raise ValueError("flash_attention: the problem is too large")
    check_cuda_args("flash_attention", q, k, v, out)
    if any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("flash_attention: tensors must be 16-byte aligned "
                         "(the kernel loads 16 bytes at a time)")
    fn = _fns.get(suffix)
    if fn is None:
        fn = _fns[suffix] = build.declare(
            build.library("flash_attention"), f"flash_attention_{suffix}",
            4, 7, 1)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             bh, sq, skv, d, block_q, block_k, int(bool(causal)),
             float(scale), stream_handle(q.device))
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
