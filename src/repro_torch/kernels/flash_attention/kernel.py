"""Launch wrapper of the hand-written flash-attention kernels:
csrc/flash_attention.cu (float32: 3xTF32 products on float32 tiles) and
csrc/flash_attention_bf16.cu (bfloat16: wgmma products on bf16 tiles
that TMA fills).

Together they replace the TPU kernel
``repro/kernels/flash_attention/kernel.py:flash_attention``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels._launch import (FLOAT_SUFFIX, MAX_SMEM_BYTES,
                                         check_cuda_args, stream_handle)

HEAD_DIMS = (64, 128)      # the kernel's templates; ops.py pads D to one
BLOCK_K_VALUES = (16, 32, 64, 128)   # templates too: S lives in registers
ROWS_PER_WARP = 16         # one m16n8k8 row block per warp
MAX_BLOCK_Q = 128          # 256 threads per CTA
# The bf16 kernel's (block_q, block_k): one or two consumer warpgroups of
# 64 query rows (and a producer warp), tiles of 64 or 128 keys in a
# two-stage ring.
BF16_BLOCKS = ((64, 64), (64, 128), (128, 64), (128, 128))
# dtype -> (source, exported function)
ENTRY = {torch.float32: ("flash_attention", "flash_attention_f32_bshd"),
         torch.bfloat16: ("flash_attention_bf16",
                          "flash_attention_bf16_bshd")}

_fns: dict = {}


def smem_bytes(d: int, block_q: int, block_k: int) -> int:
    """Dynamic shared memory of one CTA: the Q tile, a K tile and a V
    tile, float32, rows padded to D+4 words (conflict-free fragment
    loads)."""
    return 4 * (block_q + 2 * block_k) * (d + 4)


def bf16_smem_bytes(d: int, block_q: int, block_k: int) -> int:
    """Dynamic shared memory of one CTA of the bf16 kernel: the Q tile
    and two stages of K and V tiles, bf16, its seven mbarriers and the
    slack to align the tiles to the swizzle's 1,024 bytes."""
    return 2 * (block_q + 4 * block_k) * d + 56 + 1024


def check_blocks(d: int, block_q: int, block_k: int,
                 dtype: torch.dtype = torch.float32) -> None:
    """Raise ``ValueError`` unless the kernel can launch this block pair
    at head dim ``d`` for ``dtype``."""
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} is not one of "
                         f"{HEAD_DIMS} (ops.mha pads to one)")
    if dtype == torch.bfloat16:
        if (block_q, block_k) not in BF16_BLOCKS:
            raise ValueError(
                f"flash_attention: the bfloat16 kernel takes (block_q, "
                f"block_k) in {BF16_BLOCKS}, not ({block_q}, {block_k})")
        return
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


def _layout(q, k, v, out):
    """(B, Sq, Hq, D) views of q and out and (B, Skv, Hkv, D) views of k
    and v: 3-D operands (BH, S, D) are the case of one head."""
    if q.dim() == 3:
        if k.dim() != 3 or k.shape != v.shape or out.shape != q.shape or \
                k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
            raise ValueError(
                f"flash_attention: shapes q {tuple(q.shape)}, k "
                f"{tuple(k.shape)}, v {tuple(v.shape)}, out "
                f"{tuple(out.shape)} do not fit (BH, Sq, D), (BH, Skv, D), "
                "(BH, Skv, D), (BH, Sq, D)")
        return tuple(t.unsqueeze(2) for t in (q, k, v, out))
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            out.shape != q.shape or k.shape[0] != q.shape[0] or \
            k.shape[3] != q.shape[3] or k.shape[2] == 0 or \
            q.shape[2] % k.shape[2]:
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, out {tuple(out.shape)}"
            " do not fit (B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D),"
            " (B, Sq, Hq, D) with Hq a multiple of Hkv")
    return q, k, v, out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, *, causal: bool, block_q: int,
                    block_k: int, scale: float) -> torch.Tensor:
    """Forward attention on the card.

    ``q`` and ``out`` (B, Sq, Hq, D), ``k`` and ``v`` (B, Skv, Hkv, D),
    at the strides they have: D contiguous, every other stride and each
    base 16-byte aligned. Query head h reads kv head ``h // (Hq //
    Hkv)``: grouped-query attention without widening k and v. 3-D
    operands, q/out (BH, Sq, D) and k/v (BH, Skv, D), are the case of one
    head. All float32 or all bfloat16 on one CUDA device; D in
    :data:`HEAD_DIMS`; Sq a multiple of ``block_q`` and Skv of
    ``block_k`` (ops.mha pads). Causal masking is right-aligned: query i
    sees keys ``j <= i + Skv - Sq``. ``scale`` multiplies q . k.
    Launches on the current stream and does not synchronise.
    """
    suffix = FLOAT_SUFFIX.get(q.dtype)
    if suffix is None or not q.dtype == k.dtype == v.dtype == out.dtype:
        raise TypeError(f"flash_attention: q/k/v/out must all be float32 "
                        f"or all bfloat16, got {q.dtype}/{k.dtype}/"
                        f"{v.dtype}/{out.dtype}")
    q4, k4, v4, o4 = _layout(q, k, v, out)
    b, sq, hq, d = q4.shape
    skv, hkv = k4.shape[1], k4.shape[2]
    check_blocks(d, block_q, block_k, q.dtype)
    if sq % block_q or skv % block_k:
        raise ValueError(f"flash_attention: Sq={sq} and Skv={skv} must be "
                         f"multiples of block_q={block_q} and "
                         f"block_k={block_k}")
    if b * hq * (sq // block_q) >= 2 ** 31 or max(sq, skv) >= 2 ** 31:
        raise ValueError("flash_attention: the problem is too large")
    check_cuda_args("flash_attention", q, k, v, out, contiguous=False)
    size = q.element_size()
    # The (b, s, h) strides of each operand; a dimension of one is never
    # stepped along.
    strides = [[st if n > 1 else 0 for n, st in zip(t.shape[:3],
                                                     t.stride()[:3])]
               for t in (q4, k4, v4, o4)]
    for t, st in zip((q4, k4, v4, o4), strides):
        if t.stride(3) != 1 or t.data_ptr() % 16 or \
                any(x * size % 16 for x in st):
            raise ValueError(
                "flash_attention: D must be contiguous and every row "
                "16-byte aligned (the kernel loads 16 bytes at a time), "
                f"got strides {t.stride()}")
    fn = _fns.get(suffix)
    if fn is None:
        source, name = ENTRY[q.dtype]
        fn = getattr(build.library(source), name)
        fn.argtypes = [ctypes.c_void_p] * 4 + \
            [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 3 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[suffix] = fn
    dims = [b, hq, hkv, sq, skv, d] + [x for st in strides for x in st]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             (ctypes.c_longlong * len(dims))(*dims), block_q, block_k,
             int(bool(causal)), float(scale), stream_handle(q.device))
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
