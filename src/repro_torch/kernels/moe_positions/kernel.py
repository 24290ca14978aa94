"""Launch wrapper of the hand-written slot-position kernel
(csrc/moe_positions.cu).

Replaces no Pallas kernel: the JAX package's ``_positions`` is a
``jnp.cumsum`` over a one-hot that XLA fuses. :func:`positions` gives
each routed choice its slot in its expert's capacity buffer, exactly as
``models/moe.py:_positions_plain`` does; it launches once on the current
stream, allocates only its two outputs and does not synchronise, so a
CUDA graph can capture it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels._launch import check_cuda_args, stream_handle

# Experts a layer: the kernel keeps (warps + 1) x E int32 counts in
# shared memory, 135,168 bytes at 1,024 experts and 32 warps.
MAX_EXPERTS = 1024
# Entries a thread holds in each tile (csrc/moe_positions.cu's kItems).
ITEMS = 8
# Entries a group: a tile's end must not pass 2**31.
MAX_GROUP = 2 ** 30
_fns: dict = {}


def threads_for(n: int) -> int:
    """Threads of each block of a group of ``n`` entries: one for each
    ``ITEMS`` entries of the group, in whole warps, 32 to 1,024; a block
    takes a tile of ``ITEMS`` entries a thread."""
    return min(1024, max(32, -(-n // (ITEMS * 32)) * 32))


def positions(top_e: torch.Tensor, e: int,
              c: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(pos, keep)`` of ``top_e`` (B, S, k) int64, contiguous on a CUDA
    device: ``pos[b, s, j]`` the number of earlier choices of group ``b``
    in the flattened (S * k) order that went to the same expert, int64,
    and ``keep = pos < c``, bool. ``e`` experts, 1 to ``MAX_EXPERTS``; an
    expert outside [0, e) gives pos -1 and keep False."""
    if top_e.dtype != torch.int64:
        raise TypeError(f"moe positions: experts must be int64, got "
                        f"{top_e.dtype}")
    if top_e.dim() != 3:
        raise ValueError(f"moe positions: experts must be (B, S, k), got "
                         f"{tuple(top_e.shape)}")
    if not 1 <= e <= MAX_EXPERTS:
        raise ValueError(f"moe positions: takes 1 to {MAX_EXPERTS} experts, "
                         f"got {e}")
    b, s, k = top_e.shape
    n = s * k
    threads = threads_for(n)
    if n > MAX_GROUP or b * -(-n // (threads * ITEMS)) >= 2 ** 31:
        raise ValueError(f"moe positions: at most {MAX_GROUP} choices a "
                         f"group and 2**31 - 1 blocks, got {b} x {n}")
    check_cuda_args("moe positions", top_e)
    pos = torch.empty_like(top_e)
    keep = torch.empty(top_e.shape, dtype=torch.bool, device=top_e.device)
    if pos.numel() == 0:
        return pos, keep
    fn = _fns.get("moe_positions")
    if fn is None:
        fn = _fns["moe_positions"] = build.declare(
            build.library("moe_positions"), "moe_positions", 3, 5)
    err = fn(top_e.data_ptr(), pos.data_ptr(), keep.data_ptr(), b, n, e,
             min(max(c, 0), n), threads, stream_handle(top_e.device))
    build.check(err, "moe positions")
    positions.launches += 1
    return pos, keep


positions.launches = 0
