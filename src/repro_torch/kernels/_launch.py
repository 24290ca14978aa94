"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

import torch

# dtype -> suffix of the exported C function for that element type.
FLOAT_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# Shared memory one CTA can opt into on Hopper (227 KB).
MAX_SMEM_BYTES = 232448


def check_cuda_args(what: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is contiguous and on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: every tensor must be on one CUDA "
                             f"device, got {[str(u.device) for u in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")


def stream_handle(device: torch.device) -> int:
    """The current stream of ``device`` as an integer handle."""
    return torch.cuda.current_stream(device).cuda_stream


def check_threads(what: str, name: str, threads: int) -> None:
    """Raise unless ``threads`` is a valid CTA size (1..1024)."""
    if not 1 <= int(threads) <= 1024:
        raise ValueError(f"{what}: {name}={threads} threads per CTA is "
                         "outside 1..1024")
