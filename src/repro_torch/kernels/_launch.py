"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

import torch

from repro_torch.kernels import build

# dtype -> suffix of the exported C function for that element type.
FLOAT_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# Shared memory one CTA can opt into on Hopper (227 KB).
MAX_SMEM_BYTES = 232448


def check_cuda_args(what: str, *tensors: torch.Tensor,
                    contiguous: bool = True) -> None:
    """Raise unless every tensor is on one CUDA device (and, unless
    ``contiguous`` is False, contiguous)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: every tensor must be on one CUDA "
                             f"device, got {[str(u.device) for u in tensors]}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")


def stream_handle(device: torch.device) -> int:
    """The current stream of ``device`` as an integer handle."""
    return torch.cuda.current_stream(device).cuda_stream


def check_threads(what: str, name: str, threads: int) -> None:
    """Raise unless ``threads`` is a valid CTA size (1..1024)."""
    if not 1 <= int(threads) <= 1024:
        raise ValueError(f"{what}: {name}={threads} threads per CTA is "
                         "outside 1..1024")


def launch_floor(device: torch.device, blocks: int, threads: int) -> None:
    """Launch an empty kernel of ``blocks`` x ``threads`` on the current
    stream of ``device``: the cost of a launch of that grid alone, timed
    beside a kernel as its floor. Counts no launch of any kernel."""
    fn = build.declare(build.library("launch_floor"), "launch_floor", 0, 2)
    build.check(fn(blocks, threads, stream_handle(device)), "launch_floor")
