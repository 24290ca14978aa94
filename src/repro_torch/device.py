"""Device selection and the platform string.

Every entry point of the package takes ``device=None``, which means
``"cuda"``. Without a CUDA device that raises unless the caller asked
for the CPU explicitly: a measurement never falls back to the host
quietly. The platform string names what a measurement ran on, so times
taken on different hardware never share an objective key.
"""
from __future__ import annotations

import shutil
import subprocess

import torch


def resolve_device(device: "str | torch.device | None" = None
                   ) -> torch.device:
    """The device to run on; raises if CUDA is asked for and absent.
    ``"meta"`` (shapes and dtypes, no storage: what the dry run builds
    on) is taken when the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def platform_string(device: torch.device) -> str:
    """``"cpu"``, or the card's name and compute capability."""
    if device.type == "cpu":
        return "cpu"
    major, minor = torch.cuda.get_device_capability(device)
    return f"{torch.cuda.get_device_name(device)} sm_{major}{minor}"


def probe() -> dict:
    """What the toolchain offers: torch, CUDA, the card, nvcc, triton."""
    from repro_torch.kernels.build import nvcc_path

    out: dict = {"torch": torch.__version__,
                 "torch_cuda": torch.version.cuda,
                 "cuda_available": torch.cuda.is_available()}
    if out["cuda_available"]:
        out["device_name"] = torch.cuda.get_device_name(0)
        out["capability"] = list(torch.cuda.get_device_capability(0))
        out["device_count"] = torch.cuda.device_count()
    nvcc = nvcc_path()
    out["nvcc"] = nvcc
    if nvcc is not None:
        ver = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        out["nvcc_version"] = ver.splitlines()[-1] if ver else None
    try:
        import triton
        out["triton"] = triton.__version__
    except ImportError:
        out["triton"] = None
    out["nvidia_smi_path"] = shutil.which("nvidia-smi")
    return out
