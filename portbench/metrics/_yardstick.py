"""The benchmark's frozen arithmetic: the card's peaks, the bytes and
operations of the SpMV's kernels and step, and the model FLOPs of a
train step. A change to the program cannot move these.

Peaks: NVIDIA's H100 SXM data sheet, at the full 700 W (the port's
``launch/costs.py`` and ``chip_smoke.py`` hold the same numbers). The
SpMV's bytes count each input byte read once and each output byte
written once (``chip_smoke.py``'s kernel bounds); :func:`model_flops` is
a frozen copy of ``launch/costs.py:model_flops`` at ``train_4k``'s kind
with ``ModelConfig.active_param_count`` for a decoder whose every layer
is attention and MoE, as deepseek-moe-16b runs in the port.
"""
from __future__ import annotations

import numpy as np

BF16_FLOPS = 989e12     # dense bf16 tensor cores
F32_FLOPS = 67e12       # float32 outside the tensor cores
HBM_BYTES = 3.35e12     # HBM3
NVLINK_BYTES = 450e9    # NVLink 4, one direction


def bound_s(n_bytes: float, flops: float,
            flops_per_s: float = F32_FLOPS) -> float:
    """The least time of a kernel or step on the card: the larger of its
    bytes at the HBM's rate and its operations at the peak."""
    return max(n_bytes / HBM_BYTES, flops / flops_per_s)


def spmv_parts(vals: np.ndarray, cols: np.ndarray,
               ranks: int) -> dict[str, int]:
    """Counts of the paper's SpMV split over ``ranks`` block rows: the
    non-zeros each product multiplies (``nnz_local``, ``nnz_remote``),
    the distinct x entries the local product reads and the distinct halo
    entries the remote one reads, over all ranks, and n."""
    n = vals.shape[0]
    m = n // ranks
    row_rank = np.arange(n)[:, None] // m
    live = vals != 0
    local = live & (cols // m == row_rank)
    remote = live & ~local
    # Halo slot of a remote column: its rank's two neighbours' blocks,
    # [left, right], 2m slots a rank (spmv/matrix.py:partition).
    col_rank = cols // m
    left = (row_rank - 1) % ranks
    slot = np.where(col_rank == left, cols % m, m + cols % m)
    halo_slot = row_rank * 2 * m + slot
    return {"n": n, "nnz_local": int(local.sum()),
            "nnz_remote": int(remote.sum()),
            "x_local": int(np.unique(cols[local]).size),
            "halo_remote": int(np.unique(halo_slot[remote]).size)}


def ell_spmv_bytes(parts: dict[str, int]) -> int:
    """Both products of a step (yL and yR): each non-zero's value and
    column, each x or halo entry read, y written, float32."""
    n = parts["n"]
    return ((parts["nnz_local"] + parts["nnz_remote"]) * 8 +
            (parts["x_local"] + parts["halo_remote"]) * 4 + 2 * n * 4)


def ell_spmv_flops(parts: dict[str, int]) -> float:
    return 2.0 * (parts["nnz_local"] + parts["nnz_remote"])


def pack_bytes(n: int) -> int:
    """Pack of every rank's whole block: the index, the send buffer and
    the x entries, 4 bytes each."""
    return 3 * n * 4


def step_bytes(parts: dict[str, int]) -> int:
    """One SpMV step counted once: the matrix (value and column of each
    non-zero), x, the halo (two blocks a rank) and y, float32."""
    n = parts["n"]
    return (parts["nnz_local"] + parts["nnz_remote"]) * 8 + \
        n * 4 + 2 * n * 4 + n * 4


def moe_param_counts(c: dict) -> tuple[float, float]:
    """(all, active) parameters of a decoder of ``c["layers"]`` layers,
    each attention and a MoE MLP of ``experts`` routed and ``shared``
    shared SwiGLU experts of width ``d_expert``, ``top_k`` routed a
    token, untied embeddings of ``vocab``."""
    d, dh, hq, hkv = c["d_model"], c["head_dim"], c["heads"], c["kv_heads"]
    de, e, k, sh = c["d_expert"], c["experts"], c["top_k"], c["shared"]
    per_layer = (d + d * hq * dh + 2 * d * hkv * dh + hq * dh * d + d +
                 (e + sh) * 3 * d * de + d * e)
    total = 2 * c["vocab"] * d + c["layers"] * per_layer + d
    inactive = c["layers"] * (e - k) * 3 * d * de
    return float(total), float(total - inactive)


def model_flops(c: dict, batch: int, seq: int) -> float:
    """6 N D on the active parameters plus the causal attention term, for
    ``batch`` sequences of ``seq`` tokens of a train step."""
    _, active = moe_param_counts(c)
    tokens = batch * seq
    attn = 6.0 * c["layers"] * batch * (seq * seq / 2) * c["heads"] * \
        c["head_dim"] * 2
    return 6.0 * active * tokens + attn
