"""Roofline terms for one (arch x shape x GPU count) cell, on H100 constants.

Hardware constants, per GPU, each from the NVIDIA H100 SXM data sheet
(700 W): 989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s of HBM3,
450 GB/s per direction of NVLink 4 (900 GB/s both ways). They are data
sheet rates, not measurements; the card this repository measures on is
an NVIDIA H100 80GB HBM3 at a 700.00 W power limit, the data sheet's.

Sources per term (all per GPU = per partition):

  compute    dot flops of the per-partition program over the bf16 peak.
  memory     traffic model over the program's memory numbers:
             train: params+opt are read and written (2x arguments) and
             live temps stream through HBM twice (write+read);
             serve: arguments (weights + caches) are read once per step,
             temps twice.
  collective per-GPU collective operand bytes over the per-direction
             NVLink rate.

The flop, collective and memory inputs come from ``launch/hlo.py``,
which counts them from the torch program run once on DTensors of meta
shards (``launch/dryrun.py``), as the reference's come from an analyzer
of its compiled HLO. The :class:`Roofline` fields and ``to_dict`` keys
are the reference's. ``collective_s_tpu`` (its f32->bf16-adjusted
collective term) equals ``collective_s`` in the port: nothing is
upcast, so ``collective_bytes_f32`` is 0. Every collective is priced at
NVLink's rate; a 16-wide axis spans two 8-GPU nodes, so the term is a
lower bound (the records also carry the bytes by mesh axis).

MODEL_FLOPS (analytic): 6*N*D for dense training (N = active params,
D = tokens), 2*N*D for single-pass inference, plus the attention
quadratic term. The ratio MODEL_FLOPS / (program flops x GPUs) exposes
remat/redundancy waste (and dispatch overcompute for MoE).

:func:`costs_from_arch` derives the train-step op-DAG's cost terms
(:mod:`repro_torch.core.stepdag`) from a config's active parameters, and
:func:`train_step_machine` is the machine model these constants give that
DAG. It is not
``Machine()``: the default machine models the SpMV program (float32
CUDA-core rate, the measured halo copy rate, the executor's host µs per
item), which would price every fwd/bwd at 989/67 = 14.8x its tensor-core
time and shift the compute-to-wire ratio that decides which overlaps
pay.

The JAX package's ``repro/launch/costs.py`` with its imports rewritten
and its TPU constants replaced by the H100's, plus ``costs_from_arch``
from its ``examples/schedule_search.py``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.core.costmodel import Machine
from repro_torch.core.stepdag import StepCosts
from repro_torch.models.config import ModelConfig

PEAK_FLOPS = 989e12   # NVIDIA H100 SXM data sheet (700 W): dense bf16
HBM_BW = 3.35e12      # NVIDIA H100 SXM data sheet (700 W): HBM3
LINK_BW = 450e9       # NVIDIA H100 SXM data sheet (700 W): NVLink 4,
#                       900 GB/s both ways, 450 GB/s per direction


def train_step_machine() -> Machine:
    """The analytic machine for the train-step DAG: this module's
    constants, and no host costs.

    The roofline above has no host term, and neither does this machine:
    ``launch_overhead_s``, ``cpu_op_s`` and ``sync_op_s`` are 0, so a
    schedule's makespan is device time alone (a train step's ops take
    milliseconds and are issued far ahead of the device; the µs that
    ``Machine()`` charges per item were measured on the SpMV program's
    sub-millisecond items). ``comm_latency_s`` is 0 too: the DAG has no
    CPU-posted transfers, and each collective carries its own latency in
    :func:`~repro_torch.core.stepdag.with_comm_durations`.
    """
    return Machine(flops_per_s=PEAK_FLOPS, hbm_bytes_per_s=HBM_BW,
                   link_bytes_per_s=LINK_BW, launch_overhead_s=0.0,
                   cpu_op_s=0.0, sync_op_s=0.0, comm_latency_s=0.0)


def costs_from_arch(arch: str, layers: int, tokens_per_chip: int,
                    tp: int = 16, dp: int = 16) -> StepCosts:
    """Per-GPU :class:`~repro_torch.core.stepdag.StepCosts` of one of
    ``layers`` coarse stages of ``arch``'s train step (each stage
    ``n_layers / layers`` model layers), from its active parameter
    count, under ``tp``-way tensor and ``dp``-way data parallelism.
    The JAX package's ``examples/schedule_search.py:costs_from_arch``."""
    cfg = get_config(arch)
    n_per_layer = cfg.active_param_count() / cfg.n_layers
    coarse = cfg.n_layers / layers
    fwd_flops = 2 * n_per_layer * tokens_per_chip * coarse / tp
    fwd_bytes = fwd_flops / 50.0          # ~50 flops/byte at bf16
    grad_bytes = n_per_layer * coarse * 4 / tp * (dp - 1) / dp
    return StepCosts(fwd_flops=fwd_flops, bwd_flops=2 * fwd_flops,
                     fwd_bytes=fwd_bytes, bwd_bytes=2 * fwd_bytes,
                     grad_bytes=grad_bytes)


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops_per_chip: float
    hlo_collective_bytes_per_chip: float
    mem_traffic_bytes_per_chip: float
    chips: int
    collective_s_tpu: float = 0.0   # f32->bf16-adjusted collective term

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s_tpu or
                 self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Perfect-overlap estimate: the slowest resource wins."""
        return max(self.compute_s, self.memory_s,
                   self.collective_s_tpu or self.collective_s)

    @property
    def model_flops_ratio(self) -> float:
        total_hlo = self.hlo_flops_per_chip * self.chips
        return self.model_flops / total_hlo if total_hlo else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction of the per-GPU peak at the estimated
        step time."""
        if self.step_time_s <= 0:
            return 0.0
        useful = self.model_flops / self.chips
        return useful / (self.step_time_s * PEAK_FLOPS)

    def to_dict(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "collective_s_tpu": self.collective_s_tpu,
            "dominant": self.dominant,
            "step_time_s": self.step_time_s,
            "model_flops": self.model_flops,
            "hlo_flops_per_chip": self.hlo_flops_per_chip,
            "hlo_collective_bytes_per_chip":
                self.hlo_collective_bytes_per_chip,
            "mem_traffic_bytes_per_chip":
                self.mem_traffic_bytes_per_chip,
            "model_flops_ratio": self.model_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "chips": self.chips,
        }


def model_flops(cfg: ModelConfig, shape: str) -> float:
    """MODEL_FLOPS (+ the attention quadratic term, which 6ND omits but
    which dominates prefill_32k)."""
    cell = SHAPES[shape]
    n_active = cfg.active_param_count()
    kinds = cfg.block_kinds()
    n_attn = sum(k == "attn" for k in kinds)
    hq, dh = cfg.n_heads, cfg.head_dim
    b, s = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        tokens = b * s
        attn = 6.0 * n_attn * b * (s * s / 2) * hq * dh * 2
        return 6.0 * n_active * tokens + attn
    if cell.kind == "prefill":
        tokens = b * s
        attn = 2.0 * n_attn * b * (s * s / 2) * hq * dh * 2
        return 2.0 * n_active * tokens + attn
    # decode: one token per sequence; attention reads the full cache.
    window = cfg.attn_window or cell.seq_len
    attn = 4.0 * n_attn * b * min(window, cell.seq_len) * hq * dh
    return 2.0 * n_active * b + attn


def roofline(cfg: ModelConfig, shape: str, kind: str, chips: int,
             hlo_flops_per_chip: float,
             collective_bytes_per_chip: float,
             memory_stats: dict,
             collective_bytes_f32: float = 0.0) -> Roofline:
    arg = memory_stats.get("argument_size_in_bytes", 0)
    temp = memory_stats.get("temp_size_in_bytes", 0)
    out = memory_stats.get("output_size_in_bytes", 0)
    alias = memory_stats.get("alias_size_in_bytes", 0)
    if kind == "train":
        traffic = 2 * arg + 2 * temp + out - alias
    else:
        traffic = arg + 2 * temp + out
    return Roofline(
        compute_s=hlo_flops_per_chip / PEAK_FLOPS,
        memory_s=traffic / HBM_BW,
        collective_s=collective_bytes_per_chip / LINK_BW,
        collective_s_tpu=(collective_bytes_per_chip -
                          0.5 * collective_bytes_f32) / LINK_BW,
        model_flops=model_flops(cfg, shape),
        hlo_flops_per_chip=hlo_flops_per_chip,
        hlo_collective_bytes_per_chip=collective_bytes_per_chip,
        mem_traffic_bytes_per_chip=float(traffic),
        chips=chips,
    )
