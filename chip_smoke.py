#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Usage: python3 chip_smoke.py        (from the repository root, one card)

Phases, each printing one JSON line:

  probe        card, capability, power limit, torch and nvcc versions
  build        nvcc build of the hand-written kernels (csrc/*.cu), with
               each function's registers and spills from ptxas
  kernels      each kernel against its plain PyTorch version on the card
               at the main path's shapes and on the reference sweep's
               cases (flash attention's sweep against a float64 softmax
               of the same inputs, the CPU float32 path's distance from
               it reported beside); CUDA-event medians of kernel, plain
               version and one PyTorch library call, beside the bound
               (bytes or flops over the card's peak). ell_spmv runs on
               the main path's
               sorted-slice operands (``slots_read`` = sum(slice_k) x 32
               beside ``nnz``), and is checked on the same rows padded
               to K too (``plain_ms_padded``: the plain version on
               those); its ``bound_ms`` counts the product's own bytes,
               ``bound_ms_slots`` the slots the layout reads and
               ``bound_ms_layout`` its perm and slice_k as well. It,
               pack and ell_onehot also report ``ms_warm`` (no L2 flush,
               as on the main path) and ``floor_ms`` (an empty kernel of
               the same grid, timed the same way). Flash attention's
               bound is its 3xTF32 work on the tensor cores
               (``bound_ms_f32_cores`` beside it); its library call,
               SDPA, is named from a ``torch.profiler`` trace and held to
               the plain version too
  distributed  the 4-rank SpMV at the paper's size in the JAX package's
               four cases (overlap_local: the local multiply issued while
               the halo is in flight, or after the remote one; use_kernel:
               the kernels, or their plain versions on the card), each
               against the float64 oracle, its launches and its step's
               time by measure_cuda, eager (``run.step``) and as a CUDA
               graph's replay (``run.replay``) in turns; the two
               orderings with the kernels must give the same y bit for
               bit, and each replay the eager step's
  demo         demo_spmv_impls (the JAX package's 16 x 16 dense op set)
               through the wallclock evaluator on the card over all 280
               schedules of spmv_dag() at 2 streams, every one gated:
               best/worst us, spread, wall seconds
  race         two schedules with one sync removed must fail the value
               gate (and pass with it); the same two through the CUDA
               graph runner (jit_runner), where whether the gate sees
               the race is reported, and only the intact schedules must
               pass
  main_path    the paper's loop: spmv_dag -> MCTS (budget 400) measured
               on real streams -> labels -> features -> Algorithm 1 ->
               rules, with every kernel's launch count over that run;
               then a second sweep of the same schedules under the same
               objective without a store (``rho_repeat``: Spearman rho
               of the two)
  graph        the same 280 schedules under the JAX package's compiled
               objective: each captured into one CUDA graph by
               jit_runner (ExecutorEvaluator(cuda_graph=True)), gated on
               a replay from poisoned buffers, then timed by replays:
               best/median/worst us, spread, a second store-free sweep
               (``rho_repeat``), rho against main_path's eager times and
               against the H100 model's makespans, two sweeps under the
               paper's windowed protocol over replays (``windowed``:
               their rho, class retention and rules), the rules pipeline
               on the graph times (both tables printed); one replay
               traced by
               torch.profiler in a child process (``--graph-trace``: a
               fourth profiler session in this process would record
               nothing), whose trace must name ell_spmv and pack
  model        the H100 machine model (core/costmodel.py's Machine
               defaults) on spmv_dag at the paper's size in float32: the
               280 schedules' analytic makespans through ``sim`` and
               ``vectorized`` (equal bit for bit, else a failure), their
               best/median/worst us, Spearman rho against the main
               path's measured times (``rho_model_vs_card``), the share
               of schedules both put in the same performance class, and
               the seconds each took beside the card's
  driver       the search driver (driver/driver.py) over the same 280
               measured schedules: SurrogateGuided with the gradient-boosted
               surrogate, screened by expected improvement, sim_budget 140,
               streaming to the dataset, histogram and telemetry sinks
               under an enabled obs registry: measured / gated / store-hit
               counts, the kernels' launches, whether the histogram sink's
               out-of-core distill equals the dataset sink's dense one field
               by field (a mismatch fails), the surrogate's Spearman rho
               against the measured times of the schedules it screened,
               seconds per span beside the phase's wall, and the path of
               the Perfetto trace it writes (chiprun_out/driver_trace.json);
               then a warm replay from a store, which must measure nothing
  rpc          the evaluation service on the card's host: two
               ``python -m repro_torch.engine.server --space halo3d
               --backend vectorized`` processes; a cold rpc search
               (sim_budget 60) bit for bit equal to local sim with no
               local evaluation, the same search with one server killed
               mid-search (identical again; its local evaluations and
               retries), an in-process server of another space refusing
               with ``n_refused == 1`` read at once, the servers' pids
               (from their WELCOME) absent from nvidia-smi's compute apps
               and holding no /dev/nvidia* file, and ``rpc_stats``
  stepdag      qwen2.5-32b's train step at 4 coarse stages as an op-DAG
               on the H100 data sheet's constants (``launch/costs.py``),
               MCTS through an in-process two-host fleet held equal to
               local sim; best and worst makespans (analytic model, not a
               measurement) and the first rules
  onehot_path  ell_matvec_onehot, the narrow-band SpMV's entry point, once
               at the paper's n and nnz on a band of half-width 512 (the
               kernel is on no path of the JAX package), with its launch
               count
  autotune     kernel autotuning: the flash_attention space at one
               attention layer of qwen2.5-32b (1 x 40 x 4096 x 128, f32,
               causal) -> wallclock evaluator -> MCTS over the 16
               (block_q, block_k) pairs, every one gated -> distill; a
               second sweep (Spearman rho of the two), a warm replay from
               an EvalStore (zero measurements), and the spmv_mulsum and
               pack spaces swept exhaustively
  serve        the dense LM serving path: qwen2.5-32b at full width with
               24 of its 64 layers, float32 weights drawn on the card
               from a seed, bfloat16 activations; Engine.generate on 4
               prompts of 1,024 seeded tokens, 16 greedy new tokens, the
               flash kernel counted (one launch per layer in prefill);
               prefill ms and decode ms per token by CUDA events, tokens
               per second, peak memory; the prefill's logits against the
               plain attention route on the same weights (max |dlogit|
               against max |logit|, and the share of greedy tokens that
               agree: reported; non-finite logits fail); layer by layer
               in bfloat16 and float32 activations, the two routes'
               attention on the kernel route's q, k, v (within
               SERVE_ATTN_TOL of max |o|, else a failure) and how far
               the two routes' residual streams part; one
               prefill and one decode step under torch.profiler (device
               ms by kernel, idle share, the copy kernels by name;
               traces in chiprun_out/); the flash kernel alone at the
               prefill's shape in bfloat16 as served (40 q heads on the
               projections' 8 kv heads, (B, S, H, D)) against its plain
               version and SDPA with enable_gqa, which are the
               ``kernels`` line's flash_attention numbers, and widened
               (one kv head per q head, ``at_widened_shape``; the
               autotune shape's under ``at_autotune_shape``). Also alone:
               ``chip_smoke.py --serve``
  families     the five families the serve phase does not run, each at
               its config's full width through the same entry points
               (LM, Engine.generate), f32 weights drawn on the card from
               a seed, bf16 activations, each in a process of its own
               (``chip_smoke.py --family ARCH``): jamba-v0.1-52b with 8 of
               its 32 layers (one period: Mamba, attention, MoE), 4 x
               1,024 prompt + 16 new tokens; deepseek-moe-16b, rwkv6-3b,
               internvl2-2b (256 seeded patch embeddings before the
               text) and whisper-tiny (1,500 seeded frames into its
               encoder) whole, 2 x 512 + 8. One line each: params and
               the ``reduced`` cut, prefill ms and decode ms per token
               by CUDA events, tokens/s, peak memory, flash launches per
               prefill (gated equal to the decoder's causal attention
               layers: the encoder and cross-attention take the plain
               route), the MoE configs' share of (token, expert) pairs
               the prefill's capacity drops, one prefill and one decode
               step under torch.profiler (device ms by kernel class,
               idle share); at every causal attention layer the kernel
               against the plain route (route_divergence, within
               SERVE_ATTN_TOL), and layer by layer the decode step from
               the prefill's caches against the full-sequence form at the
               same position (cache_check, within FAMILY_CACHE_TOL in
               bf16, reported in f32); finite logits
  train        the training substrate: qwen2.5-32b at full width with 4
               of its 64 layers, float32 parameters drawn on the card,
               bfloat16 activations, one sequence of 4,096 lm_batch
               tokens (seed 0); make_train_step (plain attention, layer
               and KV-block remat) under AdamW, one warm-up step, then 3
               with CUDA events around forward, backward and optimizer
               (ms each, tokens/s, model-FLOP share of the bf16 peak,
               peak memory, losses: non-finite fails) and one under
               torch.profiler (idle share; chiprun_out/train_trace.json);
               the trained model's eval loss through the flash kernel
               (one launch per layer, counted) within TRAIN_EVAL_TOL of
               the plain route's, else a failure; on the same trained
               model and eval tokens, layer by layer, the two routes'
               attention on the kernel route's q, k, v (the kernel at
               the train shape, 1 x 40 x 4,096 x 128 bfloat16 with kv
               widened: within SERVE_ATTN_TOL["bfloat16"] of max |o|,
               else a failure); one layer's fwd and bwd (and its
               attention's) beside the train-step DAG's price of them
               (costs_from_arch at tp = dp = 1 under
               train_step_machine()); the reference's bit-exact restart
               at the reduced smollm config (8 steps, failure at 5,
               resumed), which must hold
  train_families
               the non-dense families trained at their configs' widths,
               f32 parameters drawn on the card, bf16 activations, AdamW,
               plain attention, remat, each in a process of its own
               (``chip_smoke.py --train-family ARCH``): deepseek-moe-16b
               with 4 of its 28 layers on one sequence of 4,096 lm_batch
               tokens (einsum dispatch, capacity 1.25; fwd / bwd / opt ms,
               tokens/s, model-FLOP share on the active parameters, peak
               memory, drops, aux, one step profiled by kernel class; the
               eval loss through the flash kernel within TRAIN_EVAL_TOL of
               the plain route's and route_divergence at every layer
               within SERVE_ATTN_TOL["bfloat16"], else a failure);
               jamba-v0.1-52b's Mamba mixer alone at full width, fwd+bwd
               on 1 x 4,096 tokens chunked (its peak above the start under
               a bound from the per-chunk states, else a failure) and as
               one flat loop (reported), and its card gradients at 512
               tokens in f32 within MAMBA_GRAD_TOL of the CPU's; rwkv6-3b
               whole (1 x 4,096, chunk 256), internvl2-2b and whisper-tiny
               whole (2 x 512, frontends from frontend_batch): finite
               losses, flash eval gated as above, one launch per causal
               attention layer
  adamw        AdamW's two kernels (csrc/adamw.cu) at deepseek-moe-16b's
               55 leaves with 4 of its 28 layers (the benchmark's
               train-4k cell), in a process of its own (``chip_smoke.py
               --adamw``, also alone): each leaf's sum of squares against
               float64 and its update against the plain version on the
               same state (within ADAMW_TOL, else a failure); CUDA-event
               medians, L2 flushed, of the sums of squares, the updates,
               AdamW.step whole and the plain step, beside the 32 bytes a
               parameter bound; one step's launches and counters
  positions    the MoE dispatch's slot-position kernel
               (csrc/moe_positions.cu), in a process of its own
               (``chip_smoke.py --positions``, also alone), at the
               benchmark cells' shapes (POSITIONS): pos and keep against
               the plain version, exactly (else a failure); CUDA-event
               medians, L2 flushed, of the kernel, of ``_positions`` on
               top-k's indices as the model passes them, of an empty
               kernel of the same grid and of the plain version, beside
               the 17 bytes an entry bound; launches a call and the
               counters; the plain version reworked without a kernel
               (PLAIN_REWORKS: a bool one-hot scanned in int32 along its
               innermost or its outer dim), timed and checked beside it;
               ``_positions`` on DTensors of a one-rank NCCL
               mesh (sharded on B, replicated: the kernel; sharded on S:
               refused)
  mla          (``chip_smoke.py --mla`` alone) moonlight-16b-a3b's latent
               attention at its published widths: the dense first layer
               and one MoE layer (MLA_SMOKE), weights drawn at the
               benchmark's scales, against the plain reference
               (portbench/reference/mla_moe_lm.py, float32): the bf16
               forward's logits at every position of 1 x 4,096 tokens
               (||port - ref|| / ||ref|| beside the float8 control's),
               a prefill of 1,024 then one decode step through the latent
               cache against the reference's forward over the 1,025
               tokens, one train step's loss and gradients finite, the
               ``attn.mla`` spans' device ms of a forward at 8,192 tokens,
               and the peak memory
  dist         the distribution and launch layer, two processes.
               ``dryrun``: qwen2.5-32b x train_4k and x decode_32k on the
               16x16 mesh over a fake group of 256 ranks on the card's
               host (no card, nothing allocated): per-GPU argument,
               temporary and output bytes, dot FLOPs, collective bytes
               by kind and by mesh axis, the roofline's terms on the
               H100 constants, wall seconds. ``card``: the same
               build_cell/jit_train_step on a 1x1 mesh over a one-rank
               NCCL group at the train phase's cell (full width, 4 of 64
               layers, 1 x 4,096 tokens): predicted on the meta device
               (bytes, dot FLOPs), then three steps on the card: the
               first's loss and updated parameters must be
               make_train_step's on the same card and inputs within
               DIST_STEP_RTOL, the second's dot FLOPs (FlopCounterMode)
               the prediction's within DIST_FLOPS_TOL, the third is
               timed (predicted over measured bytes and the roofline's
               compute term over that time reported); then compressed_psum_mean over
               that group on one layer's gradients, bit for bit the
               CPU's (two rounds: the residual carried)
  shard        the distributed SpMV with one process per rank
               (spmv/distributed.py:make_rank_spmv, the JAX package's
               spmv_shard under shard_map): R = min(4, cards) children
               (``chip_smoke.py --shard RANK R PORT``), each on its own
               card in an NCCL group, on its rank's part of the paper's
               matrix in the four cases; each case's y within 1e-4 of max
               |y| of the float64 oracle and bit for bit the one-process
               make_distributed_spmv's at the same R, ell_spmv launched
               with the kernels and nothing without, the two orderings
               with the kernels bit-equal; each step timed per rank by
               measure_cuda over a fixed count of steps (every rank makes
               the same number of exchanges), in turns. On one card R = 1
               and the exchange is the identity (a copy): the exchange
               between cards is checked only where there are two or more

Then the card's ``name, power.limit``, one ``{"kernels": [...]}`` line
and, last, ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before the last line. Without CUDA, or without the repository beside
it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside tensor cores
TF32_FLOPS_PER_S = 495e12      # H100 SXM dense TF32 (NVIDIA data sheet)
PAPER_N, PAPER_NNZ, RANKS = 150_000, 1_500_000, 4
# One attention layer of qwen2.5-32b (n_heads=40, d_model=5120) at the
# train_4k length; the flash_attention space's instance.
ATTN = {"batch": 1, "heads": 40, "seq": 4096, "head_dim": 128}
ONEHOT_HB, ONEHOT_BLOCK_R = 512, 256
SLEEP_CYCLES = 50_000_000      # ~25 ms of device sleep (queues launches, delays a producer)
# The serve phase: qwen2.5-32b at full width, depth cut from 64 layers
# (53.1 GB of float32 weights; all 64 would need 131 GB), batch 4 x
# 1,024 prompt tokens, 16 greedy new tokens.
SERVE = {"arch": "qwen2.5-32b", "n_layers": 24, "batch": 4, "prompt": 1024,
         "new": 16, "seed": 0}
# Kernel vs plain attention route on the serve path's own q, k, v, layer
# by layer (each layer's input taken from the kernel route), as a share of
# max |o|. Random weights under the reference's init make scores of
# std ~300 at this width, so attention is near one-hot and a score
# error of 1e-6 (float32 accuracy, what 3xTF32 keeps) moves o by ~1e-4
# of its range in float32; bf16 outputs round that to one ulp, 2^-8.
# The tolerances allow 2.5 ulps (bf16) and 8x float32's reading. The
# end-to-end logits of the two routes are reported, not gated: at this
# init the model is chaotic, and two float32-accurate routes part by
# layer ~10 (route_divergence).
SERVE_ATTN_TOL = {"bfloat16": 1e-2, "float32": 2e-3}
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor cores
# The train phase: qwen2.5-32b at full width, depth cut from 64 layers
# to 4 (3,523,290,112 f32 parameters: parameters, gradients and AdamW's
# two moments take 56.4 GB), one sequence of train_4k's 4,096 tokens
# (configs/shapes.py), lm_batch data from seed 0; one warm-up step, then
# TRAIN["steps"] timed ones and one profiled.
TRAIN = {"arch": "qwen2.5-32b", "n_layers": 4, "batch": 1, "seq": 4096,
         "seed": 0, "steps": 3}
# The trained model's eval loss through the flash kernel against the
# plain route's, relative: the two routes' attention differs by ~4e-3 of
# max |o| per layer in bf16 (the serve phase's route_divergence), and
# the loss averages 4,096 positions' CE over 4 layers. This gate is
# blind to attention: with random weights the CE is about ln V plus
# half the logits' variance, which the final rmsnorm fixes whatever
# attention returns. The kernel is held at the train shape by
# route_divergence, layer by layer, at SERVE_ATTN_TOL["bfloat16"].
TRAIN_EVAL_TOL = 1e-2
# The restart gate: the reference's test_restart_is_bit_exact on the
# card (reduced smollm-360m, lm_batch, 8 steps, a failure injected at
# step 5 after the checkpoint at step 3, then resumed).
RESTART = {"arch": "smollm-360m", "steps": 8, "fail_at": 5,
           "ckpt_every": 3, "batch": 4, "seq": 16, "lr": 1e-3}
# Every rpc socket wait is bounded, so no phase can hang on a server.
RPC_TIMEOUTS = {"deadline": 10.0, "connect_timeout": 5.0}
# The families phase: each non-dense family at its config's full width,
# f32 parameters drawn on the card from a seed, bf16 activations, cut
# only where memory forces it. jamba-v0.1-52b keeps one period (4
# Mamba, 1 attention, 3 Mamba layers; MoE on every other one) of its
# 32 layers: 53.2 GB of weights, the whole model 206 GB; the others are
# whole. Each runs in a process of its own (its memory freed at exit,
# and a fresh profiler: a fourth session in one process records no
# kernels on the card's machine).
FAMILIES = {
    "jamba-v0.1-52b": {"n_layers": 8, "batch": 4, "prompt": 1024,
                       "new": 16},
    "deepseek-moe-16b": {"batch": 2, "prompt": 512, "new": 8},
    "rwkv6-3b": {"batch": 2, "prompt": 512, "new": 8},
    "internvl2-2b": {"batch": 2, "prompt": 512, "new": 8},
    "whisper-tiny": {"batch": 2, "prompt": 512, "new": 8},
}
FAMILY_TIMEOUT_S = 420
# The teacher-forced cache check: block_decode's output for the token at
# position P from the caches block_prefill left after P tokens, against
# block_forward's output at P on the same layer input, as a share of
# max |y| there. In bf16 both sides round every activation, at places
# that differ by an op or two (the kernel's prefill against the decode's
# one-query softmax; the recurrences' last step), so a few ulps (2^-8
# each) of y: 1e-2. Reported in f32 too.
FAMILY_CACHE_TOL = 1e-2
# The train_families phase: the non-dense families trained at their
# configs' full widths, f32 parameters drawn on the card from seed 0,
# bf16 activations, AdamW, the plain attention route and layer remat,
# each in a process of its own (``chip_smoke.py --train-family ARCH``).
# deepseek-moe-16b keeps 4 of its 28 layers (2,770,880,512 parameters:
# with gradients and AdamW's moments 44.3 GB), einsum dispatch at
# capacity factor 1.25, one sequence of train_4k's 4,096 lm_batch
# tokens; rwkv6-3b is whole (1 x 4,096, RWKV's chunked form at 256, as
# the dry run's train cell runs it); internvl2-2b and whisper-tiny are
# whole, 2 x 512 tokens with frontends from frontend_batch. Jamba's
# 8-layer period (13.3 B parameters) does not train on one 80 GB card,
# and its period cannot be cut: it runs the Mamba mixer of its first
# layer alone (``mamba``), the layer whose backward is new.
TRAIN_FAMILIES = {
    "deepseek-moe-16b": {"n_layers": 4, "batch": 1, "seq": 4096,
                         "steps": 3, "profile": True},
    "jamba-v0.1-52b": {"batch": 1, "seq": 4096, "check_seq": 512},
    "rwkv6-3b": {"batch": 1, "seq": 4096, "steps": 2, "rwkv_chunk": 256},
    "internvl2-2b": {"batch": 2, "seq": 512, "steps": 2},
    "whisper-tiny": {"batch": 2, "seq": 512, "steps": 2},
}
TRAIN_FAMILY_TIMEOUT_S = 420
# The Mamba mixer's card gradients against the CPU's at 512 tokens in
# float32 activations, as a share of max |g| per parameter: the two
# sum 512 steps' contributions to A's and the projections' gradients in
# different orders (cuBLAS's and the CPU's products, TF32 off).
MAMBA_GRAD_TOL = 1e-3
# The dist phase (the distribution and launch layer). ``dryrun``: the
# qwen2.5-32b cells on the 16x16 production mesh over a fake group of
# 256 ranks, nothing allocated, in a process of its own on the card's
# host. ``card``: the train cell's build_cell/jit_train_step on a 1x1
# mesh over a one-rank NCCL group, at full width with 4 of 64 layers and
# one sequence of 4,096 tokens (the train phase's cell): predicted on
# the meta device, then one step on the card, held to make_train_step
# on the same card and inputs; and compressed_psum_mean over that group
# on one layer's gradients, held to the CPU's. A fake group and an NCCL
# group cannot both be a process's default, so each part runs in a
# process of its own.
DIST = {"arch": "qwen2.5-32b", "dryrun_shapes": ("train_4k", "decode_32k"),
        "card_layers": 4, "card_batch": 1, "card_seq": 4096, "seed": 0}
# Predicted (meta device, the dry run's analyzer) against counted
# (FlopCounterMode over the step on the card) dot FLOPs, relative.
DIST_FLOPS_TOL = 1e-3
# The distributed step against make_train_step: bit for bit is what a
# 1x1 mesh should give (every collective is over one rank); the gate
# allows 1e-6 of max |value| per tensor.
DIST_STEP_RTOL = 1e-6
DIST_TIMEOUT_S = 600
# The adamw phase: csrc/adamw.cu at deepseek-moe-16b's 55 leaves with 4
# of its 28 layers (the benchmark's train-4k cell: 2,770,880,512 float32
# parameters), under the cell's AdamW (warmup_cosine(3e-3, 20, 200),
# clip 1.0), gradients drawn at random on the card. Its bytes: the norm
# reads each gradient once (4 B a parameter), the update reads g, p, mu,
# nu and writes p, mu, nu (28 B): 32 B, 26.5 ms at 3.35 TB/s. Each leaf's
# update through the kernel is held to the plain version's on the same
# state within ADAMW_TOL of max |value| (the two round the clip's scale
# and the moments' products apart by an ulp or so).
ADAMW = {"arch": "deepseek-moe-16b", "n_layers": 4, "seed": 0,
         "iters": 10, "plain_iters": 3, "timeout_s": 300}
ADAMW_TOL = 1e-6
# The positions phase: csrc/moe_positions.cu at (B, S, k) of the
# benchmark's train-4k, train-8k and prefill cells, E = 64, capacity
# factor 1.25. Its bytes: each entry read once (8 B) and written once
# (8 B of pos, 1 B of keep), 17 B.
POSITIONS = {"shapes": [(1, 4096, 6), (1, 8192, 6), (4, 1024, 6)],
             "experts": 64, "iters": 200, "plain_iters": 20, "seed": 0,
             "timeout_s": 300}


def positions_inner(top_e, e: int, c: int):
    """The plain version reworked: a bool one-hot laid out (B, E, S*k)
    and scanned in int32 along its innermost dim, each choice's own
    expert's count read back: seven launches of PyTorch's own."""
    b, s, k = top_e.shape
    flat = top_e.reshape(b, 1, s * k)
    hit = flat == torch.arange(e, device=top_e.device)[:, None]
    upto = torch.cumsum(hit, dim=-1, dtype=torch.int32)     # (B,E,S*k)
    pos = (torch.gather(upto, 1, flat) - 1).reshape(b, s, k).long()
    return pos, pos < c


def positions_outer(top_e, e: int, c: int):
    """The plain version with the one-hot in int32 (bool, then an int32
    scan) and its layout, (B, S*k, E), scanned along the outer dim."""
    b, s, k = top_e.shape
    flat = top_e.reshape(b, s * k, 1)
    hit = flat == torch.arange(e, device=top_e.device)
    upto = torch.cumsum(hit, dim=1, dtype=torch.int32)      # (B,S*k,E)
    pos = (torch.gather(upto, -1, flat) - 1).reshape(b, s, k).long()
    return pos, pos < c


# The positions phase times these beside the kernel: whether the plain
# version, reworked in place, would do as well.
PLAIN_REWORKS = {"inner_int32": positions_inner,
                 "outer_int32": positions_outer}
# The mla phase: moonlight-16b-a3b's dense first layer and one MoE layer
# at published widths; the forward at ``seq`` tokens, a prefill of
# ``prompt`` and one decode step (each within MLA_TOL of the reference's
# logits, ||port - ref|| / ||ref||: bf16 against float32, the float8
# control's reading beside), the spans at ``long_seq``.
MLA_SMOKE = {"n_layers": 2, "seq": 4096, "prompt": 1024, "long_seq": 8192,
             "seed": 0}
MLA_TOL = 0.05
# The graph phase's child, which traces one replay at the paper's size.
GRAPH_TRACE_TIMEOUT_S = 300
# The graph phase's windowed sweeps: replays back to back for 5 ms, the
# median of 3 such windows a schedule (two sweeps of 280: ~20 s).
GRAPH_WINDOWED = {"t_measure_s": 0.005, "repeats": 3}
# The shard phase: at most 4 ranks (the paper's band, half-width n/4,
# must lie within one neighbour's block), one card each; a window is a
# fixed count of steps, so that every rank makes as many exchanges.
SHARD = {"max_ranks": 4, "samples": 200, "timeout_s": 300}



def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def ecc_line() -> str:
    """The card's ECC mode and its corrected and uncorrected error counts
    since the driver loaded, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=ecc.mode.current,"
         "ecc.errors.corrected.volatile.total,"
         "ecc.errors.uncorrected.volatile.total", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or out.stderr.strip()


def time_cuda(fn, iters: int = 60, cold: bool = True,
              dirty: bool = True) -> float:
    """Median device milliseconds of ``fn()``: CUDA events around each
    call, the 50 MB L2 flushed before each (``cold``; without it the
    call finds the last one's data in L2, as back-to-back calls on the
    main path do), launches queued behind a device sleep so the host
    never starves the card. The flush writes a 128 MB buffer, so the
    call evicts dirty lines (written back to memory as it reads);
    ``dirty=False`` flushes by reading that buffer instead."""
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for s, e in zip(starts, ends):
        if cold:
            flush.zero_() if dirty else flush.sum()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def bound_ms(n_bytes: float, flops: float,
             flops_per_s: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def traced_kernels(parts: dict, path: str) -> dict:
    """Each of ``parts`` (name -> fn) called in turn under one
    torch.profiler session (CPU and CUDA), inside a ``record_function``
    span that starts and ends with a sync; the Chrome trace is written to
    ``path``. Per part: device ms per kernel name (the trace's kernel
    events inside the part's span on the device's timeline, its
    ``gpu_user_annotation``: the host's span is milliseconds off that
    clock), largest first, and the span's wall ms by the host clock. One
    session serves a phase: on the card's machine a fourth session in
    one process has recorded no kernels."""
    from torch.profiler import ProfilerActivity, profile, record_function

    walls = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        for name, fn in parts.items():
            with record_function(f"part.{name}"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls[name] = (time.perf_counter() - t0) * 1e3
    p.export_chrome_trace(path)
    with open(path) as f:
        by_part = kernels_by_part(json.load(f)["traceEvents"], list(parts))
    return {name: (ks, walls[name]) for name, ks in by_part.items()}


def kernels_by_part(events: list, names: list) -> dict:
    """Device ms per kernel name, largest first, for each ``part.<name>``
    span of a Chrome trace's device timeline."""
    spans = {e["name"][len("part."):]: (e["ts"], e["ts"] + e["dur"])
             for e in events if e.get("cat") == "gpu_user_annotation" and
             e.get("name", "").startswith("part.")}
    out = {}
    for name in names:
        if name not in spans:
            raise AssertionError(f"torch.profiler saw no device work in "
                                 f"{name}")
        lo, hi = spans[name]
        by_name: dict = {}
        for e in events:
            if e.get("cat") == "kernel" and lo <= e["ts"] <= hi:
                by_name[e["name"]] = by_name.get(e["name"], 0.0) + \
                    e["dur"] / 1e3
        if not by_name:
            raise AssertionError(f"torch.profiler saw no device kernel "
                                 f"in {name}")
        out[name] = dict(sorted(by_name.items(), key=lambda kv: -kv[1]))
    return out


def device_kernel(fn) -> str:
    """Name of the longest device kernel three calls of ``fn`` launch,
    from a ``torch.profiler`` trace."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        ks, _ = traced_kernels({"fn": lambda: [fn() for _ in range(3)]},
                               os.path.join(tmp, "trace.json"))["fn"]
    return next(iter(ks))


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max |ref|)."""
    err = float((got.float() - ref.float()).abs().max())
    return err, err / (float(ref.float().abs().max()) + 1e-30)


def csr_of(vals_t: torch.Tensor, cols_t: torch.Tensor, n_cols: int):
    """The nonzeros of an ELL-T matrix as a CSR tensor (the library
    call's operand; built once, outside any timing)."""
    vals, cols = vals_t.T.contiguous(), cols_t.T.contiguous()
    keep = vals != 0
    crow = torch.zeros(vals.shape[0] + 1, dtype=torch.int64,
                       device=vals.device)
    crow[1:] = keep.sum(1).cumsum(0)
    return torch.sparse_csr_tensor(crow, cols[keep].long(), vals[keep],
                                   size=(vals.shape[0], n_cols))


def cold_warm_floor(fn, grid, dev) -> dict:
    """A kernel's CUDA-event times, cold and warm, beside those of an
    empty kernel of the same grid timed the same way."""
    from repro_torch.kernels._launch import launch_floor

    def floor():
        launch_floor(dev, *grid)

    return {"ms": time_cuda(fn), "ms_warm": time_cuda(fn, cold=False),
            "floor_ms": time_cuda(floor)}


def ragged_ell(n, k, rng):
    """Row lengths uniform in 0..K, slots past a row's length 0 with a
    valid column (the layout spmv/matrix.py:partition leaves)."""
    length = rng.integers(0, k + 1, size=n)
    live = np.arange(k)[None, :] < length[:, None]
    vals = np.where(live, rng.standard_normal((n, k)), 0.0).astype(
        np.float32)
    cols = np.where(live, rng.integers(0, n, size=(n, k)),
                    np.arange(n)[:, None]).astype(np.int32)
    return vals, cols, rng.standard_normal(n).astype(np.float32)


def phase_kernels(spmv, dev) -> dict:
    from repro_torch.kernels.pack.ops import pack, pack_plain
    from repro_torch.kernels.spmv.kernel import SLICE_ROWS, spmv_grid
    from repro_torch.kernels.spmv.ops import (BLOCK_N, ell_matvec,
                                              ell_matvec_t, ell_spmv_plain,
                                              sliced_matvec, sliced_operands,
                                              unsliced)

    # Fill the halo with the values the main path gives yR.
    spmv.post_send(spmv.pack(spmv.x))
    torch.cuda.synchronize()
    x, halo = spmv.x, spmv.halo.clone()

    calls = []
    for name, part, xin in (("yL", spmv.local, x), ("yR", spmv.remote, halo)):
        vt, ct, sk, perm = part
        pv, pc = unsliced(part)
        out = torch.empty(vt.shape[1], dtype=torch.float32, device=dev)

        def sliced():
            return sliced_matvec(part, xin, out)

        sliced()
        padded = ell_matvec_t(pv, pc, xin)
        plain = ell_spmv_plain(vt, ct, xin, sk, perm)
        plain_padded = ell_spmv_plain(pv, pc, xin)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"ell_spmv {name}: an entry of y was "
                                 "not written")
        err, rel = rel_err(out, plain)
        err_p, rel_p = rel_err(padded, plain_padded)
        if not (rel <= 1e-5 and rel_p <= 1e-5):
            raise AssertionError(f"ell_spmv {name}: rel err {rel} sliced, "
                                 f"{rel_p} padded > 1e-5")
        k, n = vt.shape
        nz = vt != 0
        nnz = int(nz.sum())
        slots = int(sk.sum()) * SLICE_ROWS
        if not slots <= 1.05 * nnz:
            raise AssertionError(f"ell_spmv {name}: the sorted slices read "
                                 f"{slots} slots for {nnz} non-zeros")
        # The product's own bytes: each non-zero's value and column, each
        # x entry it touches, y. The kernel also reads the slots_read -
        # nnz zero slots of the slices' shorter rows (bound_ms_slots
        # counts them) and the layout's perm and slice_k
        # (bound_ms_layout counts them on top of the product's bytes).
        x_bytes = int(torch.unique(ct[nz]).numel()) * xin.element_size()
        layout_bytes = 4 * (n + sk.numel())
        n_bytes = nnz * (vt.element_size() + 4) + x_bytes + n * 4
        slot_bytes = slots * (vt.element_size() + 4) + x_bytes + n * 4
        b, by = bound_ms(n_bytes, 2.0 * nnz)
        csr = csr_of(pv, pc, xin.numel())
        try:
            lib = time_cuda(lambda: torch.mv(csr, xin))
            lib_err = None
        except RuntimeError as e:          # no CSR mv on this build
            lib, lib_err = None, str(e)[:200]
        calls.append({
            "op": name, "K": k, "N": n, "nx": xin.numel(), "nnz": nnz,
            "slots_read": slots, "slots_padded": k * n,
            "bytes": n_bytes, "slot_bytes": slot_bytes,
            "bound_ms_slots": bound_ms(slot_bytes, 2.0 * nnz)[0],
            "bound_ms_layout": bound_ms(n_bytes + layout_bytes,
                                        2.0 * nnz)[0],
            "max_abs_err": max(err, err_p), "rel_err": max(rel, rel_p),
            "equal_to_padded": bool(torch.equal(out, padded)),
            **cold_warm_floor(sliced, spmv_grid(n, BLOCK_N), dev),
            "plain_ms": time_cuda(lambda: ell_spmv_plain(vt, ct, xin, sk,
                                                         perm)),
            "plain_ms_padded": time_cuda(lambda: ell_spmv_plain(pv, pc,
                                                                xin)),
            "library_ms": lib, "library_error": lib_err,
            "bound_ms": b, "bound_by": by})

    idx, sendbuf = spmv.send_idx, torch.empty_like(spmv.sendbuf)
    got = pack(x, idx, out=sendbuf)
    plain = pack_plain(x, idx)
    torch.cuda.synchronize()
    if not torch.equal(got, plain):
        raise AssertionError("pack differs from its plain version")
    valid = idx[(idx >= 0) & (idx < x.numel())]
    n_bytes = idx.numel() * 4 + got.numel() * got.element_size() + \
        int(torch.unique(valid).numel()) * x.element_size()
    b, by = bound_ms(n_bytes, 0.0)
    pack_call = {
        "op": "Pack", "n": x.numel(), "m": idx.numel(), "bytes": n_bytes,
        "max_abs_err": 0.0,
        **cold_warm_floor(lambda: pack(x, idx, out=sendbuf),
                          (-(-idx.numel() // 256), 256), dev),
        "plain_ms": time_cuda(lambda: pack_plain(x, idx)),
        "library_ms": time_cuda(lambda: torch.index_select(x, 0, idx)),
        "bound_ms": b, "bound_by": by}

    # The reference sweep's cases (tests/test_kernels.py): ragged n and
    # K, bf16 inputs, with every row padded to K and in sorted slices of
    # ragged rows, at block_n 32 and 256; pack with -1 and past-the-end
    # padding, at ragged m, and into an out (and from an idx) a few
    # elements into its buffer, bits compared.
    sweep = []
    rng = np.random.default_rng(0)
    for n, k, dtype in ((64, 1, torch.float32), (300, 7, torch.float32),
                        (512, 8, torch.float32), (1024, 16, torch.bfloat16),
                        (2048, 5, torch.bfloat16)):
        vals = torch.from_numpy(rng.standard_normal((n, k)).astype(
            np.float32)).to(dev, dtype)
        cols = torch.from_numpy(rng.integers(0, n, (n, k)).astype(
            np.int32)).to(dev)
        xs = torch.from_numpy(rng.standard_normal(n).astype(
            np.float32)).to(dev, dtype)
        out = ell_matvec(vals, cols, xs)
        plain = ell_spmv_plain(vals.T, cols.T, xs)
        _, rel = rel_err(out, plain)
        rv, rc, rx = (torch.from_numpy(a).to(dev) for a in
                      ragged_ell(n, k, rng))
        s = sliced_operands(rv.T.to(dtype), rc.T)
        rx = rx.to(dtype)
        ref = ell_spmv_plain(*s[:2], rx, s.slice_k, s.perm)
        rels = [rel]
        for block_n in (32, 256):
            got = ell_matvec_t(*s[:2], rx, block_n=block_n,
                               slice_k=s.slice_k, perm=s.perm)
            rels.append(rel_err(got, ref)[1])
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
        if not max(rels) <= tol:
            raise AssertionError(f"ell_spmv ({n},{k},{dtype}): {rels}")
        sweep.append({"kernel": "ell_spmv", "n": n, "k": k,
                      "dtype": str(dtype), "rel_err": rel,
                      "sliced_rel_err": max(rels[1:])})
    for n, m, dtype, offset in (
            (128, 64, torch.float32, 0), (1000, 333, torch.float32, 0),
            (4096, 1024, torch.bfloat16, 0), (1000, 1001, torch.float32, 1),
            (4096, 4099, torch.bfloat16, 1), (150_000, 150_001,
                                              torch.float32, 3)):
        xs = torch.from_numpy(rng.standard_normal(n).astype(
            np.float32)).to(dev, dtype)
        ids = rng.integers(0, n, m).astype(np.int32)
        ids[::7] = -1
        ids[1::9] = n + 3
        ids_t = torch.from_numpy(np.concatenate(
            [np.zeros(offset, np.int32), ids])).to(dev)[offset:]
        buf = torch.full((m + offset,), float("nan"), dtype=dtype,
                         device=dev)
        got = pack(xs, ids_t, out=buf[offset:])
        want = pack_plain(xs, ids_t)
        words = torch.int32 if dtype == torch.float32 else torch.int16
        if not (torch.equal(got.view(words), want.view(words)) and
                bool(buf[:offset].isnan().all())):
            raise AssertionError(f"pack ({n},{m},{dtype},+{offset}) "
                                 "differs")
        sweep.append({"kernel": "pack", "n": n, "m": m,
                      "dtype": str(dtype), "out_offset": offset,
                      "exact": True})
    return {"ell_spmv": calls, "pack": [pack_call], "sweep": sweep}


def attention_inputs(dev, batch, heads, seq, head_dim, seed=0):
    """q, k, v as the flash_attention space draws them (float32)."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(
        (batch, heads, seq, head_dim)).astype(np.float32)).to(dev)
        for _ in range(3)]


# tests/test_kernels.py:118-156: causal sweep (ragged S, bf16, a head dim
# padded to 64), cross-attention, decode alignment: (q shape, kv shape,
# dtype, causal).
# Then the bf16 route at each of those shapes, and grouped-query cases
# (q heads on H / g kv heads, g = 5 and 2) in both dtypes.
ATTN_SWEEP = [((2, 3, 256, 64), (2, 3, 256, 64), torch.float32, True),
              ((1, 2, 300, 64), (1, 2, 300, 64), torch.float32, True),
              ((2, 2, 256, 128), (2, 2, 256, 128), torch.bfloat16, True),
              ((1, 2, 64, 48), (1, 2, 64, 48), torch.float32, True),
              ((1, 2, 128, 64), (1, 2, 256, 64), torch.float32, False),
              ((1, 1, 128, 64), (1, 1, 384, 64), torch.float32, True),
              ((2, 3, 256, 64), (2, 3, 256, 64), torch.bfloat16, True),
              ((1, 2, 300, 64), (1, 2, 300, 64), torch.bfloat16, True),
              ((1, 2, 64, 48), (1, 2, 64, 48), torch.bfloat16, True),
              ((1, 2, 128, 64), (1, 2, 256, 64), torch.bfloat16, False),
              ((1, 1, 128, 64), (1, 1, 384, 64), torch.bfloat16, True),
              ((2, 10, 256, 128), (2, 2, 256, 128), torch.bfloat16, True),
              ((1, 4, 300, 64), (1, 2, 300, 64), torch.bfloat16, True),
              ((2, 10, 256, 128), (2, 2, 256, 128), torch.float32, True),
              ((1, 4, 128, 64), (1, 2, 384, 64), torch.float32, True)]


def sweep_inputs():
    """Each ``ATTN_SWEEP`` case with its q, k, v as float32 numpy arrays,
    drawn in order from one seeded generator."""
    rng = np.random.default_rng(0)
    return [(case, [rng.standard_normal(sh).astype(np.float32)
                    for sh in (case[0], case[1], case[1])])
            for case in ATTN_SWEEP]


def float64_attention(a, dtype, causal) -> torch.Tensor:
    """The sweep's oracle: a float64 softmax on the CPU of the inputs
    ``a`` (q, k, v as float32 numpy arrays, (B, H, S, D), k and v with
    H / g heads, q head h reading kv head h // g) rounded to ``dtype``
    first, scaled by the true head dim, causal mask right-aligned."""
    q, k, v = (torch.from_numpy(t).to(dtype).double() for t in a)
    g = q.shape[1] // k.shape[1]
    k, v = (t.repeat_interleave(g, dim=1) for t in (k, v))
    s = q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5
    if causal:
        sq, skv = s.shape[-2:]
        live = torch.arange(skv)[None, :] <= \
            torch.arange(sq)[:, None] + (skv - sq)
        s = s.masked_fill(~live, float("-inf"))
    return torch.softmax(s, -1) @ v


def sweep_diagnosis(a, dtype, causal, on_card, on_cpu, ref, dev) -> str:
    """What a failed sweep case saw, for its error message: whether a
    second launch on the same inputs gives the same bits (the kernel has
    no atomics and each output element one writer, so it must), the card's
    and the CPU's distance from the float64 oracle ``ref``, the worst
    element, and the card's ECC counters."""
    from repro_torch.kernels.flash_attention.ops import mha

    again = mha(*(torch.from_numpy(t).to(dev, dtype) for t in a),
                causal=causal)
    same = bool(torch.equal(again, on_card))
    d = (on_card.cpu().double() - ref).abs()
    worst = np.unravel_index(int(d.argmax()), tuple(d.shape))
    return (f"a second launch gives the same bits: {same}; card vs float64 "
            f"{float(d.max())}, CPU vs float64 "
            f"{float((on_cpu.double() - ref).abs().max())}; worst element "
            f"{tuple(int(i) for i in worst)}; ECC {ecc_line()}")


def phase_attention(dev) -> dict:
    """The flash-attention kernel at the autotune instance's shapes
    (default blocks 128 x 128) against its plain version and SDPA, and
    on the reference sweep's cases (through ``mha``'s padding) against a
    float64 softmax of the same inputs (``float64_attention``). The CPU
    float32 plain path's distance from float64 is reported beside the
    kernel's; it is not what the kernel is held to, since it differs
    between processes (PERF.md)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention.ops import attention_plain, mha

    b, h, s, d = (ATTN[k] for k in ("batch", "heads", "seq", "head_dim"))
    q, k, v = attention_inputs(dev, b, h, s, d)
    qf, kf, vf = (t.reshape(b * h, s, d) for t in (q, k, v))
    out = torch.empty_like(qf)
    scale = d ** -0.5

    def kernel():
        return fa_k.flash_attention(qf, kf, vf, out, causal=True,
                                    block_q=128, block_k=128, scale=scale)

    got = kernel().clone()
    plain = attention_plain(qf, kf, vf, causal=True, scale=scale)
    torch.cuda.synchronize()
    err, rel = rel_err(got, plain)
    if not err <= 2e-5:
        raise AssertionError(f"flash_attention: max abs err {err} > 2e-5")
    # Useful causal work: query i meets i + 1 keys (S = Sq = Skv), two
    # flops per multiply-add in q.k and in p.v; each of q, k, v read
    # once and the output written once. The kernel runs them on the
    # tensor cores in 3xTF32: three TF32 products for each float32 one.
    pairs = b * h * s * (s + 1) / 2
    flops = 4.0 * pairs * d
    n_bytes = 4 * q.numel() * q.element_size()
    bnd, by = bound_ms(n_bytes, 3 * flops, TF32_FLOPS_PER_S)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    lib_err = float((sdpa().reshape(b * h, s, d) - plain).abs().max())
    call = {
        "op": "mha", "shape": [b, h, s, d], "dtype": "float32",
        "causal": True, "block_q": 128, "block_k": 128, "flops": flops,
        "bytes": n_bytes, "max_abs_err": err, "rel_err": rel,
        "ms": time_cuda(kernel, iters=10),
        "plain_ms": time_cuda(lambda: attention_plain(
            qf, kf, vf, causal=True, scale=scale), iters=5),
        "library_ms": time_cuda(sdpa, iters=10),
        "library_kernel": device_kernel(sdpa),
        "library_max_abs_err": lib_err,
        "bound_ms": bnd, "bound_by": by,
        "bound_ms_f32_cores": bound_ms(n_bytes, flops)[0]}
    del plain, got

    sweep = []
    for (qs, ks, dtype, causal), a in sweep_inputs():
        on_card = mha(*(torch.from_numpy(t).to(dev, dtype) for t in a),
                      causal=causal)
        on_cpu = mha(*(torch.from_numpy(t).to(dtype) for t in a),
                     causal=causal)
        ref = float64_attention(a, dtype, causal)
        e = float((on_card.cpu().double() - ref).abs().max())
        tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
        if not e <= tol:
            raise AssertionError(
                f"mha {qs} {ks} {dtype}: {e} > {tol} from float64; "
                + sweep_diagnosis(a, dtype, causal, on_card, on_cpu, ref,
                                  dev))
        sweep.append({"q": list(qs), "kv": list(ks), "dtype": str(dtype),
                      "causal": causal, "max_abs_err": e,
                      "oracle": "float64",
                      "cpu_plain_vs_float64": float(
                          (on_cpu.double() - ref).abs().max()),
                      "kernel_vs_cpu_plain": float(
                          (on_card.float().cpu() - on_cpu.float())
                          .abs().max())})
    return {"flash_attention": [call], "sweep": sweep}


def onehot_matrix(dev):
    """The paper's n and nnz on a narrow band (half-width 512)."""
    from repro_torch.spmv.matrix import band_matrix

    A = band_matrix(n=PAPER_N, nnz=PAPER_NNZ, half_bandwidth=ONEHOT_HB,
                    seed=0)
    x = np.random.default_rng(1).standard_normal(PAPER_N).astype(
        np.float32)
    return A, x, (torch.from_numpy(A.vals).to(dev),
                  torch.from_numpy(A.cols).to(dev),
                  torch.from_numpy(x).to(dev))


def phase_onehot(dev) -> dict:
    """The narrow-band kernel at the band matrix's shapes against its
    plain version, beside ell_spmv and torch.mv on the same matrix, and
    on the reference sweep's cases."""
    from repro_torch.kernels.spmv.kernel import ell_onehot
    from repro_torch.kernels.spmv.ops import (ell_matvec_onehot,
                                              ell_matvec_t,
                                              ell_onehot_plain,
                                              onehot_operands)

    A, x_np, (vals, cols, x) = onehot_matrix(dev)
    br, window = ONEHOT_BLOCK_R, 2 * ONEHOT_HB + ONEHOT_BLOCK_R
    vt, cwt, xp = onehot_operands(vals, cols, x, ONEHOT_HB, br)
    out = torch.empty(vt.shape[1], dtype=torch.float32, device=dev)

    def kernel():
        return ell_onehot(vt, cwt, xp, out, window, br)

    got = kernel().clone()
    plain = ell_onehot_plain(vt, cwt, xp, window, br)
    torch.cuda.synchronize()
    err, rel = rel_err(got, plain)
    if not rel <= 1e-5:
        raise AssertionError(f"ell_onehot: rel err {rel} > 1e-5")
    oracle = A.matvec(x_np)
    y_rel = float(np.abs(got[:PAPER_N].cpu().numpy() - oracle).max() /
                  np.abs(oracle).max())
    if not y_rel <= 1e-5:
        raise AssertionError(f"ell_onehot vs f64 oracle: {y_rel} > 1e-5")
    k, n = vt.shape
    nnz = int((vals != 0).sum())
    # Each slot's value and window column once, x_pad once, y once.
    n_bytes = k * n * 8 + xp.numel() * 4 + n * 4
    bnd, by = bound_ms(n_bytes, 2.0 * nnz)
    vals_t, cols_t = vals.T.contiguous(), cols.T.contiguous()
    spmv_out = torch.empty(PAPER_N, dtype=torch.float32, device=dev)
    csr = csr_of(vals_t, cols_t, PAPER_N)
    call = {
        "op": "ell_matvec_onehot", "K": k, "N": n, "nnz": nnz,
        "half_bandwidth": ONEHOT_HB, "block_r": br, "window": window,
        "bytes": n_bytes, "max_abs_err": err, "rel_err": rel,
        "oracle_rel_err": y_rel,
        **cold_warm_floor(kernel, (n // br, br), dev),
        "plain_ms": time_cuda(lambda: ell_onehot_plain(vt, cwt, xp, window,
                                                       br)),
        "library_ms": time_cuda(lambda: torch.mv(csr, x)),
        "ell_spmv_ms": time_cuda(lambda: ell_matvec_t(vals_t, cols_t, x,
                                                      out=spmv_out)),
        "bound_ms": bnd, "bound_by": by}

    # tests/test_kernels.py:41-72, and a row count that is not a
    # multiple of block_r.
    sweep = []
    for n_, k_, hb, block_r in ((256, 4, 32, 64), (512, 8, 64, 128),
                                (384, 3, 48, 128), (300, 5, 40, 128)):
        rng = np.random.default_rng(n_)
        offs = rng.integers(-hb, hb + 1, size=(n_, k_))
        c = ((np.arange(n_)[:, None] + offs) % n_).astype(np.int32)
        va = rng.standard_normal((n_, k_)).astype(np.float32)
        xx = rng.standard_normal(n_).astype(np.float32)
        on_card = ell_matvec_onehot(*(torch.from_numpy(t).to(dev)
                                      for t in (va, c, xx)), hb, block_r)
        on_cpu = ell_matvec_onehot(*(torch.from_numpy(t)
                                     for t in (va, c, xx)), hb, block_r)
        _, r = rel_err(on_card.cpu(), on_cpu)
        if not r <= 1e-5:
            raise AssertionError(f"ell_onehot ({n_},{k_},{hb},{block_r}): "
                                 f"{r}")
        sweep.append({"n": n_, "k": k_, "hb": hb, "block_r": block_r,
                      "rel_err": r})
    return {"ell_onehot": [call], "sweep": sweep}


def phase_onehot_path(dev) -> dict:
    """One call of the narrow-band SpMV's entry point at full size."""
    from repro_torch.kernels.spmv import kernel as spmv_k
    from repro_torch.kernels.spmv.ops import ell_matvec_onehot

    A, x_np, (vals, cols, x) = onehot_matrix(dev)
    spmv_k.ell_onehot.launches = 0
    y = ell_matvec_onehot(vals, cols, x, ONEHOT_HB, ONEHOT_BLOCK_R)
    torch.cuda.synchronize()
    launches = spmv_k.ell_onehot.launches
    oracle = A.matvec(x_np)
    rel = float(np.abs(y.cpu().numpy() - oracle).max() /
                np.abs(oracle).max())
    if not (rel <= 1e-5 and y.shape == (PAPER_N,) and launches == 1):
        raise AssertionError(f"onehot path: rel {rel}, launches {launches}")
    return {"launches": {"ell_onehot": launches}, "y_rel_err": rel}


def ranks(a) -> np.ndarray:
    """Ranks 0..n-1, ties given their mean rank."""
    a = np.asarray(a, dtype=np.float64)
    r = np.empty(len(a))
    r[np.argsort(a, kind="stable")] = np.arange(len(a), dtype=np.float64)
    for v in np.unique(a):
        tied = a == v
        if tied.sum() > 1:
            r[tied] = r[tied].mean()
    return r


def spearman(a, b) -> float:
    return float(np.corrcoef(ranks(a), ranks(b))[0, 1])


def phase_autotune(dev) -> dict:
    import tempfile

    from repro_torch.engine import make_evaluator
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.pack import kernel as pack_k
    from repro_torch.kernels.spmv import kernel as spmv_k
    from repro_torch.rules import distill
    from repro_torch.search import ExhaustiveSearch, MCTSSearch, run_search
    from repro_torch.space import make_space

    sp = make_space("flash_attention", **ATTN)
    n_cand = sp.n_candidates()
    out: dict = {"space": sp.signature, "candidates": n_cand}
    # The gate's tolerance: float32 softmax over 4096 keys in two orders
    # (online in the kernel, whole rows in the reference) differs by a
    # few 1e-6 (the kernels phase's max_abs_err); the evaluator's
    # default atol of 1e-6 is for small instances.
    gate = {"repeats": 5, "warmup": 2, "atol": 1e-5}
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "flash_attention.store")
        ev = make_evaluator(sp, "wallclock", store_path=store, **gate)
        fa_k.flash_attention.launches = 0
        t0 = time.perf_counter()
        with ev:
            res = run_search(sp, MCTSSearch(sp, seed=0), ev, budget=32)
        wall = time.perf_counter() - t0
        launches = fa_k.flash_attention.launches
        if launches <= 0:
            raise AssertionError("the flash-attention kernel never ran")
        if not (len(res.schedules) == ev.n_checked == n_cand == 16):
            raise AssertionError(f"{ev.n_checked} gated, "
                                 f"{len(res.schedules)} of {n_cand} "
                                 "candidates measured")
        report = distill(res)
        print(report.render(), flush=True)
        if "performance class" not in report.render():
            raise AssertionError("no rules table")
        times = res.times_array()
        best, t_best = res.best()
        worst = res.schedules[int(times.argmax())]
        out.update({
            "objective": ev.objective_key(), "proposed": res.n_proposed,
            "measured": res.cache_misses, "gated": ev.n_checked,
            "best": sp.describe(best), "best_ms": t_best * 1e3,
            "worst": sp.describe(worst),
            "worst_ms": float(times.max()) * 1e3,
            "times_ms": {sp.describe(c): t * 1e3
                         for c, t in zip(res.schedules, res.times)},
            "classes": report.labeling.n_classes,
            "class_sizes": np.bincount(report.labeling.labels).tolist(),
            "features": len(report.feature_matrix.features),
            "tree_leaves": report.tree.n_leaves(),
            "tree_depth": report.tree.depth(),
            "tree_error": report.training_error, "search_wall_s": wall,
            "launches": {"flash_attention": launches}})

        # A second sweep with a fresh evaluator (no store): do the
        # candidates rank the same?
        ev2 = make_evaluator(sp, "wallclock", **gate)
        res2 = run_search(sp, ExhaustiveSearch(sp), ev2, budget=n_cand)
        again = dict(zip(res2.schedules, res2.times))
        t2 = np.array([again[c] for c in res.schedules])
        out["sweep2"] = {"best": sp.describe(res2.best()[0]),
                         "best_ms": res2.best()[1] * 1e3,
                         "worst_ms": float(t2.max()) * 1e3,
                         "spearman_rho": spearman(times, t2)}

        # Warm replay from the store: zero measurements.
        n0 = fa_k.flash_attention.launches
        ev3 = make_evaluator(sp, "wallclock", store_path=store, **gate)
        with ev3:
            warm = run_search(sp, MCTSSearch(sp, seed=0), ev3, budget=32)
        if not (warm.cache_misses == 0 and warm.store_hits == n_cand and
                warm.times == res.times and
                fa_k.flash_attention.launches == n0):
            raise AssertionError(
                f"warm replay measured {warm.cache_misses}, "
                f"{warm.store_hits} store hits")
        out["warm_replay"] = {"measured": warm.cache_misses,
                              "store_hits": warm.store_hits}

    # The other two kernels' grids, swept exhaustively and gated.
    for name, kw, counter in (
            ("spmv_mulsum", {"n": PAPER_N, "k": 10}, spmv_k.ell_spmv),
            ("pack", {"n": PAPER_N, "m": PAPER_N}, pack_k.pack)):
        sp = make_space(name, **kw)
        ev = make_evaluator(sp, "wallclock", repeats=20, warmup=3)
        counter.launches = 0
        r = run_search(sp, ExhaustiveSearch(sp), ev,
                       budget=sp.n_candidates())
        if ev.n_checked != sp.n_candidates() or counter.launches <= 0:
            raise AssertionError(f"{name}: {ev.n_checked} gated, "
                                 f"{counter.launches} launches")
        b, tb = r.best()
        out[name] = {"space": sp.signature, "best": sp.describe(b),
                     "best_us": tb * 1e6,
                     "times_us": {sp.describe(c): t * 1e6
                                  for c, t in zip(r.schedules, r.times)},
                     "gated": ev.n_checked, "launches": counter.launches}
    return out


COPY_WORDS = ("copy", "index", "fill", "pad", "repeat", "cat")


def kernel_summary(ks: dict, wall: float) -> dict:
    """A part of a profile: wall ms, device ms summed over kernels, the
    idle share, the flash kernel's ms, matrix products (kernels named
    nvjet, gemm, xmma or cutlass: cuBLAS's) and the rest, the six
    largest kernels by name, and the copies (kernels whose names hold
    one of ``COPY_WORDS``: what widening, transposing and padding
    launch) by name."""
    busy = sum(ks.values())
    flash = sum(t for k, t in ks.items() if "flash_fwd" in k)
    gemm = sum(t for k, t in ks.items() if any(
        w in k.lower() for w in ("gemm", "xmma", "cutlass", "nvjet")))
    copies = {k: t for k, t in ks.items()
              if any(w in k.lower() for w in COPY_WORDS)}
    return {"wall_ms": wall, "device_ms": busy,
            "idle_share": max(0.0, 1 - busy / wall), "flash_ms": flash,
            "gemm_ms": gemm, "other_ms": busy - flash - gemm,
            "copy_ms": sum(copies.values()), "copies": copies,
            "top": {k: t for k, t in list(ks.items())[:6]}}


def embedded(model, tokens, frontend, cfg):
    """(the decoder's input, the encoder's memory or None) in
    ``cfg.dtype``: ``LM._embed_inputs`` and ``LM._encode`` at another
    activation dtype than the model's own."""
    from repro_torch.models.blocks import block_forward
    from repro_torch.models.layers import embed_tokens, rmsnorm

    dt = getattr(torch, cfg.dtype)
    x = embed_tokens(model.embed, tokens, dt)
    fe = None if frontend is None else \
        frontend.to(dt) @ model.embed["frontend_proj"].to(dt)
    memory = None
    if model.enc_stage is not None:
        memory = fe
        for p, desc in zip(model.encoder, model.enc_stage.layers):
            memory, _ = block_forward(p, memory, cfg, desc, None)
        memory = rmsnorm(memory, model.enc_norm, cfg.rms_eps)
    elif fe is not None:
        x = torch.cat([fe, x], dim=1)
    return x, memory


def route_divergence(model, tokens, dtype: str, frontend=None) -> dict:
    """The kernel and the plain attention route through the model's
    decoder layers in ``dtype`` activations. At each causal
    self-attention layer, both routes' attention on the kernel route's q,
    k, v (max |o_kernel - o_plain| / max |o_plain|: the kernel's error on
    this layer's inputs); Mamba and RWKV layers pass through
    ``block_forward``. Both routes also run free from the same embedding
    (max and mean |x_kernel - x_plain| / the plain route's: how far an
    error travels). The kernel launches here are outside the path's
    count."""
    import dataclasses

    from repro_torch.models import attention as attn
    from repro_torch.models.blocks import block_forward
    from repro_torch.models.layers import rmsnorm, rope

    cfg = dataclasses.replace(model.cfg, dtype=dtype)
    out: dict = {"attn_rel": [], "resid_rel_max": [], "resid_rel_mean": []}
    with torch.inference_mode():
        xk, memory = embedded(model, tokens, frontend, cfg)
        xp = xk
        pos = torch.arange(xk.shape[1], device=xk.device)
        for p, desc in zip(model.decoder, model.descs):
            if desc.kind == "attn":
                h = rmsnorm(xk, p["norm_mix"], cfg.rms_eps)
                q, k, v = attn.project_qkv(p["mixer"], h, h, cfg)
                q = rope(q, pos, cfg.rope_theta)
                k = rope(k, pos, cfg.rope_theta)
                k, v = attn.repeat_kv(cfg, k), attn.repeat_kv(cfg, v)
                ok = attn.self_attention(q, k, v, cfg, None, causal=True)
                op = attn.self_attention(q, k, v, cfg, None, causal=True,
                                         attention="plain")
                out["attn_rel"].append(rel_err(ok, op)[1])
                del h, q, k, v, ok, op
            xk, _ = block_forward(p, xk, cfg, desc, None, memory=memory)
            xp, _ = block_forward(p, xp, cfg, desc, None, memory=memory,
                                  attention="plain")
            d = (xk.float() - xp.float()).abs()
            out["resid_rel_max"].append(
                float(d.max() / xp.float().abs().max()))
            out["resid_rel_mean"].append(
                float(d.mean() / xp.float().abs().mean()))
    out["attn_rel_max"] = max(out["attn_rel"], default=None)
    return out


def phase_serve(dev) -> dict:
    """The dense serving path at qwen2.5-32b's full width (depth cut to
    SERVE["n_layers"]): weights drawn on the card, Engine.generate on
    batch x prompt tokens, the flash kernel counted; prefill and decode
    timed; the prefill's logits against the plain attention route on the
    same weights; the flash kernel alone at the prefill's shape against
    its plain version and SDPA; one prefill and one decode step
    profiled."""
    import dataclasses

    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention.ops import attention_plain
    from repro_torch.models.model import LM
    from repro_torch.serve.engine import Engine, make_serve_step

    full = get_config(SERVE["arch"])
    cfg = dataclasses.replace(full, n_layers=SERVE["n_layers"])
    b, s, new = SERVE["batch"], SERVE["prompt"], SERVE["new"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LM(cfg, device=dev, seed=SERVE["seed"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = torch.from_numpy(np.random.default_rng(SERVE["seed"] + 1)
                               .integers(0, cfg.vocab, (b, s))).to(dev)
    t_max = s + new
    engine = Engine(model, t_max=t_max)
    engine.generate(prompts[:, :128], 2)            # warm-up (cuBLAS)

    # The path: one generate, the kernel counted from 0.
    fa_k.flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = engine.generate(prompts, new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = fa_k.flash_attention.launches
    peak = torch.cuda.max_memory_allocated()
    if launches != cfg.n_layers:
        raise AssertionError(f"serve: {launches} flash launches in one "
                             f"prefill of {cfg.n_layers} layers")

    # Prefill and decode by CUDA events.
    def prefill():
        return model.prefill(prompts, t_max)

    prefill_ms = time_cuda(prefill, iters=3, cold=False)
    logits, caches = prefill()
    step = make_serve_step(model)
    tok = logits[:, -1].argmax(-1)[:, None]
    step_ms = []
    with torch.inference_mode():
        for i in range(new - 1):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "01")
            e0.record()
            tok, _, caches = step(caches, tok, s + i)
            e1.record()
            torch.cuda.synchronize()
            step_ms.append(e0.elapsed_time(e1))
    decode_ms = statistics.median(step_ms)

    # The plain attention route on the same weights: the prefill's
    # logits and the greedy continuation from its caches.
    n0 = fa_k.flash_attention.launches
    p_logits, p_caches = model.prefill(prompts, t_max, attention="plain")
    if fa_k.flash_attention.launches != n0:
        raise AssertionError("the plain route launched the kernel")
    ptok = [p_logits[:, -1].argmax(-1)[:, None]]
    for i in range(new - 1):
        t_next, _, p_caches = step(p_caches, ptok[-1], s + i)
        ptok.append(t_next)
    ptok = torch.cat(ptok, dim=1)
    finite = bool(torch.isfinite(logits).all()) and \
        bool(torch.isfinite(p_logits).all())
    err, rel = rel_err(logits, p_logits)
    agree = float((ptok == tokens).float().mean())
    peak_plain = torch.cuda.max_memory_allocated()
    del p_caches, p_logits

    diverge = {name: route_divergence(model, prompts, name)
               for name in SERVE_ATTN_TOL}

    # The flash kernel alone at the prefill's shape, bfloat16: as served
    # (q and the output (B, S, 40, D), k and v (B, S, 8, D), as the
    # projections leave them: q head h reads kv head h // 5 in the
    # kernel) and widened (every head its own k and v, (BH, S, D)).
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = (t.to(torch.bfloat16) for t in attention_inputs(
        dev, b, h, s, d, seed=3))
    scale = d ** -0.5
    pairs = b * h * s * (s + 1) / 2
    flops = 4.0 * pairs * d

    def flash_call(shape, qk, kk, vk, sdpa_args, sdpa_kw):
        out = torch.empty_like(qk)

        def kernel():
            return fa_k.flash_attention(qk, kk, vk, out, causal=True,
                                        block_q=128, block_k=128,
                                        scale=scale)

        def plain():
            return attention_plain(qk, kk, vk, causal=True, scale=scale)

        def sdpa():
            return F.scaled_dot_product_attention(*sdpa_args,
                                                  is_causal=True, **sdpa_kw)

        got = kernel().clone()
        ref = plain()
        k_err, k_rel = rel_err(got, ref)
        if not k_err <= 3e-2:
            raise AssertionError(f"flash_attention bf16 {shape}: max abs "
                                 f"err {k_err}")
        lib = sdpa()                         # (B, H, S, D)
        if len(shape) == 5:                  # served: (B, S, H, D) here
            lib = lib.transpose(1, 2)
        lib_err = float((lib.reshape(ref.shape).float() - ref.float())
                        .abs().max())
        n_bytes = sum(t.numel() * t.element_size()
                      for t in (qk, kk, vk, out))
        bnd, by = bound_ms(n_bytes, flops, BF16_FLOPS_PER_S)
        return {
            "op": "flash_attention", "shape": shape, "dtype": "bfloat16",
            "causal": True, "block_q": 128, "block_k": 128, "flops": flops,
            "bytes": n_bytes, "max_abs_err": k_err, "rel_err": k_rel,
            "ms": time_cuda(kernel, iters=20),
            "plain_ms": time_cuda(plain, iters=5),
            "library_ms": time_cuda(sdpa, iters=20),
            "library_call": "scaled_dot_product_attention(is_causal=True"
                            + "".join(f", {k}={v}" for k, v in
                                      sdpa_kw.items()) + ")",
            "library_kernel": None,          # from the profile below
            "library_max_abs_err": lib_err,
            "bound_ms": bnd, "bound_by": by}, sdpa

    # Served: (B, S, H, D) buffers, the kernel's own layout.
    qs = q.transpose(1, 2).contiguous()
    ks, vs = (t[:, :hkv].transpose(1, 2).contiguous() for t in (k, v))
    flash, sdpa_gqa = flash_call(
        [b, s, h, hkv, d], qs, ks, vs,
        [t.transpose(1, 2) for t in (qs, ks, vs)], {"enable_gqa": True})
    qf, kf, vf = (t.reshape(b * h, s, d) for t in (q, k, v))
    widened, sdpa_wide = flash_call([b, h, s, d], qf, kf, vf, [q, k, v], {})
    flash["at_widened_shape"] = widened
    del qs, ks, vs

    # Where the time goes: one prefill and one decode step profiled, and
    # SDPA's kernel named, in one profiler session.
    trace = os.path.join(ROOT, "chiprun_out", "serve_trace.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    parts = traced_kernels(
        {"prefill": prefill,
         "decode_step": lambda: step(caches, tok, s + new - 2),
         "sdpa": lambda: [sdpa_gqa() for _ in range(3)],
         "sdpa_widened": lambda: [sdpa_wide() for _ in range(3)]}, trace)
    flash["library_kernel"] = next(iter(parts.pop("sdpa")[0]))
    widened["library_kernel"] = next(iter(parts.pop("sdpa_widened")[0]))
    prof = {k: kernel_summary(*v) for k, v in parts.items()}
    prof["trace"] = os.path.relpath(trace, ROOT)
    del caches
    # The profiler slows the host: the idle share of an unprofiled decode
    # step is its device ms over the steps' median by CUDA events.
    prof["decode_step"]["idle_share_events"] = max(
        0.0, 1 - prof["decode_step"]["device_ms"] / decode_ms)

    res = {
        "arch": SERVE["arch"], "config": dataclasses.asdict(cfg),
        "reduced": {"n_layers": [full.n_layers, cfg.n_layers]},
        "params": model.n_params(), "param_dtype": cfg.param_dtype,
        "dtype": cfg.dtype, "batch": b, "prompt_tokens": s,
        "new_tokens": new, "init_s": init_s, "generate_s": gen_s,
        "tokens_per_s": b * new / gen_s,
        "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
        "decode_tokens_per_s": b / decode_ms * 1e3,
        "decode_ms_all": step_ms,
        "max_memory_allocated": peak,
        "max_memory_allocated_with_plain": peak_plain,
        "launches": {"flash_attention": launches},
        "max_abs_logit": float(logits.float().abs().max()),
        "max_abs_dlogit_vs_plain": err, "rel_dlogit_vs_plain": rel,
        "token_agreement": agree, "finite": finite,
        "route_divergence": diverge, "profile": prof,
        "flash_attention": flash}
    if not finite:
        raise AssertionError("serve: non-finite logits")
    for name, d in diverge.items():
        if not d["attn_rel_max"] <= SERVE_ATTN_TOL[name]:
            raise AssertionError(
                f"serve: {name} kernel-vs-plain attention differs by "
                f"{d['attn_rel_max']} of max |o| > {SERVE_ATTN_TOL[name]}")
    if tokens.shape != (b, new):
        raise AssertionError(f"serve: tokens of shape {tuple(tokens.shape)}")
    return res

def kernel_classes(ks: dict, wall: float) -> dict:
    """A profiled part's device ms by kernel class: matrix products
    (cuBLAS's gemm/xmma/cutlass/nvjet), copies and casts (``.to``,
    ``contiguous`` and ``cat``: PyTorch's copy kernels), the flash
    kernel, and the rest (the recurrences' and norms' elementwise work
    and reductions); the idle share and the five largest kernels."""
    busy = sum(ks.values())
    cls = {"products_ms": 0.0, "copies_casts_ms": 0.0, "flash_ms": 0.0,
           "other_elementwise_ms": 0.0}
    for k, t in ks.items():
        low = k.lower()
        if "flash_fwd" in k:
            cls["flash_ms"] += t
        elif any(w in low for w in ("gemm", "xmma", "cutlass", "nvjet")):
            cls["products_ms"] += t
        elif "copy" in low or "cat" in low:
            cls["copies_casts_ms"] += t
        else:
            cls["other_elementwise_ms"] += t
    return {"wall_ms": wall, "device_ms": busy, "kernel_names": len(ks),
            "idle_share": max(0.0, 1 - busy / wall), **cls,
            "top": {k: t for k, t in list(ks.items())[:5]}}


def cache_check(model, tokens, frontend, dtype: str) -> dict:
    """Layer by layer in ``dtype`` activations: the decoder layer's
    input over P + 1 positions (the full forward's), block_forward's
    output at position P against block_decode's for that token from the
    cache block_prefill left after P positions (KV, conv/h, shift/s,
    ck/cv), as a share of max |y| at P (and of max |y - x| there, the
    layer's own update). MoE layers run dropless on both sides:
    capacity_factor E / top_k makes the capacity the whole sequence."""
    import dataclasses

    from repro_torch.models.blocks import (block_decode, block_forward,
                                           block_prefill)

    cfg = dataclasses.replace(model.cfg, dtype=dtype)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    rel, rel_upd = [], []
    with torch.inference_mode():
        x, memory = embedded(model, tokens, frontend, cfg)
        last = x.shape[1] - 1
        for p, desc in zip(model.decoder, model.descs):
            y, _ = block_forward(p, x, cfg, desc, None, memory=memory)
            _, _, cache = block_prefill(p, x[:, :last], cfg, desc, None,
                                        last + 1, memory=memory)
            yd, _ = block_decode(p, x[:, last:], cfg, desc, last, cache)
            ref, got = y[:, last].float(), yd[:, 0].float()
            d = float((got - ref).abs().max())
            rel.append(d / float(ref.abs().max()))
            rel_upd.append(d / float((ref - x[:, last].float()).abs().max()))
            del cache, yd
            x = y
    return {"rel": rel, "rel_max": max(rel), "rel_of_update": rel_upd,
            "rel_of_update_max": max(rel_upd), "position": last}


def family_run(arch: str, dev) -> dict:
    """One configuration of the families phase (FAMILIES[arch]) through
    the port's serving entry points: LM on the card, Engine.generate on
    batch x prompt tokens (behind the VLM prefix; whisper's frames into
    its encoder), the flash kernel counted; prefill and decode by CUDA
    events; the prefill's MoE drops; one prefill and one decode step
    profiled; the kernel against the plain route at every causal
    attention layer (route_divergence) and the teacher-forced cache
    check (cache_check), in bf16 and f32."""
    import dataclasses
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.models import moe
    from repro_torch.models.model import LM
    from repro_torch.serve.engine import Engine, make_serve_step

    run = FAMILIES[arch]
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=run.get("n_layers",
                                                     full.n_layers))
    reduced = {} if cfg.n_layers == full.n_layers else \
        {"n_layers": [full.n_layers, cfg.n_layers]}
    b, s, new = run["batch"], run["prompt"], run["new"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LM(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (b, s))).to(dev)
    frontend = None
    if cfg.frontend is not None:
        gen = torch.Generator(device=dev).manual_seed(2)
        frontend = torch.randn((b, cfg.frontend.n_positions,
                                cfg.frontend.d_frontend), generator=gen,
                               device=dev)
    n_front = model.n_front
    t_max = n_front + s + new
    engine = Engine(model, t_max=t_max)
    engine.generate(prompts[:, :64], 2, frontend=frontend)   # warm-up
    want_flash = sum(d.kind == "attn" and d.causal for d in model.descs)

    # The path: one generate, the kernel counted from 0.
    fa_k.flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = engine.generate(prompts, new, frontend=frontend)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = fa_k.flash_attention.launches
    peak = torch.cuda.max_memory_allocated()
    if launches != want_flash:
        raise AssertionError(f"families {arch}: {launches} flash launches "
                             f"in one prefill, {want_flash} causal "
                             "attention layers")
    if tokens.shape != (b, new):
        raise AssertionError(f"families {arch}: tokens of shape "
                             f"{tuple(tokens.shape)}")

    def prefill():
        return model.prefill(prompts, t_max, frontend=frontend)

    def events_ms(fn, n):
        out = []
        for _ in range(n):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "01")
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            out.append(e0.elapsed_time(e1))
        return out

    prefill_all = events_ms(prefill, 3)
    logits, caches = prefill()
    finite = bool(torch.isfinite(logits).all())
    step = make_serve_step(model)
    tok = logits[:, -1].argmax(-1)[:, None]
    step_ms = []
    with torch.inference_mode():
        for i in range(new - 1):
            def one(i=i):
                nonlocal tok, caches
                tok, _, caches = step(caches, tok, n_front + s + i)
            step_ms += events_ms(one, 1)
    decode_ms = statistics.median(step_ms)

    # What the prefill's capacity (capacity_factor as configured) drops.
    drops = None
    if cfg.moe is not None:
        seen = []
        positions = moe._positions

        def recording(top_e, e, c):
            pos, keep = positions(top_e, e, c)
            seen.append(((~keep).sum(), keep.numel()))
            return pos, keep
        moe._positions = recording
        try:
            prefill()
        finally:
            moe._positions = positions
        per_layer = [float(d) / n for d, n in seen]
        drops = {"capacity_factor": cfg.moe.capacity_factor,
                 "share": sum(float(d) for d, _ in seen) /
                 sum(n for _, n in seen),
                 "share_by_layer": per_layer}

    # Where the time goes: one prefill and one decode step profiled.
    with tempfile.TemporaryDirectory() as tmp:
        parts = traced_kernels(
            {"prefill": prefill,
             "decode_step": lambda: step(caches, tok, n_front + s + new - 1)},
            os.path.join(tmp, "trace.json"))
    prof = {k: kernel_classes(*v) for k, v in parts.items()}
    # The profiler slows the host: the idle share of an unprofiled call
    # is its device ms over its median by CUDA events.
    for k, ms in (("prefill", statistics.median(prefill_all)),
                  ("decode_step", decode_ms)):
        prof[k]["idle_share_events"] = max(0.0, 1 - prof[k]["device_ms"] / ms)
    del caches, logits

    # Correctness: the kernel at every causal attention layer, and the
    # caches against the full-sequence form, on the first sequences.
    nb = min(2, b)
    check_tokens = torch.cat([prompts[:nb], tokens[:nb, :1]], dim=1)
    check_front = None if frontend is None else frontend[:nb]
    diverge = None
    if want_flash:
        diverge = {name: route_divergence(model, prompts, name, frontend)
                   for name in SERVE_ATTN_TOL}
    caches_ok = {name: cache_check(model, check_tokens, check_front, name)
                 for name in ("bfloat16", "float32")}

    res = {
        "arch": arch, "family": cfg.family, "reduced": reduced,
        "widths": {"d_model": cfg.d_model, "n_heads": cfg.n_heads,
                   "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
                   "d_ff": cfg.d_ff, "vocab": cfg.vocab,
                   "moe": None if cfg.moe is None else
                   dataclasses.asdict(cfg.moe),
                   "frontend": None if cfg.frontend is None else
                   dataclasses.asdict(cfg.frontend)},
        "layers": [d.kind + ("+moe" if d.moe else "") +
                   ("+cross" if d.cross else "") for d in model.descs],
        "params": model.n_params(), "param_dtype": cfg.param_dtype,
        "dtype": cfg.dtype, "batch": b, "prompt_tokens": s,
        "prefix_positions": n_front, "new_tokens": new, "init_s": init_s,
        "generate_s": gen_s, "tokens_per_s": b * new / gen_s,
        "prefill_ms": statistics.median(prefill_all),
        "prefill_ms_all": prefill_all,
        "prefill_tokens_per_s": b * (n_front + s) /
        statistics.median(prefill_all) * 1e3,
        "decode_ms_per_token": decode_ms,
        "decode_tokens_per_s": b / decode_ms * 1e3,
        "decode_ms_all": step_ms, "max_memory_allocated": peak,
        "launches": {"flash_attention": launches},
        "causal_attention_layers": want_flash, "moe_drops": drops,
        "finite": finite, "profile": prof, "route_divergence": diverge,
        "cache_check": caches_ok, "check_batch": nb}
    if not finite:
        raise AssertionError(f"families {arch}: non-finite logits")
    for name, d in (diverge or {}).items():
        if not d["attn_rel_max"] <= SERVE_ATTN_TOL[name]:
            raise AssertionError(
                f"families {arch}: {name} kernel-vs-plain attention "
                f"differs by {d['attn_rel_max']} of max |o|")
    got = caches_ok["bfloat16"]["rel_max"]
    if not got <= FAMILY_CACHE_TOL:
        raise AssertionError(f"families {arch}: bf16 decode from the "
                             f"caches differs by {got} of max |y|")
    return res


def phase_families() -> dict:
    """Each FAMILIES configuration by family_run in a process of its own
    (``chip_smoke.py --family ARCH``, which prints its result as its
    last line); one ``families`` line each. A process that fails fails
    the phase."""
    out = {}
    for arch in FAMILIES:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--family", arch],
            capture_output=True, text=True, timeout=FAMILY_TIMEOUT_S,
            cwd=ROOT)
        if proc.returncode != 0:
            raise AssertionError(
                f"families {arch}: exit {proc.returncode}\n"
                f"{proc.stderr[-6000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["process_s"] = time.perf_counter() - t0
        emit("families", **res)
        out[arch] = res
    return out


def family_main(arch: str) -> int:
    """The child of phase_families: one configuration, its result as
    one JSON line."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.device import resolve_device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(family_run(arch, resolve_device())), flush=True)
    return 0


def restart_run(dev) -> dict:
    """The restart gate's two runs on the card: one that fails at
    RESTART["fail_at"] and resumes from its last checkpoint, one
    uninterrupted. Returns the largest |difference| of any parameter
    between them (0.0: bit for bit) and the mean wall ms per step."""
    import tempfile

    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import DataConfig, batch_for
    from repro_torch.ft.restart import LoopConfig, TrainLoop
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.step import make_train_step

    cfg = get_reduced(RESTART["arch"])
    model = LM(cfg, device=dev, seed=0)
    opt = AdamW(learning_rate=RESTART["lr"])
    start = {k: v.detach().clone() for k, v in model.named_parameters()}

    def fresh():
        p = {k: v.clone() for k, v in start.items()}
        return p, opt.init(p)

    step = make_train_step(model, opt)
    dcfg = DataConfig(seq_len=RESTART["seq"], global_batch=RESTART["batch"],
                      vocab=cfg.vocab)

    def bf(s):
        return batch_for(dcfg, s, cfg)

    scratch = os.path.join(ROOT, "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        loop = TrainLoop(step, bf, CheckpointStore(os.path.join(tmp, "a")),
                         LoopConfig(total_steps=RESTART["steps"],
                                    ckpt_every=RESTART["ckpt_every"]))
        try:
            loop.run(*fresh(), fail_at=RESTART["fail_at"])
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
        else:
            raise AssertionError("restart: the injected failure never came")
        resumed_from = loop.store.latest_step()
        p1, _ = loop.resume(*fresh())
        p1 = {k: v.detach().clone() for k, v in p1.items()}
        ref = TrainLoop(step, bf, CheckpointStore(os.path.join(tmp, "b")),
                        LoopConfig(total_steps=RESTART["steps"],
                                   ckpt_every=100))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p2, _ = ref.run(*fresh())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    diff = max(float((p1[k] - p2[k].detach()).abs().max())
               for k in p1)
    return {"max_abs_diff": diff, "bit_exact": diff == 0.0 and all(
                torch.equal(p1[k], p2[k]) for k in p1),
            "resumed_from": resumed_from,
            "ms_per_step": wall / RESTART["steps"] * 1e3}


def layer_times(model, tokens, iters: int = 3) -> dict:
    """One layer of ``model`` at the train shape, as the train-step DAG
    prices it: forward with autograd recording (no layer checkpoint) and
    its backward to the input and the layer's parameters, by CUDA events
    (medians of ``iters``); and the plain attention inside it alone."""
    from repro_torch.models import attention as attn
    from repro_torch.models.blocks import block_forward
    from repro_torch.models.layers import embed_tokens, rmsnorm, rope

    cfg, p, desc = model.cfg, model.decoder[0], model.descs[0]
    with torch.no_grad():
        x0 = embed_tokens(model.embed, tokens, model.dtype)
        h = rmsnorm(x0, p["norm_mix"], cfg.rms_eps)
        q, k, v = attn.project_qkv(p["mixer"], h, h, cfg)
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        q, k = rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta)
    params = list(p.parameters())

    def run(fn, inputs):
        ms = {"fwd": [], "bwd": []}
        for _ in range(iters + 1):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            y = fn()
            ev[1].record()
            torch.autograd.grad(y, inputs, torch.ones_like(y))
            ev[2].record()
            torch.cuda.synchronize()
            ms["fwd"].append(ev[0].elapsed_time(ev[1]))
            ms["bwd"].append(ev[1].elapsed_time(ev[2]))
            del y
        return {key: statistics.median(t[1:]) for key, t in ms.items()}

    x = x0.detach().requires_grad_(True)
    layer = run(lambda: block_forward(p, x, cfg, desc, None,
                                      attention="plain")[0], [x, *params])
    qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
    att = run(lambda: attn.self_attention(*qkv, cfg, None, causal=True,
                                          attention="plain"), qkv)
    return {"layer_fwd_ms": layer["fwd"], "layer_bwd_ms": layer["bwd"],
            "attention_fwd_ms": att["fwd"], "attention_bwd_ms": att["bwd"],
            # The rest of the layer: its products, norms, rope and casts,
            # the work the DAG's 2N flops a token count.
            "rest_fwd_ms": layer["fwd"] - att["fwd"],
            "rest_bwd_ms": layer["bwd"] - att["bwd"]}


def phase_train(dev) -> dict:
    """The training substrate at qwen2.5-32b's full width (depth cut to
    TRAIN["n_layers"]): make_train_step (plain attention, layer and
    KV-block remat) under AdamW on lm_batch data, fwd / bwd / optimizer
    timed by CUDA events, one step profiled; the trained model's eval
    loss through the flash kernel and the plain route; one layer's fwd
    and bwd beside the train-step DAG's price of them; and the restart
    gate at the reduced smollm config."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.data.pipeline import DataConfig, lm_batch
    from repro_torch.launch.costs import (PEAK_FLOPS, costs_from_arch,
                                          model_flops, train_step_machine)
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    from repro_torch.train.step import make_train_step

    t_phase = time.perf_counter()
    full = get_config(TRAIN["arch"])
    cfg = dataclasses.replace(full, n_layers=TRAIN["n_layers"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LM(cfg, device=dev, seed=TRAIN["seed"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = model.n_params()
    n_steps = TRAIN["steps"]
    opt = AdamW(learning_rate=warmup_cosine(3e-3, 20, n_steps + 2))
    dcfg = DataConfig(seed=TRAIN["seed"], seq_len=TRAIN["seq"],
                      global_batch=TRAIN["batch"], vocab=cfg.vocab)
    events: list = []

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.append((name, e))

    step = make_train_step(model, opt, marks=mark)
    params = dict(model.named_parameters())
    ostate = opt.init(params)

    # The path: warm-up, timed steps, a profiled step and the eval, every
    # kernel counted from 0.
    kernels = kernel_counters()
    for kern in kernels.values():
        kern.launches = 0
    losses, parts = [], {"fwd": [], "bwd": [], "opt": []}
    for s in range(n_steps + 1):
        events.clear()
        mark("start")
        params, ostate, met = step(params, ostate, lm_batch(dcfg, s))
        torch.cuda.synchronize()
        losses.append(float(met["loss"]))
        if s:
            at = dict(events)
            parts["fwd"].append(at["start"].elapsed_time(at["forward"]))
            parts["bwd"].append(at["forward"].elapsed_time(at["backward"]))
            parts["opt"].append(at["backward"].elapsed_time(at["optimizer"]))
    step_peak = torch.cuda.max_memory_allocated()
    trace = os.path.join(ROOT, "chiprun_out", "train_trace.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    batch = lm_batch(dcfg, n_steps + 1)
    ks, wall = traced_kernels(
        {"train_step": lambda: step(params, ostate, batch)},
        trace)["train_step"]
    prof = kernel_summary(ks, wall)
    # Of the products, those on float32 CUDA cores (cuBLAS's ffma
    # kernels): the plain attention's einsums.
    prof["gemm_f32_ms"] = sum(t for k, t in ks.items() if "f32f32" in k)
    prof["trace"] = os.path.relpath(trace, ROOT)
    eval_batch = lm_batch(dcfg, n_steps + 2)
    with torch.no_grad():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        loss_flash, _ = model.loss(eval_batch)
        ev[1].record()
        loss_plain, _ = model.loss(eval_batch, attention="plain")
        ev[2].record()
        torch.cuda.synchronize()
    launches = {name: kern.launches for name, kern in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    loss_flash, loss_plain = float(loss_flash), float(loss_plain)
    eval_rel = abs(loss_flash - loss_plain) / abs(loss_plain)

    # The optimizer state freed first: the attention check and one
    # layer's activations and gradients need a few GB.
    del ostate, params
    torch.cuda.empty_cache()
    # The kernel against the plain route at the train shape, on the
    # trained model's q, k, v, layer by layer (launches outside the
    # count above).
    div = route_divergence(model, eval_batch["tokens"].to(dev),
                           cfg.dtype)
    # One layer beside the DAG's price of it.
    lt = layer_times(model, eval_batch["tokens"].to(dev))
    del model
    torch.cuda.empty_cache()
    dag = costs_from_arch(TRAIN["arch"], full.n_layers,
                          tokens_per_chip=TRAIN["seq"] * TRAIN["batch"],
                          tp=1, dp=1)
    mach = train_step_machine()
    priced = {}
    for part, flops, nbytes in (("fwd", dag.fwd_flops, dag.fwd_bytes),
                                ("bwd", dag.bwd_flops, dag.bwd_bytes)):
        priced[part] = {
            "flops": flops, "bytes": nbytes,
            "flop_term_ms": flops / mach.flops_per_s * 1e3,
            "byte_term_ms": nbytes / mach.hbm_bytes_per_s * 1e3,
            "ms": mach.gpu_duration(flops, nbytes) * 1e3,
            "measured_ms": lt[f"layer_{part}_ms"],
            "measured_rest_ms": lt[f"rest_{part}_ms"]}

    restart = restart_run(dev)

    step_ms = [f + b + o for f, b, o in zip(*parts.values())]
    step_med = statistics.median(step_ms)
    tokens = TRAIN["seq"] * TRAIN["batch"]
    shape = SHAPES["train_4k"]
    mflops_6n = model_flops(cfg, "train_4k") / shape.global_batch * \
        TRAIN["batch"]
    # The share counts matrix products: the input embedding's table
    # (vocab x d_model, 22% of the parameters at 4 layers) is a gather,
    # so its 6 flops a parameter a token are taken out of 6N. The head
    # is a product and stays.
    mflops = mflops_6n - 6.0 * cfg.vocab * cfg.d_model * tokens
    res = {
        "arch": TRAIN["arch"], "config": dataclasses.asdict(cfg),
        "reduced": {"n_layers": [full.n_layers, cfg.n_layers]},
        "params": n_params, "param_dtype": cfg.param_dtype,
        "dtype": cfg.dtype, "batch": TRAIN["batch"], "seq": TRAIN["seq"],
        "attention": "plain (train step); flash and plain (eval)",
        "init_s": init_s, "steps": n_steps,
        "fwd_ms": parts["fwd"], "bwd_ms": parts["bwd"],
        "opt_ms": parts["opt"], "step_ms": step_ms,
        "step_ms_median": step_med,
        "tokens_per_s": tokens / step_med * 1e3,
        "model_flops_per_step": mflops,
        "model_flop_share": mflops / (step_med * 1e-3 * PEAK_FLOPS),
        "model_flops_per_step_6n_with_embedding": mflops_6n,
        "model_flop_share_6n_with_embedding":
            mflops_6n / (step_med * 1e-3 * PEAK_FLOPS),
        "peak_flops_per_s": PEAK_FLOPS,
        "losses": losses, "finite": all(np.isfinite(losses)),
        "max_memory_allocated_step": step_peak,
        "max_memory_allocated": peak,
        "headroom_bytes": torch.cuda.get_device_properties(dev)
        .total_memory - peak,
        "profile": prof,
        "eval_loss_flash": loss_flash, "eval_loss_plain": loss_plain,
        "eval_rel_diff": eval_rel, "eval_tol": TRAIN_EVAL_TOL,
        "route_divergence": div,
        "attn_tol": SERVE_ATTN_TOL["bfloat16"],
        "eval_flash_ms": ev[0].elapsed_time(ev[1]),
        "eval_plain_ms": ev[1].elapsed_time(ev[2]),
        "launches": launches,
        "per_layer": {**lt, "dag_price": priced,
                      "dag": "costs_from_arch(qwen2.5-32b, 64, "
                             "tokens_per_chip=4096, tp=1, dp=1) under "
                             "train_step_machine()"},
        "restart": restart, "wall_s": time.perf_counter() - t_phase}
    if not res["finite"]:
        raise AssertionError(f"train: non-finite losses {losses}")
    if launches["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"train: {launches['flash_attention']} flash "
                             f"launches in one eval of {cfg.n_layers} "
                             "layers")
    if not eval_rel <= TRAIN_EVAL_TOL:
        raise AssertionError(f"train: flash eval loss {loss_flash} vs "
                             f"plain {loss_plain} ({eval_rel} > "
                             f"{TRAIN_EVAL_TOL})")
    if not div["attn_rel_max"] <= SERVE_ATTN_TOL["bfloat16"]:
        raise AssertionError(f"train: flash attention vs plain at the "
                             f"train shape: {div['attn_rel_max']} of max "
                             f"|o| > {SERVE_ATTN_TOL['bfloat16']}")
    if not restart["bit_exact"]:
        raise AssertionError(f"train: the restart is not bit-exact "
                             f"(max |diff| {restart['max_abs_diff']})")
    return res


def moe_drops(model, run) -> dict:
    """The share of (token, expert) pairs the MoE layers' capacity
    drops in ``run()``, overall and by layer (``moe._positions``
    recorded)."""
    from repro_torch.models import moe

    seen = []
    positions = moe._positions

    def recording(top_e, e, c):
        pos, keep = positions(top_e, e, c)
        seen.append(((~keep).sum(), keep.numel()))
        return pos, keep
    moe._positions = recording
    try:
        run()
    finally:
        moe._positions = positions
    return {"capacity_factor": model.cfg.moe.capacity_factor,
            "share": sum(float(d) for d, _ in seen) /
            sum(n for _, n in seen),
            "share_by_layer": [float(d) / n for d, n in seen]}


def moe_product_runs(model, batch, chunk) -> dict:
    """How often each MoE layer's two final products run in one
    plain-route loss and in its backward: the routed experts' combine
    (the einsum dispatch's (B, S, E*C) x (B, E*C, d) product, the gather
    dispatch's scatter-add of the weighted slots to their tokens) and
    the shared experts' output projection, (B*S, d_shared) x (d_shared,
    d); and, to show that the count sees the layer checkpoint's
    recomputation, the routed experts' input products (wi and wg, (E,
    B*C, d) x (E, d, d_expert)). A dispatch mode counts each when it
    runs with grad enabled: a forward op or one the recomputation runs
    again (a gradient's own products run without; the dispatch's input
    gradient has the combine's signature, the shared experts' input
    gradient the projection's). Each runs once per MoE layer in the
    forward; the recomputation (non-reentrant, it stops once the tensors
    the backward saved are rebuilt) runs the experts' input products
    again and neither final product (the combine is the last op that
    saves a tensor, and the shared projection's output is kept,
    ``layers.kept``). On the CPU too (``tests/test_torch_moe_remat.py``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models.moe import _capacity

    cfg = model.cfg
    mc = cfg.moe
    ec = mc.n_experts * _capacity(batch["tokens"].shape[1], mc)
    shared = (mc.d_expert * mc.n_shared, cfg.d_model)
    seen = {what: {"forward": 0, "backward": 0}
            for what in ("combine", "shared_out", "experts_in")}
    where = ["forward"]

    def what(packet, args):
        if packet in (torch.ops.aten.scatter_add,
                      torch.ops.aten.scatter_add_):
            return "combine"
        if packet is torch.ops.aten.mm and tuple(args[1].shape) == shared:
            return "shared_out"
        if packet is torch.ops.aten.bmm:
            if args[0].shape[-1] == ec and \
                    tuple(args[1].shape[-2:]) == (ec, cfg.d_model):
                return "combine"
            if tuple(args[1].shape[-2:]) == (cfg.d_model, mc.d_expert):
                return "experts_in"
        return None

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kind = what(func._overloadpacket, args)
            if kind is not None and torch.is_grad_enabled():
                seen[kind][where[0]] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        loss, _ = model.loss(batch, attention="plain", rwkv_chunk=chunk)
        where[0] = "backward"
        grads = torch.autograd.grad(loss, list(model.parameters()))
    del grads
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    return dict(seen, moe_layers=sum(d.moe for d in model.descs),
                shared_experts=mc.n_shared)


def moe_product_faults(runs: dict) -> list[str]:
    """What ``moe_product_runs`` saw that it should not have: each
    final product other than once per MoE layer in the forward or at all
    in the backward (the shared projection only where there are shared
    experts), the experts' input products not recomputed."""
    n = runs["moe_layers"]
    want = {"combine": {"forward": n, "backward": 0},
            "shared_out": {"forward": n if runs["shared_experts"] else 0,
                           "backward": 0},
            "experts_in": {"forward": 2 * n, "backward": 2 * n}}
    return [f"{k} ran {runs[k]}, not {v}" for k, v in want.items()
            if runs[k] != v]


def train_family_run(arch: str, dev) -> dict:
    """One configuration of the train_families phase (TRAIN_FAMILIES,
    not jamba's): make_train_step under AdamW on batch_for's batches
    (lm_batch tokens; whisper's frames and internvl2's patches from
    frontend_batch), one warm-up step, then ``steps`` with CUDA events
    around forward, backward and optimizer; the trained model's eval
    loss through the flash kernel (counted) against the plain route's;
    deepseek-moe-16b also one step profiled, its drops and, layer by
    layer, the kernel against the plain route (route_divergence)."""
    import dataclasses
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.data.pipeline import DataConfig, batch_for
    from repro_torch.launch.costs import PEAK_FLOPS, model_flops
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    from repro_torch.train.step import make_train_step

    run = TRAIN_FAMILIES[arch]
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=run.get("n_layers",
                                                     full.n_layers))
    reduced = {} if cfg.n_layers == full.n_layers else \
        {"n_layers": [full.n_layers, cfg.n_layers]}
    b, s, n_steps = run["batch"], run["seq"], run["steps"]
    chunk = run.get("rwkv_chunk")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LM(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    opt = AdamW(learning_rate=warmup_cosine(3e-3, 20, n_steps + 2))
    dcfg = DataConfig(seed=0, seq_len=s, global_batch=b, vocab=cfg.vocab)
    events: list = []

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.append((name, e))

    step = make_train_step(model, opt, rwkv_chunk=chunk, marks=mark)
    params = dict(model.named_parameters())
    ostate = opt.init(params)
    kernels = kernel_counters()
    for kern in kernels.values():
        kern.launches = 0
    losses, aux, parts = [], [], {"fwd": [], "bwd": [], "opt": []}
    for i in range(n_steps + 1):
        batch = batch_for(dcfg, i, cfg)      # drawn on the host, untimed
        events.clear()
        mark("start")
        params, ostate, met = step(params, ostate, batch)
        torch.cuda.synchronize()
        losses.append(float(met["loss"]))
        aux.append(float(met["aux"]))
        if i:
            at = dict(events)
            parts["fwd"].append(at["start"].elapsed_time(at["forward"]))
            parts["bwd"].append(at["forward"].elapsed_time(at["backward"]))
            parts["opt"].append(at["backward"].elapsed_time(at["optimizer"]))
    step_peak = torch.cuda.max_memory_allocated()
    prof = None
    if run.get("profile"):
        batch = batch_for(dcfg, n_steps + 1, cfg)
        with tempfile.TemporaryDirectory() as tmp:
            ks, wall = traced_kernels(
                {"train_step": lambda: step(params, ostate, batch)},
                os.path.join(tmp, "trace.json"))["train_step"]
        prof = kernel_classes(ks, wall)
    eval_batch = batch_for(dcfg, n_steps + 2, cfg)
    with torch.no_grad():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        loss_flash, _ = model.loss(eval_batch, rwkv_chunk=chunk)
        ev[1].record()
        loss_plain, _ = model.loss(eval_batch, attention="plain",
                                   rwkv_chunk=chunk)
        ev[2].record()
        torch.cuda.synchronize()
    launches = {name: kern.launches for name, kern in kernels.items()}
    # One slot-position launch a MoE layer a forward: the train steps'
    # (warm-up, timed, profiled), again in each layer checkpoint's
    # recomputation, and the two evals'.
    n_moe = sum(d.moe for d in model.descs)
    steps_run = n_steps + 1 + bool(run.get("profile"))
    want_positions = n_moe * ((2 if cfg.remat else 1) * steps_run + 2)
    peak = torch.cuda.max_memory_allocated()
    loss_flash, loss_plain = float(loss_flash), float(loss_plain)
    eval_rel = abs(loss_flash - loss_plain) / abs(loss_plain)
    want_flash = sum(d.kind == "attn" and d.causal for d in model.descs)
    del ostate, params
    torch.cuda.empty_cache()
    drops = div = None
    products = None
    if cfg.moe is not None:
        with torch.no_grad():
            drops = moe_drops(model, lambda: model.loss(eval_batch))
        if cfg.remat:
            products = moe_product_runs(model, eval_batch, chunk)
    if run.get("profile"):
        div = route_divergence(model, eval_batch["tokens"].to(dev),
                               cfg.dtype)

    step_ms = [f + bw + o for f, bw, o in zip(*parts.values())]
    step_med = statistics.median(step_ms)
    res = {
        "arch": arch, "family": cfg.family, "reduced": reduced,
        "params": model.n_params(), "param_dtype": cfg.param_dtype,
        "dtype": cfg.dtype, "batch": b, "seq": s, "rwkv_chunk": chunk,
        "prefix_positions": model.n_front,
        "moe": None if cfg.moe is None else dataclasses.asdict(cfg.moe),
        "attention": "plain (train step); flash and plain (eval)",
        "init_s": init_s, "steps": n_steps, "fwd_ms": parts["fwd"],
        "bwd_ms": parts["bwd"], "opt_ms": parts["opt"],
        "step_ms": step_ms, "step_ms_median": step_med,
        "tokens_per_s": b * s / step_med * 1e3, "losses": losses,
        "aux": aux, "finite": all(np.isfinite(losses)),
        "max_memory_allocated_step": step_peak,
        "max_memory_allocated": peak, "profile": prof, "moe_drops": drops,
        "eval_loss_flash": loss_flash, "eval_loss_plain": loss_plain,
        "eval_rel_diff": eval_rel, "eval_tol": TRAIN_EVAL_TOL,
        "eval_flash_ms": ev[0].elapsed_time(ev[1]),
        "eval_plain_ms": ev[1].elapsed_time(ev[2]),
        "launches": launches, "causal_attention_layers": want_flash,
        "moe_layers": n_moe, "positions_launches_want": want_positions,
        "route_divergence": div, "attn_tol": SERVE_ATTN_TOL["bfloat16"],
        "moe_product_runs": products}
    if s == SHAPES["train_4k"].seq_len:
        # 6 N D on the active parameters (the routed top-k of each MoE
        # layer) plus the causal attention term, for this step's tokens.
        mflops = model_flops(cfg, "train_4k") / \
            SHAPES["train_4k"].global_batch * b
        res["model_flops_per_step"] = mflops
        res["model_flop_share"] = mflops / (step_med * 1e-3 * PEAK_FLOPS)
        res["active_params"] = cfg.active_param_count()
    if not res["finite"]:
        raise AssertionError(f"train_families {arch}: non-finite losses "
                             f"{losses}")
    if launches["flash_attention"] != want_flash:
        raise AssertionError(f"train_families {arch}: "
                             f"{launches['flash_attention']} flash launches "
                             f"in one eval, {want_flash} causal attention "
                             "layers")
    if launches["moe_positions"] != want_positions:
        raise AssertionError(f"train_families {arch}: "
                             f"{launches['moe_positions']} slot-position "
                             f"launches, {want_positions} wanted "
                             f"({n_moe} MoE layers, {steps_run} steps, "
                             f"remat {cfg.remat}, 2 evals)")
    if not eval_rel <= TRAIN_EVAL_TOL:
        raise AssertionError(f"train_families {arch}: flash eval loss "
                             f"{loss_flash} vs plain {loss_plain} "
                             f"({eval_rel} > {TRAIN_EVAL_TOL})")
    if div is not None and not div["attn_rel_max"] <= \
            SERVE_ATTN_TOL["bfloat16"]:
        raise AssertionError(f"train_families {arch}: flash attention vs "
                             f"plain: {div['attn_rel_max']} of max |o|")
    faults = moe_product_faults(products) if products else []
    if faults:
        raise AssertionError(f"train_families {arch}: the MoE layers' "
                             f"products: {'; '.join(faults)}")
    return res


def mamba_layer_run(dev) -> dict:
    """jamba-v0.1-52b's Mamba mixer (its first layer's, full width),
    float32 parameters drawn on the card from seed 0, inside a layer
    checkpoint as LM._run_stage runs it: fwd+bwd at 1 x 4,096 tokens in
    bf16 activations, chunked (the path) and as one flat loop (the
    contrast), each one's peak above what it starts with against the
    bound from the per-chunk states; and at 512 tokens in f32
    activations the card's gradients against the CPU's on the same
    parameters, input and loss."""
    import dataclasses

    from torch.utils.checkpoint import checkpoint

    from repro_torch.configs import get_config
    from repro_torch.models import mamba
    from repro_torch.models import params as prm

    run = TRAIN_FAMILIES["jamba-v0.1-52b"]
    cfg = get_config("jamba-v0.1-52b")
    specs = mamba.mamba_specs(cfg)
    p = prm.Params(specs, device=dev, dtype=torch.float32)
    prm.init(p, specs, torch.Generator(device=dev).manual_seed(0))
    p.requires_grad_(True)
    b, s = run["batch"], run["seq"]
    di, n = cfg.mamba_expand * cfg.d_model, cfg.mamba_d_state
    gen = torch.Generator(device=dev).manual_seed(1)

    def grads_of(params, x, c, w):
        """The mixer's gradients under a layer checkpoint, the loss a
        fixed random projection ``w`` of its output."""
        y = checkpoint(lambda t: mamba.mamba_forward(params, t, c)[0], x,
                       use_reentrant=False)
        return torch.autograd.grad((y.float() * w).sum(),
                                   list(params.parameters()))

    x = torch.randn((b, s, cfg.d_model), generator=gen, device=dev).to(
        torch.bfloat16)
    w = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)
    grads_of(p, x, cfg, w)                                   # warm-up
    torch.cuda.synchronize()
    c = mamba.chunk_len(s)
    out: dict = {"chunk": c, "n_chunks": s // c}
    for name in ("chunked", "flat"):
        chunk_len = mamba.chunk_len
        if name == "flat":
            mamba.chunk_len = lambda _s: 1
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            grads = grads_of(p, x, cfg, w)
            ev[1].record()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
        finally:
            mamba.chunk_len = chunk_len
        out[name] = {"fwd_bwd_ms": ev[0].elapsed_time(ev[1]),
                     "peak_above_start": peak,
                     "finite_grads": all(bool(torch.isfinite(g).all())
                                         for g in grads)}
        del grads
    # The bound, before any reading: the full-sequence tensors autograd
    # holds in the layer's backward (its recomputed forward and their
    # gradients), at most 12 f32 (B, S, d_inner) tensors' worth
    # (1.5 GiB here), plus the state a checkpoint holds between chunks
    # (n_chunks x (B, d_inner, N) f32, 16 MiB) and one chunk's steps
    # recomputed and differentiated (8 (B, d_inner, N) f32 tensors a
    # step, 512 MiB). A flat loop holds ~4 such tensors for every one of
    # the S steps instead (8 GiB).
    state = b * di * n * 4
    out["peak_bound"] = 12 * b * s * di * 4 + out["n_chunks"] * state + \
        8 * c * state
    out["flat_steps_bytes_estimate"] = 4 * s * state

    # Card vs CPU at check_seq tokens, float32 activations.
    sc = run["check_seq"]
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    cpu = prm.Params(specs, device=torch.device("cpu"), dtype=torch.float32)
    with torch.no_grad():
        for a, t in zip(p.parameters(), cpu.parameters()):
            t.copy_(a.cpu())
    cpu.requires_grad_(True)
    xs = torch.randn((b, sc, cfg.d_model), generator=gen, device=dev)
    ws = torch.randn((b, sc, cfg.d_model), generator=gen, device=dev)
    g_card = [g.cpu() for g in grads_of(p, xs, cfg32, ws)]
    g_cpu = grads_of(cpu, xs.cpu(), cfg32, ws.cpu())
    rel = {name: float((gg - gc).abs().max() / gc.abs().max())
           for (name, _), gc, gg in zip(cpu.named_parameters(), g_cpu,
                                        g_card)}
    out["grad_check"] = {"tokens": sc, "dtype": "float32",
                         "rel_by_param": rel, "rel_max": max(rel.values()),
                         "tol": MAMBA_GRAD_TOL}
    out.update({"arch": "jamba-v0.1-52b", "what": "Mamba mixer of layer 0",
                "reduced": {"n_layers": [cfg.n_layers, "one mixer"]},
                "params": prm.count(specs), "batch": b, "seq": s,
                "d_model": cfg.d_model, "d_inner": di, "d_state": n,
                "dtype": "bfloat16", "param_dtype": "float32"})
    if not out["chunked"]["finite_grads"]:
        raise AssertionError("train_families jamba: non-finite gradients")
    if not out["chunked"]["peak_above_start"] <= out["peak_bound"]:
        raise AssertionError(f"train_families jamba: peak "
                             f"{out['chunked']['peak_above_start']} B "
                             f"above the start, bound {out['peak_bound']}")
    if not out["grad_check"]["rel_max"] <= MAMBA_GRAD_TOL:
        raise AssertionError(f"train_families jamba: card vs CPU gradients "
                             f"{out['grad_check']['rel_max']} of max |g|")
    return out


def phase_train_families() -> dict:
    """Each TRAIN_FAMILIES configuration in a process of its own
    (``chip_smoke.py --train-family ARCH``, its result as its last
    line); one ``train_families`` line each. A process that fails fails
    the phase."""
    out = {}
    for arch in TRAIN_FAMILIES:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--train-family",
             arch], capture_output=True, text=True,
            timeout=TRAIN_FAMILY_TIMEOUT_S, cwd=ROOT)
        if proc.returncode != 0:
            raise AssertionError(
                f"train_families {arch}: exit {proc.returncode}\n"
                f"{proc.stderr[-6000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["process_s"] = time.perf_counter() - t0
        emit("train_families", **res)
        out[arch] = res
    return out


def train_family_main(arch: str) -> int:
    """The child of phase_train_families: one configuration, its result
    as one JSON line."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.device import resolve_device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device()
    res = mamba_layer_run(dev) if arch == "jamba-v0.1-52b" else \
        train_family_run(arch, dev)
    print(json.dumps(res), flush=True)
    return 0


def dist_dryrun() -> dict:
    """The child ``--dist dryrun``: DIST["dryrun_shapes"] of DIST["arch"]
    through launch/dryrun.py's run_cell on the 16x16 mesh (a fake group
    of 256 ranks in this process, no card): per-GPU bytes, dot FLOPs,
    collective bytes by kind and by mesh axis, the roofline's terms on
    the H100 constants, wall seconds."""
    import pathlib

    from repro_torch.launch import dryrun

    out = {}
    for shape in DIST["dryrun_shapes"]:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(
            DIST["arch"], shape, multi_pod=False, force=True,
            out_dir=pathlib.Path(ROOT) / "chiprun_out" / "dryrun")
        mem, hlo, rl = rec["memory_analysis"], rec["hlo"], rec["roofline"]
        out[shape] = {
            "mesh": rec["mesh"], "gpus": rec["chips"],
            "microbatches": rec["meta"].get("microbatches"),
            "argument_bytes": mem["argument_size_in_bytes"],
            "temp_bytes": mem["temp_size_in_bytes"],
            "output_bytes": mem["output_size_in_bytes"],
            "alias_bytes": mem["alias_size_in_bytes"],
            "per_gpu_bytes": rec["per_device_bytes"],
            "dot_flops_per_gpu": hlo["dot_flops_per_chip"],
            "collective_bytes": hlo["collective_bytes"],
            "collective_count": hlo["collective_count"],
            "collective_bytes_by_axis": hlo["collective_bytes_by_axis"],
            "roofline": {k: rl[k] for k in (
                "compute_s", "memory_s", "collective_s", "dominant",
                "step_time_s", "model_flops_ratio", "roofline_fraction")},
            "run_s": rec["timings"]["run_s"],
            "wall_s": time.perf_counter() - t0}
        if not out[shape]["dot_flops_per_gpu"] > 0 or \
                not out[shape]["per_gpu_bytes"] > 0:
            raise AssertionError(f"dist dryrun {shape}: nothing counted")
    return out


def free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def dist_card(dev, backend: str = "nccl", cfg=None,
              seq: int | None = None) -> dict:
    """The child ``--dist card``: the 1x1-mesh train cell and the
    compressed sync on a one-rank ``backend`` group (``cfg``/``seq``
    replace the full-width cut, to rehearse on the CPU with gloo)."""
    import dataclasses

    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES, ShapeCell
    from repro_torch.data.pipeline import DataConfig, lm_batch
    from repro_torch.dist.compress import compressed_psum_mean, init_ef
    from repro_torch.launch import hlo
    from repro_torch.launch.costs import PEAK_FLOPS
    from repro_torch.launch.inputs import build_cell
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.step import make_train_step, place

    t_phase = time.perf_counter()
    dist.init_process_group(backend,
                            init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    mesh = make_local_mesh(1, 1, device_type=dev.type)
    full = get_config(DIST["arch"])
    cfg = cfg or dataclasses.replace(full, n_layers=DIST["card_layers"])
    seq = seq or DIST["card_seq"]
    SHAPES["card_train"] = ShapeCell("card_train", seq, DIST["card_batch"],
                                     "train")
    dcfg = DataConfig(seed=DIST["seed"], seq_len=seq,
                      global_batch=DIST["card_batch"], vocab=cfg.vocab)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # 1. The prediction: the cell on the meta device, nothing allocated.
    t0 = time.perf_counter()
    cell = build_cell(DIST["arch"], "card_train", mesh, cfg=cfg,
                      device="meta", microbatches=1)
    pred, _ = hlo.analyze(cell.fn, *cell.args, mesh=mesh,
                          counter=cell.counter)
    predict_s = time.perf_counter() - t0
    mem = pred.memory
    pred_bytes = mem["argument_size_in_bytes"] + \
        mem["temp_size_in_bytes"] + mem["output_size_in_bytes"] - \
        mem["alias_size_in_bytes"]
    rules = cell.meta["rules"]
    del cell

    # 2. make_train_step on the same card, seed and batch.
    model = LM(cfg, device=dev, seed=DIST["seed"])
    opt = AdamW()
    step = make_train_step(model, opt)
    params = dict(model.named_parameters())
    params, ostate, met = step(params, opt.init(params), lm_batch(dcfg, 0))
    sync()
    plain_loss = met["loss"].detach().cpu()
    plain = {k: p.detach().cpu() for k, p in params.items()}
    del model, step, params, ostate, met
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # 3. The distributed step: build_cell's parameters drawn on the card,
    # the batch placed. The first step is held to make_train_step's; the
    # second is counted by FlopCounterMode (under a dispatch mode some
    # ops round differently, so the compared step runs without it); the
    # third is timed.
    cell = build_cell(DIST["arch"], "card_train", mesh, cfg=cfg,
                      device=dev, seed=DIST["seed"], microbatches=1)
    params, ostate, _ = cell.args

    def placed(step: int) -> dict:
        return {k: place(v.to(dev), mesh, cell.in_shardings[2][k])
                for k, v in lm_batch(dcfg, step).items()}

    params, ostate, met = cell.fn(params, ostate, placed(0))
    sync()
    peak = torch.cuda.max_memory_allocated() if on_card else None

    def local(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t
                ).detach().cpu()

    dist_loss = local(met["loss"])
    worst, unequal = 0.0, []
    for k, ref in plain.items():
        got = local(params[k])
        if not torch.equal(got, ref):
            unequal.append(k)
            d = (got.double() - ref.double()).abs().max().item()
            worst = max(worst, d / max(ref.double().abs().max().item(),
                                       1e-30))
    loss_equal = bool(torch.equal(dist_loss, plain_loss))
    loss_rel = abs(dist_loss.double().item() - plain_loss.double().item()
                   ) / abs(plain_loss.double().item())
    with FlopCounterMode(display=False) as fc:
        params, ostate, met = cell.fn(params, ostate, placed(1))
    sync()
    counted = float(fc.get_total_flops())
    batch2 = placed(2)
    t0 = time.perf_counter()
    params, ostate, met = cell.fn(params, ostate, batch2)
    sync()
    step_s = time.perf_counter() - t0
    del cell, params, ostate, met, batch2, plain
    if on_card:
        torch.cuda.empty_cache()

    # 4. compressed_psum_mean over the one-rank group on one layer's
    # gradients (shapes of decoder layer 0), against the CPU's over a
    # gloo group.
    gen = torch.Generator().manual_seed(DIST["seed"] + 1)
    layer0 = {k[len("decoder.0."):]: v for k, v in
              LM(cfg, device="meta").abstract_params().items()
              if k.startswith("decoder.0.")}
    grads_cpu = {k: torch.randn(v.shape, generator=gen) * 1e-3
                 for k, v in layer0.items()}
    grads = {k: v.to(dev) for k, v in grads_cpu.items()}
    t0 = time.perf_counter()
    synced, ef = compressed_psum_mean(grads, init_ef(grads))
    synced2, ef2 = compressed_psum_mean(grads, ef)
    sync()
    compress_s = time.perf_counter() - t0
    cpu_group = dist.new_group(backend="gloo")
    s_cpu, e_cpu = compressed_psum_mean(grads_cpu, init_ef(grads_cpu),
                                        group=cpu_group)
    s2_cpu, e2_cpu = compressed_psum_mean(grads_cpu, e_cpu, group=cpu_group)
    compress_unequal = [
        f"{what}:{k}" for what, a, b in (("synced", synced, s_cpu),
                                         ("ef", ef, e_cpu),
                                         ("synced2", synced2, s2_cpu),
                                         ("ef2", ef2, e2_cpu))
        for k in a if not torch.equal(a[k].cpu(), b[k])]
    n_grad = sum(v.numel() for v in grads_cpu.values())
    dist.destroy_process_group()

    res = {
        "mesh": [1, 1], "backend": backend, "arch": DIST["arch"],
        "reduced": {"n_layers": [full.n_layers, cfg.n_layers]},
        "batch": DIST["card_batch"], "seq": seq, "rules": rules,
        "predict_s": predict_s,
        "predicted_bytes": pred_bytes, "predicted_memory": mem,
        "predicted_dot_flops": pred.dot_flops,
        "predicted_collective_bytes": pred.total_collective_bytes,
        "counted_dot_flops": counted,
        "flops_rel_diff": abs(pred.dot_flops - counted) / counted,
        "flops_tol": DIST_FLOPS_TOL,
        "max_memory_allocated": peak,
        "predicted_over_measured_bytes":
            pred_bytes / peak if peak else None,
        "loss_plain": plain_loss.item(), "loss_dist": dist_loss.item(),
        "loss_bit_equal": loss_equal, "loss_rel_diff": loss_rel,
        "params_unequal": len(unequal), "params_rel_max": worst,
        "params_unequal_names": unequal[:8],
        "step_rtol": DIST_STEP_RTOL,
        "step_s": step_s,
        "roofline_compute_s": pred.dot_flops / PEAK_FLOPS,
        "compute_term_over_step": pred.dot_flops / PEAK_FLOPS / step_s,
        "compress": {"leaves": len(grads_cpu), "elements": n_grad,
                     "seconds": compress_s,
                     "bit_equal_to_cpu": not compress_unequal,
                     "unequal": compress_unequal[:8]},
        "wall_s": time.perf_counter() - t_phase}
    if not res["flops_rel_diff"] <= DIST_FLOPS_TOL:
        raise AssertionError(f"dist card: predicted {pred.dot_flops} vs "
                             f"counted {counted} dot FLOPs")
    if not (loss_rel <= DIST_STEP_RTOL and worst <= DIST_STEP_RTOL):
        raise AssertionError(f"dist card: the 1x1 step differs from "
                             f"make_train_step (loss {loss_rel}, "
                             f"{len(unequal)} parameters, {worst})")
    if compress_unequal:
        raise AssertionError(f"dist compress: card != cpu in "
                             f"{compress_unequal[:8]}")
    return res


def phase_dist() -> dict:
    """Each part of the dist phase in a process of its own
    (``chip_smoke.py --dist PART``, its result as its last line); one
    ``dist`` line each. The dry run's process sees no card."""
    out = {}
    for part in ("dryrun", "card"):
        env = dict(os.environ)
        if part == "dryrun":
            env["CUDA_VISIBLE_DEVICES"] = ""
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--dist", part],
            capture_output=True, text=True, timeout=DIST_TIMEOUT_S,
            cwd=ROOT, env=env)
        if proc.returncode != 0:
            raise AssertionError(f"dist {part}: exit {proc.returncode}\n"
                                 f"{proc.stderr[-6000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["process_s"] = time.perf_counter() - t0
        emit("dist", part=part, **res)
        out[part] = res
    return out


def dist_main(part: str) -> int:
    """The child of phase_dist: one part, its result as one JSON line."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if part == "dryrun":
        res = dist_dryrun()
    else:
        from repro_torch.device import resolve_device
        res = dist_card(resolve_device())
    print(json.dumps(res), flush=True)
    return 0


def phase_child(flag: str, timeout_s: float) -> dict:
    """A phase in a process of its own (``chip_smoke.py <flag>``, its
    result as its last line): the adamw phase's 44 GB of state freed at
    exit, the positions phase's process group gone with it."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), flag],
        capture_output=True, text=True, timeout=timeout_s, cwd=ROOT)
    if proc.returncode != 0:
        raise AssertionError(f"{flag}: exit {proc.returncode}\n"
                             f"{proc.stderr[-6000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    res["process_s"] = time.perf_counter() - t0
    return res


def adamw_run(dev) -> dict:
    """csrc/adamw.cu at ADAMW's leaves, after one warm-up step: each
    leaf's sum of squares against float64 and its update through the
    kernel against the plain version on copies of the same state (worst
    error over max |value| of p, mu and nu; above ADAMW_TOL fails); then
    CUDA-event medians, the L2 flushed before each call, of the sums of
    squares of all leaves, the updates of all leaves, AdamW.step whole
    (what the benchmark's train.opt_ms times, between the backward's and
    the optimizer's marks) and the plain version's step, beside the
    bytes bound; the launches and the counters of one step under a
    telemetry registry."""
    import dataclasses

    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.kernels.adamw import kernel as adamw_k
    from repro_torch.kernels.adamw import ops as adamw_ops
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import AdamW, global_norm, warmup_cosine

    cfg = dataclasses.replace(get_config(ADAMW["arch"]),
                              n_layers=ADAMW["n_layers"])
    shapes = {k: p.shape for k, p in
              LM(cfg, device="meta").named_parameters()}
    gen = torch.Generator(device=dev).manual_seed(ADAMW["seed"])
    params = {k: torch.randn(s, generator=gen, device=dev).mul_(0.02)
              for k, s in shapes.items()}
    grads = {k: torch.randn(s, generator=gen, device=dev).mul_(1e-3)
             for k, s in shapes.items()}
    n = sum(p.numel() for p in params.values())
    opt = AdamW(learning_rate=warmup_cosine(3e-3, 20, 200),
                grad_clip_norm=1.0)
    state = opt.init(params)
    opt.step(grads, state, params)
    hyper = opt._hyper()

    # Each leaf, kernel against plain, from copies of the same state.
    count, bc1, bc2, lr = opt._begin(state)
    sums, total = adamw_ops.sumsq(list(grads.values()))
    scale = opt._scale(torch.sqrt(total))
    sum_err, worst = 0.0, {"p": 0.0, "mu": 0.0, "nu": 0.0}
    for (k, g), s_k in zip(grads.items(), sums):
        want = float(torch.sum(g.double() ** 2))
        sum_err = max(sum_err, abs(float(s_k) - want) / want)
        runs = []
        for update in (adamw_k.update, adamw_ops.update_plain):
            t = [params[k].clone(), state["mu"][k].clone(),
                 state["nu"][k].clone()]
            update(t[0], g, t[1], t[2], None, scale, bc1, bc2, lr, **hyper)
            runs.append(t)
        for name, got, ref in zip(worst, *runs):
            err = float((got - ref).abs().max() / ref.abs().max())
            worst[name] = max(worst[name], err)
        del runs
    torch.cuda.synchronize()
    if not (max(worst.values()) <= ADAMW_TOL and sum_err <= ADAMW_TOL):
        raise AssertionError(f"adamw: kernel against plain {worst}, sums "
                             f"of squares {sum_err} (tolerance {ADAMW_TOL})")

    leaves = [(params[k], grads[k], state["mu"][k], state["nu"][k])
              for k in params]

    def updates():
        for p, g, mu, nu in leaves:
            adamw_k.update(p, g, mu, nu, None, scale, bc1, bc2, lr, **hyper)

    def plain_step():
        c, b1_, b2_, lr_ = opt._begin(state)
        sc = opt._scale(global_norm(grads))
        for p, g, mu, nu in leaves:
            adamw_ops.update_plain(p, g, mu, nu, None, sc, b1_, b2_, lr_,
                                   **hyper)
        state["count"] = c

    gs = [g for _, g, _, _ in leaves]
    ms = {"sumsq_ms": time_cuda(lambda: adamw_ops.sumsq(gs),
                                iters=ADAMW["iters"]),
          "update_ms": time_cuda(updates, iters=ADAMW["iters"]),
          "step_ms": time_cuda(lambda: opt.step(grads, state, params),
                               iters=ADAMW["iters"]),
          "plain_ms": time_cuda(plain_step, iters=ADAMW["plain_iters"])}
    before = {f: f.launches for f in (adamw_k.sumsq, adamw_k.update)}
    tel = obs.Telemetry()
    with obs.use(tel):
        opt.step(grads, state, params)
    torch.cuda.synchronize()
    launches = {f"adamw_{f.__name__}": f.launches - b
                for f, b in before.items()}
    counters = tel.counters()
    if counters != {"optim.kernel_elems": n, "optim.plain_elems": 0} or \
            launches != {"adamw_sumsq": len(leaves) + 1,
                         "adamw_update": len(leaves)}:
        raise AssertionError(f"adamw: a step counted {counters} and "
                             f"launched {launches}")
    finite = all(bool(torch.isfinite(t).all()) for leaf in leaves
                 for t in leaf)
    if not finite:
        raise AssertionError("adamw: a non-finite parameter or moment")
    bound = {"sumsq_ms": 4 * n, "update_ms": 28 * n, "step_ms": 32 * n,
             "plain_ms": 32 * n}
    return {
        "arch": ADAMW["arch"], "n_layers": ADAMW["n_layers"],
        "leaves": len(leaves), "params": n, **ms,
        "bound_ms": {k: b / HBM_BYTES_PER_S * 1e3 for k, b in bound.items()},
        "share_of_bound": {k: b / HBM_BYTES_PER_S * 1e3 / ms[k]
                           for k, b in bound.items()},
        "gb_per_s": {k: b / (ms[k] * 1e-3) / 1e9 for k, b in bound.items()},
        "kernel_vs_plain_rel": worst, "sumsq_vs_float64_rel": sum_err,
        "tol": ADAMW_TOL, "launches_per_step": launches,
        "counters_per_step": counters,
        "max_memory_allocated": torch.cuda.max_memory_allocated()}


def adamw_main() -> int:
    """``--adamw``: the adamw phase alone (its child), the card's name and
    power limit, and its JSON result last."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    logs = build.build()["logs"].get("adamw", "")
    print(nvidia_smi_line(), flush=True)
    res = adamw_run(resolve_device())
    res["ptxas"] = [ln.strip() for ln in logs.splitlines() if any(
        w in ln for w in ("Compiling entry function", "registers", "spill"))]
    print(json.dumps(res), flush=True)
    return 0


def positions_run(dev) -> dict:
    """The positions phase (module docstring) at POSITIONS' shapes, each
    on one draw of every token's 6 distinct experts of 64, as top-k
    gives them; raises where the kernel's pos or keep differ from the
    plain version's, where a call launches other than once or where the
    counters are not the kernel's."""
    from repro_torch import obs
    from repro_torch.kernels._launch import launch_floor
    from repro_torch.kernels.moe_positions import kernel as positions_k
    from repro_torch.models import moe

    e = POSITIONS["experts"]
    gen = torch.Generator(device=dev).manual_seed(POSITIONS["seed"])
    rows = []
    for b, s, k in POSITIONS["shapes"]:
        c = max(1, min(s, int(s * k * 1.25 / e) + 1))
        view = torch.argsort(torch.rand((b, s, e), generator=gen,
                                        device=dev), dim=-1)[..., :k]
        top_e = view.contiguous()
        before = positions_k.positions.launches
        tel = obs.Telemetry()
        with obs.use(tel):
            pos, keep = moe._positions(view, e, c)
        launches = positions_k.positions.launches - before
        want_pos, want_keep = moe._positions_plain(top_e, e, c)
        exact = torch.equal(pos, want_pos) and torch.equal(keep, want_keep)
        counters = tel.counters()
        n = top_e.numel()
        if not exact or launches != 1 or counters != {
                "moe.positions_kernel": n, "moe.positions_plain": 0}:
            raise AssertionError(f"positions {(b, s, k)}: exact {exact}, "
                                 f"{launches} launches, {counters}")
        threads = positions_k.threads_for(s * k)
        grid = (b * -(-s * k // (threads * positions_k.ITEMS)), threads)
        iters = POSITIONS["iters"]
        ms = {"ms": time_cuda(lambda: positions_k.positions(top_e, e, c),
                              iters=iters),
              "path_ms": time_cuda(lambda: moe._positions(view, e, c),
                                   iters=iters),
              "floor_ms": time_cuda(lambda: launch_floor(dev, *grid),
                                    iters=iters),
              "plain_ms": time_cuda(
                  lambda: moe._positions_plain(view, e, c),
                  iters=POSITIONS["plain_iters"])}
        reworks = {name: {
            "ms": time_cuda(lambda: fn(view, e, c),
                            iters=POSITIONS["plain_iters"]),
            "exact": all(torch.equal(g, w) for g, w in zip(
                fn(view, e, c), (want_pos, want_keep)))}
            for name, fn in PLAIN_REWORKS.items()}
        bound = 17 * n / HBM_BYTES_PER_S * 1e3
        rows.append({"shape": [b, s, k], "experts": e, "capacity": c,
                     "entries": n, "grid": list(grid), **ms,
                     "bound_ms": bound, "bound_by": "bytes",
                     "share_of_bound": bound / ms["ms"],
                     "drops": int((~keep).sum()), "exact": exact,
                     "launches_per_call": launches,
                     "counters_per_call": counters,
                     "plain_reworks": reworks})
    return {"shapes": rows, "mesh": positions_mesh_check(dev)}


def positions_mesh_check(dev) -> dict:
    """``_positions`` on DTensors of a one-rank NCCL mesh: sharded on B
    and replicated, the kernel on the local shard (equal to the plain
    version, else a failure); sharded on S, refused."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels.moe_positions import kernel as positions_k
    from repro_torch.models import moe

    dist.init_process_group("nccl",
                            init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,))
        top_e = torch.argsort(torch.rand((4, 1024, 64), device=dev),
                              dim=-1)[..., :6]
        want = moe._positions_plain(top_e, 64, 121)
        before = positions_k.positions.launches
        out = {}
        for name, place in (("batch", Shard(0)), ("replicated", Replicate())):
            got = moe._positions(distribute_tensor(top_e, mesh, [place]),
                                 64, 121)
            out[name] = all(torch.equal(g.to_local(), w)
                            for g, w in zip(got, want))
        out["launches"] = positions_k.positions.launches - before
        try:
            moe._positions(distribute_tensor(top_e, mesh, [Shard(1)]), 64,
                           121)
            out["seq_refused"] = False
        except ValueError:
            out["seq_refused"] = True
    finally:
        dist.destroy_process_group()
    if not (out["batch"] and out["replicated"] and out["seq_refused"] and
            out["launches"] == 2):
        raise AssertionError(f"positions on a mesh: {out}")
    return out


def positions_main() -> int:
    """``--positions``: the positions phase alone (with the build), the
    card's name and power limit, and its JSON result last."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    logs = build.build()["logs"].get("moe_positions", "")
    smi = nvidia_smi_line()
    print(smi, flush=True)
    res = positions_run(resolve_device())
    res["nvidia_smi"] = smi
    res["ptxas"] = [ln.strip() for ln in logs.splitlines() if any(
        w in ln for w in ("Compiling entry function", "registers", "spill"))]
    print(json.dumps(res), flush=True)
    return 0


def mla_run(dev) -> dict:
    """The mla phase (module docstring): the port's moonlight-16b-a3b at
    MLA_SMOKE's depth against portbench/reference/mla_moe_lm.py."""
    import dataclasses

    sys.path.insert(0, ROOT)
    from portbench import inputs
    from portbench.reference import mla_moe_lm as ref
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.step import make_train_step

    m = MLA_SMOKE
    cfg = dataclasses.replace(get_config("moonlight-16b-a3b"),
                              n_layers=m["n_layers"])
    s = {"layers": cfg.n_layers, "d_model": cfg.d_model,
         "heads": cfg.n_heads, "q_nope": cfg.mla.qk_nope_head_dim,
         "q_rope": cfg.mla.qk_rope_head_dim, "v_dim": cfg.mla.v_head_dim,
         "kv_rank": cfg.mla.kv_lora_rank, "d_ff": cfg.d_ff,
         "dense": cfg.first_k_dense, "vocab": cfg.vocab,
         "d_expert": cfg.moe.d_expert, "experts": cfg.moe.n_experts,
         "top_k": cfg.moe.top_k, "shared": cfg.moe.n_shared,
         "eps": cfg.rms_eps, "theta": cfg.rope_theta,
         "routed_scale": cfg.moe.routed_scale,
         "aux": cfg.moe.router_aux_weight, "bias_rate": cfg.moe.bias_rate,
         "capacity_factor": cfg.moe.capacity_factor, "z_loss": cfg.z_loss}
    shapes = ref.leaf_shapes(s)
    scales = ref.leaf_scales(shapes)
    torch.cuda.reset_peak_memory_stats(dev)
    model = LM(cfg, device=dev, seed=m["seed"])
    _, views = inputs.draw_weights(shapes, scales, m["seed"], dev)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(views[k])
    biases = ref.initial_biases(s, dev)
    stream = inputs.TokenStream(m["seed"], 1, m["seq"], s["vocab"], dev)
    batch = stream.next()
    toks = batch["tokens"]
    out: dict = {"layers": cfg.n_layers, "seq": m["seq"]}
    with torch.no_grad():
        got = model(toks)[0].float()
        want = ref.logits(views, biases, toks, s)[0]
        fp8 = ref.logits(views, biases, toks, s, "fp8")[0]

    def gap(a, b):
        return float(torch.linalg.vector_norm((a - b).double()) /
                     torch.linalg.vector_norm(b.double()))

    out["logit_gap"] = gap(got, want)
    out["logit_gap_fp8_control"] = gap(fp8, want)
    del got, fp8
    n = m["prompt"]
    last, caches = model.prefill(toks[:, :n], n + 1)
    dec, _ = model.decode_step(toks[:, n:n + 1], n, caches)
    with torch.no_grad():
        full = ref.logits(views, biases, toks[:, :n + 1], s, prompt_len=n)[0]
    out["prefill_gap"] = gap(last[0, -1].float(), full[n - 1])
    out["decode_gap"] = gap(dec[0, -1].float(), full[n])
    out["cache_values_a_token_a_layer"] = int(sum(
        c.shape[-1] for c in caches[0].values()))
    del caches, last, dec, full, want, views
    opt = AdamW(learning_rate=1e-4)
    step = make_train_step(model, opt)
    params = dict(model.named_parameters())
    state = opt.init(params)
    params, state, met = step(params, state, batch)
    out["train_loss"] = float(met["loss"])
    out["bias_abs"] = float(sum(p["router_bias"].abs().sum()
                                for p in model.routers()))
    del state, params
    model.requires_grad_(False)
    long = inputs.TokenStream(m["seed"], 1, m["long_seq"], s["vocab"],
                              dev).next()["tokens"]
    tel = obs.Telemetry()
    with obs.use(tel), torch.no_grad():
        model(long)
    torch.cuda.synchronize(dev)
    spans = tel.spans_by_name()["attn.mla"]
    out["mla_fwd_ms_8k"] = None if spans["device_s"] is None else \
        1e3 * spans["device_s"]
    out["mla_spans_8k"] = spans["count"]
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["ok"] = (out["logit_gap"] < out["logit_gap_fp8_control"] and
                 max(out["prefill_gap"], out["decode_gap"]) < MLA_TOL and
                 math.isfinite(out["train_loss"]))
    return out


def mla_main() -> int:
    """``--mla``: the mla phase alone, the card's name and power limit,
    and its JSON result last."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.device import resolve_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(nvidia_smi_line(), flush=True)
    res = mla_run(resolve_device())
    print(json.dumps(res), flush=True)
    return 0 if res["ok"] else 1


def kernel_counters() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from repro_torch.kernels.adamw import kernel as adamw_k
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.moe_positions import kernel as positions_k
    from repro_torch.kernels.pack import kernel as pack_k
    from repro_torch.kernels.spmv import kernel as spmv_k

    return {"ell_spmv": spmv_k.ell_spmv, "pack": pack_k.pack,
            "flash_attention": fa_k.flash_attention,
            "ell_onehot": spmv_k.ell_onehot,
            "adamw_sumsq": adamw_k.sumsq, "adamw_update": adamw_k.update,
            "moe_positions": positions_k.positions}


def phase_distributed(A, parts, x, dev) -> dict:
    """make_distributed_spmv at the paper's size in its four cases
    (overlap_local x use_kernel): y against the float64 oracle within
    1e-4 of max |y|, the kernels' launches in each run (none with
    use_kernel=False, some with it), the two orderings with the kernels
    bit for bit equal, and each case's step timed by the paper's
    measure_cuda: 0.01 s windows taken in turns (the four cases, then
    the four reversed, three times), the median of each case's six.
    ``run(x)`` goes through the ordering's CUDA graph (jit_runner), and
    its y must equal the eager step's bit for bit; the graph's replay
    (``run.replay``) is timed beside the eager step (``run.step``), in
    the same turns."""
    from repro_torch.core.bench import measure_cuda
    from repro_torch.spmv.distributed import make_distributed_spmv

    counters = kernel_counters()
    oracle = A.matvec(x)
    scale = float(np.abs(oracle).max())
    cases, runs, ys = [], [], {}
    for overlap_local in (True, False):
        for use_kernel in (True, False):
            run = make_distributed_spmv(parts, dev, use_kernel=use_kernel,
                                        overlap_local=overlap_local)
            before = {k: c.launches for k, c in counters.items()}
            y = run(x)
            launched = {k: c.launches - before[k]
                        for k, c in counters.items()}
            rel = float(np.abs(y - oracle).max() / scale)
            name = (f"overlap_local={overlap_local},"
                    f"use_kernel={use_kernel}")
            if not rel <= 1e-4:
                raise AssertionError(f"distributed {name}: rel err {rel} "
                                     "> 1e-4")
            spmv_launches = launched["ell_spmv"] + launched["pack"]
            if (spmv_launches > 0) != use_kernel:
                raise AssertionError(f"distributed {name}: launched "
                                     f"{launched}")
            env = run.step()
            torch.cuda.synchronize()
            if not np.array_equal(y, (env["yL"] + env["yR"]).cpu().numpy()):
                raise AssertionError(f"distributed {name}: the graph's y "
                                     "is not the eager step's")
            ys[overlap_local, use_kernel] = y
            runs.append(run)
            cases.append({"overlap_local": overlap_local,
                          "use_kernel": use_kernel, "rel_err": rel,
                          "launches": {k: n for k, n in launched.items()
                                       if n},
                          "replay_equals_step": True,
                          "us_windows": [], "replay_us_windows": []})
    turns = list(range(len(cases)))
    for _ in range(3):
        for i in turns + turns[::-1]:
            cases[i]["us_windows"].append(
                measure_cuda(runs[i].step, dev) * 1e6)
            cases[i]["replay_us_windows"].append(
                measure_cuda(runs[i].replay, dev) * 1e6)
    for case in cases:
        case["us"] = statistics.median(case["us_windows"])
        case["replay_us"] = statistics.median(case["replay_us_windows"])
    bit_equal = bool(np.array_equal(ys[True, True], ys[False, True]))
    if not bit_equal:
        raise AssertionError("distributed: the two orderings with the "
                             "kernels give different y")
    return {"cases": cases, "kernel_orderings_bit_equal": bit_equal,
            "ok": True}


def issue_and_drain(fn, dev, samples: int) -> dict:
    """``fn`` run ``samples`` times back to back from a drained card: µs
    a run until the host has issued them all (``issue_us``) and until
    the card has finished them (``us``). Where the two are close the
    host's issue bounds the run."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(samples):
        fn()
    issued = time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    done = time.perf_counter() - t0
    return {"issue_us": issued / samples * 1e6, "us": done / samples * 1e6}


def shard_rank(rank: int, world: int, port: int, n: int = PAPER_N,
               nnz: int = PAPER_NNZ) -> dict:
    """The child ``--shard RANK WORLD PORT [N NNZ]``: one rank of the
    distributed SpMV, on card ``rank`` in an NCCL group of ``world``.
    make_rank_spmv on its part of band_matrix(n, nnz, seed=0) in the
    four cases (overlap_local x use_kernel), each held to the float64
    oracle and to the one-process make_distributed_spmv at the same R,
    its launches counted over its first run, and its step timed."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.bench import measure_cuda
    from repro_torch.spmv.distributed import (AXIS, halo_exchange,
                                              make_distributed_spmv,
                                              make_rank_spmv, rank_device)
    from repro_torch.spmv.matrix import band_matrix, partition

    t_phase = time.perf_counter()
    rank_device(world)
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world, device_id=dev)
    try:
        mesh = init_device_mesh("cuda", (world,), mesh_dim_names=(AXIS,))
        A = band_matrix(n=n, nnz=nnz, seed=0)
        parts = partition(A, world)
        x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
        m = n // world
        rows = slice(rank * m, (rank + 1) * m)
        oracle = A.matvec(x)
        scale = float(np.abs(oracle).max())
        one_process = {
            uk: make_distributed_spmv(parts, dev, use_kernel=uk)(x)[rows]
            for uk in (True, False)}
        torch.cuda.empty_cache()
        setup_s = time.perf_counter() - t_phase

        counters = kernel_counters()
        cases, runs, ys = [], [], {}
        for overlap_local in (True, False):
            for use_kernel in (True, False):
                name = (f"overlap_local={overlap_local},"
                        f"use_kernel={use_kernel}")
                run = make_rank_spmv(parts[rank], mesh,
                                     use_kernel=use_kernel,
                                     overlap_local=overlap_local)
                for c in counters.values():
                    c.launches = 0
                y = run(x[rows])
                launched = {k: c.launches for k, c in counters.items()
                            if c.launches}
                rel = float(np.abs(y - oracle[rows]).max() / scale)
                if not (np.isfinite(y).all() and rel <= 1e-4):
                    raise AssertionError(f"shard rank {rank} {name}: rel "
                                         f"err {rel} > 1e-4")
                if set(launched) != ({"ell_spmv"} if use_kernel else set()):
                    raise AssertionError(f"shard rank {rank} {name}: "
                                         f"launched {launched}")
                if not np.array_equal(y, one_process[use_kernel]):
                    raise AssertionError(
                        f"shard rank {rank} {name}: y is not the "
                        "one-process make_distributed_spmv's")
                ys[overlap_local, use_kernel] = y
                runs.append(run)
                cases.append({"overlap_local": overlap_local,
                              "use_kernel": use_kernel, "rel_err": rel,
                              "launches": launched,
                              "equals_one_process": True, "us_windows": []})
        if not np.array_equal(ys[True, True], ys[False, True]):
            raise AssertionError(f"shard rank {rank}: the two orderings "
                                 "with the kernels give different y")
        turns = list(range(len(cases)))
        for _ in range(3):
            for i in turns + turns[::-1]:
                cases[i]["us_windows"].append(measure_cuda(
                    runs[i].step, dev, t_measure_s=0.0,
                    min_samples=SHARD["samples"]) * 1e6)
        for case, run in zip(cases, runs):
            case["us"] = statistics.median(case["us_windows"])
            case["breakdown"] = issue_and_drain(run.step, dev,
                                                SHARD["samples"])
        # The exchange alone, on buffers of its own.
        block = torch.zeros(m, dtype=torch.float32, device=dev)
        halo = torch.empty(2 * m, dtype=torch.float32, device=dev)

        def exchange() -> None:
            for work in halo_exchange(block, runs[0].group, out=halo)[1]:
                work.wait()

        exchange_times = issue_and_drain(exchange, dev, SHARD["samples"])
        kernel_vs_plain = {
            f"overlap_local={ol}": float(
                np.abs(ys[ol, True] - ys[ol, False]).max() / scale)
            for ol in (True, False)}
        return {"rank": rank, "world": world, "n": n, "nnz": nnz, "m": m,
                "device": torch.cuda.get_device_name(dev),
                "backend": dist.get_backend(runs[0].group),
                "cases": cases, "kernel_orderings_bit_equal": True,
                "kernel_vs_plain_rel": kernel_vs_plain,
                "exchange": exchange_times,
                "samples_per_window": SHARD["samples"],
                "setup_s": setup_s,
                "wall_s": time.perf_counter() - t_phase}
    finally:
        dist.destroy_process_group()


def phase_shard() -> dict:
    """R = min(SHARD["max_ranks"], cards) children of shard_rank, one a
    card, started together; a child that fails (or outlives the phase's
    time) fails the phase, and every child is stopped. One line: each
    case's rel err (the worst rank), its launches summed over the ranks,
    each rank's median step µs and the slowest rank's."""
    import tempfile

    cards = torch.cuda.device_count()
    world = min(SHARD["max_ranks"], cards)
    port = free_port()
    t0 = time.perf_counter()
    logs = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
            for _ in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--shard", str(r),
         str(world), str(port)], stdout=out, stderr=err, text=True,
        cwd=ROOT) for r, (out, err) in enumerate(logs)]
    try:
        deadline = time.monotonic() + SHARD["timeout_s"]
        while any(p.poll() is None for p in procs) and not any(
                p.returncode for p in procs):
            if time.monotonic() > deadline:
                raise AssertionError(f"shard: ranks still running after "
                                     f"{SHARD['timeout_s']} s")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    results = []
    for r, (p, (out, err)) in enumerate(zip(procs, logs)):
        out.seek(0)
        err.seek(0)
        text, errors = out.read(), err.read()
        out.close()
        err.close()
        if p.returncode != 0:
            raise AssertionError(f"shard rank {r}: exit {p.returncode}\n"
                                 f"{errors[-6000:]}")
        results.append(json.loads(text.strip().splitlines()[-1]))
    cases = []
    for i, case in enumerate(results[0]["cases"]):
        per_rank = [res["cases"][i] for res in results]
        cases.append({
            "overlap_local": case["overlap_local"],
            "use_kernel": case["use_kernel"],
            "rel_err": max(c["rel_err"] for c in per_rank),
            "launches": {k: sum(c["launches"].get(k, 0) for c in per_rank)
                         for k in case["launches"]},
            "equals_one_process": all(c["equals_one_process"]
                                      for c in per_rank),
            "us_by_rank": [c["us"] for c in per_rank],
            "us_slowest": max(c["us"] for c in per_rank),
            "breakdown_by_rank": [c["breakdown"] for c in per_rank]})
    return {"ranks": world, "cards": cards, "backend": results[0]["backend"],
            **({"exchange": "identity (one card)"} if world == 1 else {}),
            "n": results[0]["n"], "nnz": results[0]["nnz"],
            "m": results[0]["m"], "cases": cases,
            "kernel_orderings_bit_equal": all(
                res["kernel_orderings_bit_equal"] for res in results),
            "kernel_vs_plain_rel": [res["kernel_vs_plain_rel"]
                                    for res in results],
            "exchange_by_rank": [res["exchange"] for res in results],
            "samples_per_window": SHARD["samples"],
            "launches": {"ell_spmv": sum(c["launches"].get("ell_spmv", 0)
                                         for c in cases)},
            "setup_s": [res["setup_s"] for res in results],
            "rank_wall_s": [res["wall_s"] for res in results],
            "wall_s": time.perf_counter() - t0, "ok": True}


def shard_main(args: list[str]) -> int:
    """The child of phase_shard: one rank, its result as one JSON line."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(shard_rank(*map(int, args))), flush=True)
    return 0


def phase_demo(dev) -> dict:
    """demo_spmv_impls (16 x 16 dense products) through the wallclock
    evaluator on the card over every schedule of spmv_dag() at 2
    streams, each gated against the reference schedule's outputs; those
    against float64 products of the same inputs."""
    from repro_torch.core.dag import spmv_dag
    from repro_torch.core.enumerate import enumerate_schedules
    from repro_torch.engine import make_evaluator
    from repro_torch.engine.wallclock import demo_spmv_impls

    g = spmv_dag()
    impls, env = demo_spmv_impls(g, device=dev)
    ev = make_evaluator(g, "wallclock", impls=impls, env=env,
                        reset=lambda: None, device=dev)
    scheds = list(enumerate_schedules(g, 2))
    t0 = time.perf_counter()
    times = ev.evaluate(scheds)
    wall = time.perf_counter() - t0
    if ev.n_checked != len(scheds):
        raise AssertionError(f"demo: {ev.n_checked} of {len(scheds)} "
                             "schedules gated")
    rng = np.random.default_rng(0)
    al, ar, xl = (rng.normal(size=sz).astype(np.float32).astype(np.float64)
                  for sz in ((16, 16), (16, 16), (16,)))
    ref = ev.reference_outputs()
    err = max(float(np.abs(ref[k] - want).max() / np.abs(want).max())
              for k, want in (("yL", al @ xl), ("yR", ar @ xl)))
    if not err <= 1e-5:
        raise AssertionError(f"demo: reference outputs {err} from float64")
    return {"n": 16, "schedules": len(scheds), "gated": ev.n_checked,
            "best_us": min(times) * 1e6, "worst_us": max(times) * 1e6,
            "spread": max(times) / min(times), "rel_err_vs_float64": err,
            "wall_s": wall, "objective": ev.objective_key()}


def phase_race(spmv, dev) -> dict:
    """Both checks must be caught by the value gate, and pass intact.
    Through the CUDA graph runner (``graph_checks``) the intact schedules
    must pass, and whether the gate caught the race is reported: in a
    graph a race may or may not show."""
    from repro_torch.core.dag import (BoundOp, Graph, Op, OpKind, Schedule,
                                      spmv_dag)
    from repro_torch.core.executor import GraphRunner, op_impl, run_items
    from repro_torch.core.sync import expand
    from repro_torch.engine.wallclock import (ExecutorEvaluator,
                                              reference_schedule)

    def caught(ev, g, items, drop) -> dict:
        cut = [it for it in items if it.name != drop]
        if len(cut) != len(items) - 1:
            raise AssertionError(f"{drop} not in the expanded schedule")
        ev.check(run_items(g, items, ev.impls, dev), "intact schedule")
        try:
            ev.check(run_items(g, cut, ev.impls, dev), f"without {drop}")
        except AssertionError as e:
            out = {"dropped": drop, "caught": True,
                   "gate": str(e).strip().splitlines()[0][:160]}
        else:
            raise AssertionError(f"removing {drop} was not caught by the "
                                 "gate")
        # Through the graph: the first call captures (its eager warm-up
        # and its replay write every buffer), so the gated call is a
        # replay from poisoned buffers.
        seen = None
        for its in (items, cut):
            run = GraphRunner(g, its, ev.impls, dev)
            run(ev.env)
            try:
                ev.check(run, "as a CUDA graph")
            except AssertionError as e:
                if its is items:
                    raise
                seen = str(e).strip().splitlines()[0][:160]
            finally:
                run.release()
        graph_checks.append({"dropped": drop, "caught": seen is not None,
                             "gate": seen})
        return out

    graph_checks: list = []
    # 1. Pack delayed on its stream; PostSend's copies no longer wait.
    g = spmv_dag()
    impls = spmv.impls()
    pack_impl = impls["Pack"]

    def slow_pack(env):
        torch.cuda._sleep(SLEEP_CYCLES)
        return pack_impl(env)

    impls["Pack"] = slow_pack
    ev = ExecutorEvaluator(g, impls=impls, env=spmv.env(),
                           reset=spmv.poison, device=dev)
    spmv_race = caught(ev, g, expand(g, reference_schedule(g)),
                       "CES-b4-PostSend")
    # The gate holds NaN equal to NaN: a row that the sorted layout's
    # perm missed would stay poisoned in the reference too.
    ref = ev.reference_outputs()
    if not all(np.isfinite(ref[k]).all() for k in ("yL", "yR")):
        raise AssertionError("an entry of yL or yR was never written")

    # 2. A GPU producer and consumer on two streams, without the CSWE.
    toy = Graph()
    toy.add_op(Op("P", OpKind.GPU))
    toy.add_op(Op("C", OpKind.GPU))
    toy.add_edge("P", "C")
    toy.finalize()
    src = torch.arange(1 << 20, dtype=torch.float32, device=dev)
    mid, res = torch.empty_like(src), torch.empty_like(src)

    def produce(s):
        torch.cuda._sleep(SLEEP_CYCLES)
        return torch.mul(s, 2.0, out=mid)

    def poison():
        mid.fill_(float("nan"))
        res.fill_(float("nan"))

    toy_impls = {"P": op_impl(produce, ["src"], ["mid"]),
                 "C": op_impl(lambda m: torch.add(m, 1.0, out=res),
                              ["mid"], ["res"])}
    sched = Schedule((BoundOp("start"), BoundOp("P", 0), BoundOp("C", 1),
                      BoundOp("end")))
    ev = ExecutorEvaluator(toy, impls=toy_impls, env={"src": src},
                           reset=poison, device=dev)
    toy_race = caught(ev, toy, expand(toy, sched), "CSWE-b4-C")
    return {"checks": [spmv_race, toy_race], "graph_checks": graph_checks}


def rules_fields(g, schedules, times) -> dict:
    """The rules pipeline on measured times: labels -> features ->
    Algorithm 1 -> rules; the table is printed, its sizes returned."""
    from repro_torch.core.features import featurize
    from repro_torch.rules import (algorithm1, extract_rulesets,
                                   label_times, render_rules_table,
                                   rules_by_class)

    labels = label_times(times)
    fm = featurize(g, schedules)
    tree = algorithm1(fm.X, labels.labels)
    table = render_rules_table(
        rules_by_class(extract_rulesets(tree, fm.features)), top_k=2)
    if "performance class" not in table:
        raise AssertionError("no rules table")
    print(table, flush=True)
    return {"classes": labels.n_classes,
            "class_sizes": np.bincount(labels.labels).tolist(),
            "features": len(fm.features), "tree_leaves": tree.n_leaves(),
            "tree_depth": tree.depth(),
            "tree_error": tree.training_error(fm.X, labels.labels)}


def phase_main_path(spmv, A, x, dev) -> tuple:
    from repro_torch.core.dag import spmv_dag
    from repro_torch.engine.wallclock import ExecutorEvaluator
    from repro_torch.kernels.pack import kernel as pack_k
    from repro_torch.kernels.spmv import kernel as spmv_k
    from repro_torch.search import MCTSSearch, run_search

    g = spmv_dag()
    objective = dict(impls=spmv.impls(), env=spmv.env(), reset=spmv.poison,
                     repeats=20, warmup=3, device=dev,
                     store_tag=spmv.store_tag)
    ev = ExecutorEvaluator(g, **objective)
    spmv_k.ell_spmv.launches = 0
    pack_k.pack.launches = 0
    t0 = time.perf_counter()
    res = run_search(g, MCTSSearch(g, 2, seed=0), ev, budget=400,
                     batch_size=1)
    wall = time.perf_counter() - t0
    launches = {"ell_spmv": spmv_k.ell_spmv.launches,
                "pack": pack_k.pack.launches}
    # The same schedules again under the same objective, no store.
    t0 = time.perf_counter()
    again = ExecutorEvaluator(g, **objective).evaluate(res.schedules)
    wall_again = time.perf_counter() - t0

    ref = ev.reference_outputs()
    if not all(np.isfinite(ref[k]).all() for k in ("yL", "yR")):
        raise AssertionError("an entry of yL or yR was never written")
    y = ref["yL"].astype(np.float64) + ref["yR"]
    oracle = A.matvec(x)
    y_rel = float(np.abs(y - oracle).max() / np.abs(oracle).max())
    if not y_rel <= 1e-4:
        raise AssertionError(f"main path y: rel err {y_rel} > 1e-4")
    if ev.n_checked != len(res.schedules):
        raise AssertionError(f"{ev.n_checked} gated of "
                             f"{len(res.schedules)} schedules")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never ran: {launches}")

    times = res.times_array()
    rules = rules_fields(g, res.schedules, times)
    best, t_best = res.best()
    return res, {
        "platform": ev.platform, "objective": ev.objective_key(),
        "proposed": res.n_proposed, "schedules": len(res.schedules),
        "gated": ev.n_checked, "best_us": float(t_best) * 1e6,
        "worst_us": float(times.max()) * 1e6,
        "median_us": float(np.median(times)) * 1e6,
        "spread": float(times.max() / times.min()),
        "best_schedule": " ".join(str(i) for i in best.items),
        **rules, "y_rel_err": y_rel, "search_wall_s": wall,
        "rho_repeat": spearman(times, again),
        "sweep2_best_us": float(min(again)) * 1e6,
        "sweep2_worst_us": float(max(again)) * 1e6,
        "sweep2_wall_s": wall_again, "launches": launches}


def phase_graph(spmv, res, dev) -> dict:
    """The main path's schedules under the JAX package's compiled
    objective: every schedule of spmv_dag() at 2 streams captured into
    one CUDA graph (ExecutorEvaluator(cuda_graph=True) over jit_runner),
    gated on a replay from poisoned buffers and timed by replays (the
    main path's repeats and warmup); a second, store-free sweep; Spearman
    rho against the first sweep, against the main path's eager times and
    against the H100 model; two more sweeps under the paper's windowed
    protocol (GRAPH_WINDOWED: replays back to back, a sample the graph's
    device time), their rho and the share of schedules both label alike;
    the rules pipeline on the graph times and on the first windowed
    sweep's (both tables printed); one
    replay of the fastest schedule traced in a child process, whose
    kernels must include ell_spmv and pack (launch counters count the
    capture, not a replay)."""
    from repro_torch.core.dag import spmv_dag
    from repro_torch.core.enumerate import enumerate_schedules
    from repro_torch.engine.wallclock import ExecutorEvaluator
    from repro_torch.rules import label_times

    g = spmv_dag()
    objective = dict(impls=spmv.impls(), env=spmv.env(), reset=spmv.poison,
                     repeats=20, warmup=3, device=dev,
                     store_tag=spmv.store_tag, cuda_graph=True)
    scheds = list(enumerate_schedules(g, 2))
    ev = ExecutorEvaluator(g, **objective)
    t0 = time.perf_counter()
    times = np.asarray(ev.evaluate(scheds))
    wall = time.perf_counter() - t0
    if ev.n_checked != len(scheds):
        raise AssertionError(f"graph: {ev.n_checked} gated of "
                             f"{len(scheds)} schedules")
    t0 = time.perf_counter()
    again = np.asarray(ExecutorEvaluator(g, **objective).evaluate(scheds))
    wall_again = time.perf_counter() - t0
    # The paper's protocol over replays: back to back for a window, no
    # drain between them, so a sample is the graph's device time.
    t0 = time.perf_counter()
    windowed = [np.asarray(ExecutorEvaluator(g, **{
        **objective, **GRAPH_WINDOWED}).evaluate(scheds)) for _ in range(2)]
    wall_windowed = time.perf_counter() - t0
    if not all(np.isfinite(t).all() and t.min() > 0.0
               for t in (times, again, *windowed)):
        raise AssertionError("graph: a time is not finite and positive")
    eager = dict(zip((s.key() for s in res.schedules), res.times_array()))
    both = [i for i, s in enumerate(scheds) if s.key() in eager]
    model = phase_model(scheds, times, wall)
    rules = rules_fields(g, scheds, times)
    print("windowed:", flush=True)
    windowed_rules = rules_fields(g, scheds, windowed[0])
    kept = [label_times(w).labels for w in windowed]
    best = int(np.argmin(times))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--graph-trace",
         str(best)], capture_output=True, text=True,
        timeout=GRAPH_TRACE_TIMEOUT_S, cwd=ROOT)
    if proc.returncode != 0:
        raise AssertionError(f"graph trace: exit {proc.returncode}\n"
                             f"{proc.stderr[-6000:]}")
    traced = json.loads(proc.stdout.strip().splitlines()[-1])
    traced["process_s"] = time.perf_counter() - t0
    missing = [k for k in ("ell_spmv", "pack")
               if not any(k in name for name in traced["kernels"])]
    if missing:
        raise AssertionError(f"graph: no {missing} kernel in a traced "
                             f"replay: {sorted(traced['kernels'])}")
    return {
        "objective": ev.objective_key(), "schedules": len(scheds),
        "gated": ev.n_checked, "best_us": float(times.min()) * 1e6,
        "median_us": float(np.median(times)) * 1e6,
        "worst_us": float(times.max()) * 1e6,
        "spread": float(times.max() / times.min()),
        "best_schedule": " ".join(str(i) for i in scheds[best].items),
        "rho_repeat": spearman(times, again),
        "sweep2_best_us": float(again.min()) * 1e6,
        "sweep2_median_us": float(np.median(again)) * 1e6,
        "sweep2_worst_us": float(again.max()) * 1e6,
        "rho_vs_eager": spearman(times[both], [eager[scheds[i].key()]
                                               for i in both]),
        "eager_paired": len(both),
        "rho_model_vs_graph": model["rho_model_vs_card"],
        "model_distinct_makespans": model["distinct_makespans"],
        "model_same_class_share": model["same_class_share"],
        **rules, "windowed": {
            **GRAPH_WINDOWED,
            "best_us": float(windowed[0].min()) * 1e6,
            "median_us": float(np.median(windowed[0])) * 1e6,
            "worst_us": float(windowed[0].max()) * 1e6,
            "spread": float(windowed[0].max() / windowed[0].min()),
            "best_schedule": " ".join(
                str(i) for i in scheds[int(np.argmin(windowed[0]))].items),
            "rho_repeat": spearman(*windowed),
            "rho_vs_graph": spearman(windowed[0], times),
            "class_retention": float(np.mean(kept[0] == kept[1])),
            **windowed_rules, "wall_s": wall_windowed},
        "traced_replay": traced, "wall_s": wall,
        "sweep2_wall_s": wall_again}


def graph_trace_main(index: int) -> int:
    """The child of phase_graph: the SpMV at the paper's size, schedule
    ``index`` of spmv_dag() at 2 streams captured by jit_runner, then one
    replay under torch.profiler (trace ``chiprun_out/graph_replay_trace.
    json``): device ms and count per kernel name (a graph runs the halo
    copies as the driver's ``memcpy32_post`` kernels), memcpy events, the
    device span of the replay, and the launches counted at the capture;
    one JSON line."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.dag import spmv_dag
    from repro_torch.core.enumerate import enumerate_schedules
    from repro_torch.core.executor import jit_runner
    from repro_torch.device import resolve_device
    from repro_torch.spmv.distributed import from_reference
    from repro_torch.spmv.matrix import (band_matrix, partition,
                                         stack_partitions)

    dev = resolve_device()
    A = band_matrix(n=PAPER_N, nnz=PAPER_NNZ, seed=0)
    x = np.random.default_rng(1).standard_normal(PAPER_N).astype(
        np.float32)
    spmv = from_reference(stack_partitions(partition(A, RANKS)), x, dev)
    g = spmv_dag()
    sched = list(enumerate_schedules(g, 2))[index]
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    run = jit_runner(g, sched, spmv.impls(), dev)
    run(spmv.env())
    captured = {k: c.launches for k, c in counters.items() if c.launches}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        run(spmv.env())
        torch.cuda.synchronize()
    trace = os.path.join(ROOT, "chiprun_out", "graph_replay_trace.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    p.export_chrome_trace(trace)
    with open(trace) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") in ("kernel", "gpu_memcpy")]
    kernels: dict = {}
    for e in events:
        if e["cat"] == "kernel":
            ms, n = kernels.get(e["name"], (0.0, 0))
            kernels[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    start = min((e["ts"] for e in events), default=0.0)
    end = max((e["ts"] + e["dur"] for e in events), default=0.0)
    print(json.dumps({
        "schedule": " ".join(str(i) for i in sched.items),
        "kernels": {k: {"ms": ms, "count": n}
                    for k, (ms, n) in kernels.items()},
        "memcpy_events": sum(e["cat"] == "gpu_memcpy" for e in events),
        "device_span_us": end - start,
        "launches_at_capture": captured,
        "trace": os.path.relpath(trace, ROOT)}), flush=True)
    return 0


DRIVER_SPANS = ("driver.propose", "driver.acquire", "driver.evaluate",
                "driver.observe", "engine.measure", "rules.distill")


def tree_fields(report) -> dict:
    """A rules report's tree and rules, field by field: the preorder
    splits (feature, threshold), each leaf's rows, weighted class counts
    and class, the labels, the features, the rulesets and the training
    error."""
    splits, leaves = [], []

    def walk(nd):
        if nd.is_leaf:
            leaves.append((nd.n_samples, [float(v) for v in nd.value],
                           nd.majority_class()))
            return
        splits.append((int(nd.feature), float(nd.threshold)))
        walk(nd.left)
        walk(nd.right)

    walk(report.tree.root)
    return {"splits": splits, "leaves": leaves,
            "labels": report.labeling.labels.tolist(),
            "features": report.feature_matrix.names(),
            "rulesets": [(r.class_label, [x.text() for x in r.rules],
                          r.n_samples) for r in report.rulesets],
            "training_error": report.training_error}


def phase_driver(spmv, dev) -> dict:
    """SearchDriver over the paper's measured SpMV schedules, with the
    telemetry it reports through."""
    import tempfile

    from repro_torch import obs
    from repro_torch.core.dag import spmv_dag
    from repro_torch.driver import DatasetSink, HistogramSink, SearchDriver
    from repro_torch.engine.store import EvalStore
    from repro_torch.engine.wallclock import ExecutorEvaluator
    from repro_torch.kernels.pack import kernel as pack_k
    from repro_torch.kernels.spmv import kernel as spmv_k
    from repro_torch.search import SurrogateGuided

    g = spmv_dag()
    objective = dict(impls=spmv.impls(), env=spmv.env(), reset=spmv.poison,
                     repeats=20, warmup=3, device=dev,
                     store_tag=spmv.store_tag)
    run = dict(budget=None, batch_size=4, sim_budget=140,
               acquisition="expected_improvement")
    trace = os.path.join(ROOT, "chiprun_out", "driver_trace.json")

    def strategy():
        return SurrogateGuided(g, 2, seed=0, surrogate="boost")

    with tempfile.TemporaryDirectory() as tmp:
        store = EvalStore(os.path.join(tmp, "driver.store"))
        ev = ExecutorEvaluator(g, store=store, **objective)
        strat = strategy()
        ds, hs = DatasetSink(g), HistogramSink(g)
        tel = obs.Telemetry([obs.PerfettoExporter(trace)])
        spmv_k.ell_spmv.launches = 0
        pack_k.pack.launches = 0
        t0 = time.perf_counter()
        with obs.use(tel):
            res = SearchDriver(g, strat, ev, sinks=[ds, hs, "telemetry"],
                               **run).run()
            launches = {"ell_spmv": spmv_k.ell_spmv.launches,
                        "pack": pack_k.pack.launches}
            dense, ooc = ds.distill(), hs.distill()
        wall = time.perf_counter() - t0
        tel.close()
        spans = tel.spans_by_name()

        # The same search again from the store: it must measure nothing
        # and retrace the cold run.
        warm_ev = ExecutorEvaluator(g, store=store, **objective)
        warm = SearchDriver(g, strategy(), warm_ev, **run).run()
        store.close()

    if not (res.cache_misses == ev.n_checked >= 140 and
            len(res.schedules) == res.cache_misses):
        raise AssertionError(f"{ev.n_checked} gated, {res.cache_misses} "
                             f"measured, {len(res.schedules)} schedules")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never ran in the driver: {launches}")
    if not all(np.isfinite(t) and t > 0.0 for t in res.times):
        raise AssertionError("a measured time is not finite and positive")
    if not (warm.cache_misses == 0 and warm.store_hits == res.cache_misses
            and warm.times == res.times and warm_ev.n_checked == 0):
        raise AssertionError(f"warm replay measured {warm.cache_misses}, "
                             f"{warm.store_hits} store hits")
    fd, fo = tree_fields(dense), tree_fields(ooc)
    differ = sorted(k for k in fd if fd[k] != fo[k])
    if differ or hs.times != ds.times or dense.render() != ooc.render():
        raise AssertionError(f"histogram distill differs from dense in "
                             f"{differ}")
    missing = [n for n in DRIVER_SPANS if n not in spans]
    if missing or not os.path.isfile(trace):
        raise AssertionError(f"no span {missing} or no trace {trace}")
    quality = strat.screening_quality()
    top = ("driver.propose", "driver.acquire", "driver.evaluate",
           "driver.observe", "rules.distill")
    span_sum = sum(spans[n]["total_s"] for n in top)
    times = res.times_array()
    return {
        "objective": ev.objective_key(), "proposed": res.n_proposed,
        "measured": res.cache_misses, "gated": ev.n_checked,
        "store_hits": res.store_hits, "memory_hits": res.cache_hits,
        "rounds": len(res.telemetry), "launches": launches,
        "best_us": float(times.min()) * 1e6,
        "median_us": float(np.median(times)) * 1e6,
        "worst_us": float(times.max()) * 1e6,
        "surrogate_rho": quality["spearman"],
        "surrogate_compared": quality["n_compared"],
        "surrogate_screened": quality["n_screened"],
        "surrogate_mean_rel_err": quality["mean_rel_err"],
        "histogram_equals_dense": True,
        "fields_compared": sorted(fd),
        "classes": dense.labeling.n_classes,
        "tree_leaves": dense.tree.n_leaves(),
        "training_error": dense.training_error,
        "span_s": {n: spans[n]["total_s"] for n in DRIVER_SPANS},
        "span_count": {n: spans[n]["count"] for n in DRIVER_SPANS},
        "span_sum_s": span_sum, "span_sum_of": list(top), "wall_s": wall,
        "span_share_of_wall": span_sum / wall,
        "stage_s": {"dense": dense.stage_seconds,
                    "histogram": ooc.stage_seconds},
        "trace": os.path.relpath(trace, ROOT),
        "warm_replay": {"measured": warm.cache_misses,
                        "store_hits": warm.store_hits,
                        "same_times": warm.times == res.times}}


class _KillAfter:
    """Wraps a search strategy; runs ``kill`` before its ``after``-th
    proposal: a host dies mid-search, at a fixed point of the run."""

    def __init__(self, inner, kill, after):
        self.inner, self.kill, self.after, self.calls = inner, kill, after, 0

    def propose(self, budget):
        self.calls += 1
        if self.calls == self.after:
            self.kill()
        return self.inner.propose(budget)

    def observe(self, schedule, time):
        self.inner.observe(schedule, time)


def welcome_info(addr: str, fingerprint: bytes) -> dict:
    """The WELCOME info a server sends a client whose fingerprint it
    accepts (its space, backend and pid)."""
    import socket

    from repro_torch.engine import rpc

    host, port = rpc.parse_host(addr)
    with socket.create_connection((host, port), timeout=RPC_TIMEOUTS[
            "connect_timeout"]) as sock:
        sock.settimeout(RPC_TIMEOUTS["deadline"])
        rpc.send_frame(sock, rpc.encode_hello(fingerprint))
        mtype, body = rpc.recv_frame(sock)
    if mtype != rpc.MSG_WELCOME:
        raise AssertionError(f"{addr} answered {mtype}, not WELCOME")
    return json.loads(body)


def cuda_device_files(pid: int) -> list:
    """The /dev/nvidia* files a process holds open: a CUDA context holds
    some, a process that only imported torch holds none."""
    fd_dir = f"/proc/{pid}/fd"
    out = set()
    for fd in os.listdir(fd_dir):
        try:
            target = os.readlink(os.path.join(fd_dir, fd))
        except OSError:
            continue
        if target.startswith("/dev/nvidia"):
            out.add(target)
    return sorted(out)


def compute_app_pids() -> list:
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return [int(p) for p in out.stdout.split() if p.strip().isdigit()]


def phase_rpc() -> dict:
    """The evaluation service: two server processes on halo3d under
    ``vectorized``, a cold rpc search held to local sim, a server killed
    mid-search, a refusal counted at once, and no server on the card."""
    import random
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.core.dag import halo3d_dag, spmv_dag_fine
    from repro_torch.engine import (EvalServer, RpcHandshakeError,
                                    make_evaluator, spawn_server_process)
    from repro_torch.search import MCTSSearch, run_search
    from repro_torch.space import random_schedule

    t_phase = time.perf_counter()
    g = halo3d_dag()
    run = dict(budget=None, sim_budget=60, batch_size=8)

    def spawn(_):
        return spawn_server_process("halo3d", backend="vectorized",
                                    startup_timeout=120.0)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        procs = list(pool.map(spawn, range(2)))
    startup_s = time.perf_counter() - t0
    try:
        hosts = [p.addr for p in procs]
        t0 = time.perf_counter()
        ref = run_search(g, MCTSSearch(g, 2, seed=5), backend="sim", **run)
        sim_s = time.perf_counter() - t0

        ev = make_evaluator(g, "rpc", hosts=hosts, min_shard=1,
                            **RPC_TIMEOUTS)
        info = [welcome_info(a, ev.store_fingerprint) for a in hosts]
        pids = [i["pid"] for i in info]
        if pids != [p.proc.pid for p in procs]:
            raise AssertionError(f"WELCOME pids {pids} are not the "
                                 f"servers' {[p.proc.pid for p in procs]}")
        on_card = compute_app_pids()
        files = {pid: cuda_device_files(pid) for pid in pids}
        own_files = cuda_device_files(os.getpid())
        t0 = time.perf_counter()
        res = run_search(g, MCTSSearch(g, 2, seed=5), ev, **run)
        rpc_s = time.perf_counter() - t0
        healthy = ev.rpc_stats()
        ev.close()
        identical = res.times_array().tobytes() == \
            ref.times_array().tobytes()
        if not identical or healthy["local_evals"] != 0:
            raise AssertionError(f"rpc search differs from sim "
                                 f"({identical}) or fell back locally "
                                 f"({healthy['local_evals']} rows)")
        if any(pid in on_card or files[pid] for pid in pids):
            raise AssertionError(f"a server holds a CUDA context: "
                                 f"nvidia-smi {on_card}, files {files}")
        if not own_files:
            raise AssertionError("this process holds no /dev/nvidia* "
                                 "file: the context check sees nothing")

        ev = make_evaluator(g, "rpc", hosts=hosts, min_shard=1, retries=1,
                            backoff=0.01, **RPC_TIMEOUTS)
        t0 = time.perf_counter()
        killed = run_search(
            g, _KillAfter(MCTSSearch(g, 2, seed=5), procs[0].terminate, 3),
            ev, **run)
        killed_s = time.perf_counter() - t0
        after_kill = ev.rpc_stats()
        ev.close()
    finally:
        for p in procs:
            p.terminate()
    survived = killed.times_array().tobytes() == ref.times_array().tobytes()
    dead = after_kill["hosts"][hosts[0]]["alive"]
    if not survived or dead:
        raise AssertionError(f"after the kill: identical {survived}, "
                             f"killed host alive {dead}")

    other = EvalServer(spmv_dag_fine()).start()
    try:
        rng = random.Random(11)
        scheds = [random_schedule(g, 2, rng) for _ in range(8)]
        with make_evaluator(g, "rpc", hosts=[other.addr], min_shard=1,
                            **RPC_TIMEOUTS) as ev:
            try:
                ev.evaluate(scheds)
                refused = False
            except RpcHandshakeError:
                refused = True
            n_refused = other.n_refused      # read at once, no wait
    finally:
        other.close()
    if not (refused and n_refused == 1):
        raise AssertionError(f"refused {refused}, n_refused {n_refused}")

    def meters(stats):
        return {"local_evals": stats["local_evals"],
                "hosts": list(stats["hosts"].values())}

    return {
        "space": "halo3d", "server_backend": "vectorized",
        "sim_budget": run["sim_budget"], "schedules": len(res.schedules),
        "bit_identical_to_sim": identical,
        "local_evals": healthy["local_evals"],
        "kill_survived": survived,
        "kill_local_evals": after_kill["local_evals"],
        "kill_retries": sum(h["retries"] for h in
                            after_kill["hosts"].values()),
        "refused": refused, "n_refused": n_refused,
        "server_pids": pids, "welcome": info,
        "compute_app_pids": on_card,
        "server_cuda_files": {str(k): v for k, v in files.items()},
        "own_cuda_files": own_files,
        "servers_hold_cuda_context": False,
        "rpc_stats": meters(healthy),
        "rpc_stats_after_kill": meters(after_kill),
        "startup_s": startup_s, "sim_search_s": sim_s,
        "rpc_search_s": rpc_s, "killed_search_s": killed_s,
        "wall_s": time.perf_counter() - t_phase}


def phase_stepdag() -> dict:
    """The LM train step of qwen2.5-32b (4 coarse stages) as an op-DAG
    on the H100 data sheet's constants, searched through an in-process
    two-host fleet and held to local sim. Analytic: no time here is a
    measurement."""
    import dataclasses

    from repro_torch.core.stepdag import train_step_dag, with_comm_durations
    from repro_torch.engine import EvalServer
    from repro_torch.launch.costs import (LINK_BW, PEAK_FLOPS,
                                          costs_from_arch,
                                          train_step_machine)
    from repro_torch.rules import distill, render_rules_table
    from repro_torch.search import MCTSSearch, run_search

    t_phase = time.perf_counter()
    arch, layers = "qwen2.5-32b", 4
    m = train_step_machine()
    costs = costs_from_arch(arch, layers, tokens_per_chip=16 * 4096 // 16)
    g = with_comm_durations(train_step_dag(layers, costs), LINK_BW)
    run = dict(budget=300, batch_size=8, machine=m)
    t0 = time.perf_counter()
    ref = run_search(g, MCTSSearch(g, 2, seed=0), backend="sim", **run)
    sim_s = time.perf_counter() - t0
    servers = [EvalServer(g, machine=m).start() for _ in range(2)]
    try:
        t0 = time.perf_counter()
        res = run_search(g, MCTSSearch(g, 2, seed=0), backend="rpc",
                         backend_kwargs={"hosts": [s.addr for s in servers],
                                         "min_shard": 1, **RPC_TIMEOUTS},
                         **run)
        rpc_s = time.perf_counter() - t0
    finally:
        for s in servers:
            s.close()
    identical = res.times == ref.times
    if not identical:
        raise AssertionError("the fleet's train-step search differs "
                             "from local sim")
    times = res.times_array()
    report = distill(res)
    rules = render_rules_table(report.grouped(), top_k=1).splitlines()
    total_flops = sum(op.flops for op in g.ops.values())
    return {
        "arch": arch, "layers": layers, "ops": g.n_vertices(),
        "machine": dataclasses.asdict(m),
        "costs": dataclasses.asdict(costs),
        "proposals": res.n_proposed, "schedules": len(res.schedules),
        "fleet_equals_sim": identical,
        "units": "analytic model, not a measurement",
        "best_ms": float(times.min()) * 1e3,
        "worst_ms": float(times.max()) * 1e3,
        "compute_only_bound_ms": total_flops / PEAK_FLOPS * 1e3,
        "classes": report.labeling.n_classes, "rules": rules[:8],
        "sim_search_s": sim_s, "rpc_search_s": rpc_s,
        "wall_s": time.perf_counter() - t_phase}


def phase_model(schedules, card, card_wall_s: float) -> dict:
    """The H100 machine model on ``schedules``, against the times the
    card measured for them (``card``, in seconds)."""
    import dataclasses

    from repro_torch.core import Machine, spmv_dag
    from repro_torch.engine import make_evaluator
    from repro_torch.rules import label_times

    g = spmv_dag(rows_per_rank=PAPER_N // RANKS,
                 nnz_per_rank=PAPER_NNZ // RANKS, value_bytes=4)
    t0 = time.perf_counter()
    model = make_evaluator(g, "vectorized").evaluate(schedules)
    vec_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim = make_evaluator(g, "sim").evaluate(schedules)
    sim_s = time.perf_counter() - t0
    if model != sim:
        raise AssertionError("vectorized and sim makespans differ")
    card = np.asarray(card)
    mlab, clab = label_times(model), label_times(card)
    # Makespans within a picosecond differ only by the order of float
    # sums: ties. A model that gives every schedule one makespan cannot
    # rank them, and rho is undefined (null).
    model_ps = np.round(np.asarray(model) * 1e12)
    distinct = len(np.unique(model_ps))
    return {
        "machine": dataclasses.asdict(Machine()),
        "schedules": len(model), "sim_equals_vectorized": True,
        "best_us": min(model) * 1e6,
        "median_us": float(np.median(model)) * 1e6,
        "worst_us": max(model) * 1e6, "distinct_makespans": distinct,
        "rho_model_vs_card": spearman(model_ps, card) if distinct > 1
        else None,
        "classes": mlab.n_classes, "card_classes": clab.n_classes,
        "same_class_share": float(np.mean(mlab.labels == clab.labels)),
        "vectorized_s": vec_s, "sim_s": sim_s, "card_search_s": card_wall_s}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.device import probe, resolve_device
        from repro_torch.kernels import build
        from repro_torch.spmv.distributed import from_reference
        from repro_torch.spmv.matrix import (band_matrix, partition,
                                             stack_partitions)
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})",
              file=sys.stderr)
        return 1
    if "jax" in sys.modules or "repro" in sys.modules:
        print("chip_smoke: JAX or the JAX package was imported",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device()
    smi = nvidia_smi_line()
    emit("probe", nvidia_smi=smi, ecc=ecc_line(), **probe())

    report = build.build()
    # Each function's name, then its registers and spills.
    ptxas = {s: [ln.strip() for ln in log.splitlines()
                 if any(w in ln for w in (
                     "Compiling entry function", "Function properties for",
                     "registers", "spill"))]
             for s, log in report["logs"].items()}
    emit("build", seconds=report["seconds"], dir=str(report["dir"]),
         ptxas=ptxas)

    t0 = time.perf_counter()
    A = band_matrix(n=PAPER_N, nnz=PAPER_NNZ, seed=0)
    parts = partition(A, RANKS)
    x = np.random.default_rng(1).standard_normal(PAPER_N).astype(
        np.float32)
    spmv = from_reference(stack_partitions(parts), x, dev)
    torch.cuda.synchronize()
    emit("setup", n=PAPER_N, nnz=PAPER_NNZ, ranks=RANKS, m=spmv.m,
         k_local=spmv.local.vals_t.shape[0],
         k_remote=spmv.remote.vals_t.shape[0],
         slots_read_local=int(spmv.local.slice_k.sum()) * 32,
         slots_read_remote=int(spmv.remote.slice_k.sum()) * 32,
         seconds=time.perf_counter() - t0)

    kern = phase_kernels(spmv, dev)
    for more in (phase_attention(dev), phase_onehot(dev)):
        kern["sweep"] += more.pop("sweep")
        kern.update(more)
    emit("kernels", **kern)

    emit("distributed", **phase_distributed(A, parts, x, dev))
    emit("demo", **phase_demo(dev))

    emit("race", **phase_race(spmv, dev))
    res, main_path = phase_main_path(spmv, A, x, dev)
    emit("main_path", **main_path)
    emit("graph", **phase_graph(spmv, res, dev))
    emit("model", **phase_model(res.schedules, res.times_array(),
                                main_path["search_wall_s"]))
    driver = phase_driver(spmv, dev)
    emit("driver", **driver)
    emit("rpc", **phase_rpc())
    emit("stepdag", **phase_stepdag())
    del spmv
    torch.cuda.empty_cache()
    onehot_path = phase_onehot_path(dev)
    emit("onehot_path", **onehot_path)
    autotune = phase_autotune(dev)
    emit("autotune", **autotune)
    serve = phase_serve(dev)
    emit("serve", **serve)
    torch.cuda.empty_cache()
    families = phase_families()
    train = phase_train(dev)
    emit("train", **train)
    torch.cuda.empty_cache()
    train_families = phase_train_families()
    adamw = phase_child("--adamw", ADAMW["timeout_s"])
    emit("adamw", **adamw)
    positions = phase_child("--positions", POSITIONS["timeout_s"])
    emit("positions", **positions)
    phase_dist()
    shard = phase_shard()
    emit("shard", **shard)
    launches = {**main_path["launches"], **onehot_path["launches"],
                **serve["launches"]}

    by_path = {"main_path": main_path["launches"],
               "driver": driver["launches"],
               "onehot_path": onehot_path["launches"],
               "autotune": autotune["launches"],
               "serve": serve["launches"],
               "families": {"flash_attention": sum(
                   f["launches"]["flash_attention"]
                   for f in families.values())},
               "train": {k: n for k, n in train["launches"].items() if n},
               "train_families": {name: sum(
                   f["launches"][name]
                   for f in train_families.values() if "launches" in f)
                   for name in ("flash_attention", "adamw_sumsq",
                                "adamw_update", "moe_positions")},
               "shard": shard["launches"]}

    def entry(name, source, replaces, calls, path, summed=(), **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "path": path,
                "launches": launches[name],
                "launches_by_path": {p: n[name] for p, n in by_path.items()
                                     if name in n},
                "max_abs_err": max(c["max_abs_err"] for c in calls),
                **{k: (None if any(c[k] is None for c in calls)
                       else sum(c[k] for c in calls))
                   for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                             *summed)},
                "bound_by": calls[0]["bound_by"], **extra}

    timed = ("ms_warm", "floor_ms")

    fa = serve["flash_attention"]
    fa_auto = kern["flash_attention"][0]

    print(smi, flush=True)
    print(json.dumps({"kernels": [
        entry("ell_spmv", "src/repro_torch/csrc/ell_spmv.cu",
              "src/repro/kernels/spmv/kernel.py:49", kern["ell_spmv"],
              "main_path", summed=(*timed, "plain_ms_padded",
                                   "bound_ms_slots", "bound_ms_layout",
                                   "nnz", "slots_read")),
        entry("pack", "src/repro_torch/csrc/pack.cu",
              "src/repro/kernels/pack/kernel.py:49", kern["pack"],
              "main_path", summed=timed),
        entry("flash_attention",
              "src/repro_torch/csrc/flash_attention_bf16.cu",
              "src/repro/kernels/flash_attention/kernel.py:80",
              [fa], "serve",
              source_float32="src/repro_torch/csrc/flash_attention.cu",
              shape=fa["shape"], dtype=fa["dtype"],
              library_call=fa["library_call"],
              library_kernel=fa["library_kernel"],
              library_max_abs_err=fa["library_max_abs_err"],
              at_widened_shape={k: fa["at_widened_shape"][k] for k in (
                  "shape", "ms", "plain_ms", "library_ms", "library_kernel",
                  "bound_ms", "bound_by", "max_abs_err")},
              at_autotune_shape={k: fa_auto[k] for k in (
                  "shape", "dtype", "ms", "plain_ms", "library_ms",
                  "library_kernel", "bound_ms", "bound_by",
                  "bound_ms_f32_cores", "max_abs_err")},
              autotune_best=autotune["best"],
              autotune_best_ms=autotune["best_ms"]),
        entry("ell_onehot", "src/repro_torch/csrc/ell_onehot.cu",
              "src/repro/kernels/spmv/kernel.py:98", kern["ell_onehot"],
              "none in the JAX package; its entry point ell_matvec_onehot "
              "(onehot_path)", summed=timed),
        {"name": "adamw", "route": "cuda",
         "source": "src/repro_torch/csrc/adamw.cu",
         "replaces": "none: the JAX package's optimizer is jnp that XLA "
                     "fuses", "path": "train",
         "launches_per_step": adamw["launches_per_step"],
         "launches_by_path": {
             p: {k: n[k] for k in ("adamw_sumsq", "adamw_update")}
             for p, n in by_path.items() if "adamw_update" in n},
         "shape": f"{adamw['arch']}, {adamw['n_layers']} layers: "
                  f"{adamw['leaves']} leaves, {adamw['params']} parameters",
         "ms": adamw["step_ms"], "plain_ms": adamw["plain_ms"],
         "library_ms": None, "bound_ms": adamw["bound_ms"]["step_ms"],
         "bound_by": "bytes", "sumsq_ms": adamw["sumsq_ms"],
         "update_ms": adamw["update_ms"],
         "kernel_vs_plain_rel": adamw["kernel_vs_plain_rel"]},
        {"name": "moe_positions", "route": "cuda",
         "source": "src/repro_torch/csrc/moe_positions.cu",
         "replaces": "none: the JAX package's _positions is a jnp.cumsum "
                     "over a one-hot that XLA fuses",
         "path": "train_families", "launches": sum(
             f["launches"]["moe_positions"]
             for f in train_families.values() if "launches" in f),
         "launches_by_path": {p: n["moe_positions"]
                              for p, n in by_path.items()
                              if "moe_positions" in n},
         "shapes": [{k: r[k] for k in ("shape", "ms", "path_ms", "floor_ms",
                                       "plain_ms", "plain_reworks",
                                       "bound_ms")}
                    for r in positions["shapes"]],
         "library_ms": None, "bound_by": "bytes"},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def serve_main() -> int:
    """``--serve``: the serve phase alone (with the build), its JSON line
    last."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.device import resolve_device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(nvidia_smi_line(), flush=True)
    emit("serve", **phase_serve(resolve_device()))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--serve"]:
        sys.exit(serve_main())
    if len(sys.argv) == 3 and sys.argv[1] == "--family":
        sys.exit(family_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--dist":
        sys.exit(dist_main(sys.argv[2]))
    if len(sys.argv) in (5, 7) and sys.argv[1] == "--shard":
        sys.exit(shard_main(sys.argv[2:]))
    if len(sys.argv) == 3 and sys.argv[1] == "--train-family":
        sys.exit(train_family_main(sys.argv[2]))
    if sys.argv[1:] == ["--adamw"]:
        sys.exit(adamw_main())
    if sys.argv[1:] == ["--mla"]:
        sys.exit(mla_main())
    if sys.argv[1:] == ["--positions"]:
        sys.exit(positions_main())
    if len(sys.argv) == 3 and sys.argv[1] == "--graph-trace":
        sys.exit(graph_trace_main(int(sys.argv[2])))
    sys.exit(main())
