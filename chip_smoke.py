#!/usr/bin/env python3
"""The per-kernel table of the PyTorch/CUDA port (``src/repro_torch``) on
one GPU: each hand-written kernel against its plain PyTorch version and,
where there is one, a PyTorch library call, at the shapes the
benchmark's cells run, beside its bound (bytes or flops over the card's
data-sheet peak).

Usage: python3 chip_smoke.py                    (from the repository root)
       python3 chip_smoke.py --adamw            (that phase alone)
       python3 chip_smoke.py --positions        (that phase alone)
       python3 chip_smoke.py --train-attention  (that phase alone)

Correctness on the card is ``python -m pytest -m cuda
tests/test_torch_cuda.py``; the port's end-to-end measurement is
``portbench/``. Phases, each printing one JSON line:

  probe      card, capability, power limit, torch and nvcc versions
  build      nvcc build of the hand-written kernels (csrc/*.cu), with
             each function's registers and spills from ptxas
  setup      the paper's matrix (150,000 rows, 1.5 M non-zeros in a band
             of n/4, 4 ranks) in the distributed SpMV's sorted-slice
             layout
  kernels    CUDA-event medians of kernel, plain version and library
             call, beside the bound. ell_spmv on the setup's operands
             (``slots_read`` = sum(slice_k) x 32 beside ``nnz``), also
             on the same rows padded to K (``plain_ms_padded``: the
             plain version on those); its ``bound_ms`` counts the
             product's own bytes, ``bound_ms_slots`` the slots the
             layout reads and ``bound_ms_layout`` its perm and slice_k
             as well. pack on the setup's send indices. ell_onehot on
             the paper's n and nnz in a band of half-width 512, against
             the float64 oracle too, and on the reference sweep's cases.
             These three also report ``ms_warm`` (no L2 flush, as on the
             main path) and ``floor_ms`` (an empty kernel of the same
             grid, timed the same way). Flash attention at the prefill
             cell's shape (deepseek-moe-16b, bf16, 4 x 1,024, 16 q on
             16 kv heads x 128) as served (B, S, H, D), and flat (BH,
             S, D), against SDPA, and at the autotune
             instance (f32, 1 x 40 x 4,096 x 128, its bound its 3xTF32
             work on the tensor cores, ``bound_ms_f32_cores`` beside),
             each library call's kernel named from a ``torch.profiler``
             trace; and on the reference sweep's cases against a float64
             softmax of the same inputs, the CPU float32 path's distance
             from it reported beside
  main_path  each benchmark cell's entry point once (PATHS), every
             kernel's launch count set to 0 just before: the search's
             evaluator on the setup's SpMV (4 designs, each captured,
             gated and timed; ell_spmv and pack launched), LM.prefill at
             the prefill cell's shape (one flash and one slot-position
             launch a layer), one make_train_step step at train-4k's
             and at train-8k's (no flash launch, two forward launches
             of the training attention a layer, the forward and the
             checkpoint's recompute, and one of each of its backward
             passes, two slot-position launches a MoE layer, one sum of
             squares a leaf and the norm's finish, one update a leaf);
             other counts fail
  adamw      AdamW's two kernels (csrc/adamw.cu) at deepseek-moe-16b's
             55 leaves with 4 of its 28 layers (the train-4k cell), in a
             process of its own: each leaf's sum of squares against
             float64 and its update against the plain version on the
             same state (within ADAMW_TOL, else a failure); medians, L2
             flushed, of the sums of squares, the updates, AdamW.step
             whole and the plain step, beside the 32 bytes a parameter
             bound; one step's launches
  positions  the MoE dispatch's slot-position kernel
             (csrc/moe_positions.cu) at the three MoE cells' shapes
             (POSITIONS), in a process of its own: pos and keep against
             the plain version, exactly, in one launch (else a failure);
             medians, L2 flushed, of the kernel, of ``_positions`` on
             top-k's indices as the model passes them, of an empty kernel
             of the same grid and of the plain version, beside the 17
             bytes an entry bound; ``_positions`` on DTensors of a
             one-rank NCCL mesh (sharded on B, replicated: the kernel;
             sharded on S: refused)
  train_attention
             the training attention's kernels
             (csrc/flash_attention_train.cu) at the two train cells'
             shapes (TRAIN_ATTN), in a process of its own: the forward
             and backward through the autograd Function against the
             streaming softmax's autograd, every element of o, dq, dk
             and dv (within TRAIN_ATTN_TOL, else a failure); medians,
             L2 flushed, of
             the forward and backward together and of each launch
             alone, of the streaming route and of SDPA's forward and
             backward (the library yardstick), beside the bound: the
             work 6 (D_QK + D_V) FLOPs a causal pair at the bf16 peak

Then the card's ``name, power.limit``, one ``{"kernels": [...]}`` line
with an entry for each of ell_spmv, pack, flash_attention, ell_onehot,
adamw, moe_positions and flash_attention_train (its launches on each
main path that launched it, ms, plain ms, bound ms, library ms where
there is a library call, the worst error) and, last, ``{"ok": true, "device":
{...}}``. Any failure exits non-zero before the last line. Without CUDA
the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.launch.costs import HBM_BW, PEAK_FLOPS  # noqa: E402

F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside tensor cores
TF32_FLOPS_PER_S = 495e12      # H100 SXM dense TF32 (NVIDIA data sheet)
PAPER_N, PAPER_NNZ, RANKS = 150_000, 1_500_000, 4
# One attention layer of qwen2.5-32b (n_heads=40, d_model=5120) at the
# train_4k length; the flash_attention space's instance.
ATTN = {"batch": 1, "heads": 40, "seq": 4096, "head_dim": 128}
# The benchmark's prefill cell: deepseek-moe-16b's heads (16 q on 16 kv,
# 128 wide), 4 x 1,024 prompt tokens a batch.
SERVE = {"arch": "deepseek-moe-16b", "batch": 4, "prompt": 1024}
# The main_path phase: each benchmark cell's entry point once, at its
# configuration's widths and depth and its traffic's shape (the port's
# own init in place of the cell's weights: launches do not depend on
# them). "search" evaluates the first ``designs`` of the 280 designs at
# 2 streams as search-graph does, each captured into a CUDA graph.
PATHS = {"search": {"designs": 4, "streams": 2},
         "prefill": {"arch": "deepseek-moe-16b", "n_layers": 4,
                     "batch": 4, "seq": 1024},
         "train_4k": {"arch": "deepseek-moe-16b", "n_layers": 4,
                      "batch": 1, "seq": 4096},
         "train_8k": {"arch": "moonlight-16b-a3b", "n_layers": 5,
                      "batch": 1, "seq": 8192}}
ONEHOT_HB, ONEHOT_BLOCK_R = 512, 256
# time_cuda queues its samples behind a device sleep of this many cycles a
# sample (~250 us at 1.98 GHz), at least 100 samples' worth (~25 ms): the
# host enqueues a sample (flush, two events, the call) in 100-190 us, and
# a sample it enqueues after the sleep has ended holds the host's gap.
QUEUE_CYCLES_PER_SAMPLE = 500_000
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
# The train_attention phase: csrc/flash_attention_train.cu at (B, S, H,
# D_QK, D_V) of the benchmark's train-4k (deepseek-moe-16b's 16 heads of
# 128) and train-8k (Moonlight's latent attention, 16 heads of 192 / 128)
# cells. Its work: causal pairs B H S (S + 1) / 2, 2 (D_QK + D_V) FLOPs a
# pair forward and 4 (D_QK + D_V) backward (the train_mla.mfu attention
# term); what the kernels run besides (the recompute of S and dP, P and
# dS split into two bf16 products) is reported as ``kernel_flops``. The
# kernel route is held to the streaming route element by element, as the
# card tests hold it: |got - ref| <= TRAIN_ATTN_TOL[0] |ref| +
# TRAIN_ATTN_TOL[1] max |ref| for every element of o, dq, dk and dv. Both
# routes round an f32-accurate value once to bf16, so they differ by at
# most one bf16 step (2^-7 of a power of two, less above it); the rest is
# their f32 sums in other orders.
TRAIN_ATTN = {"shapes": {"train_4k": (1, 4096, 16, 128, 128),
                         "train_8k": (1, 8192, 16, 192, 128)},
              "iters": 10, "plain_iters": 3, "seed": 0, "timeout_s": 600}
TRAIN_ATTN_TOL = (2 ** -7, 1e-4)


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
    ``dirty=False`` flushes by reading that buffer instead. The warm-up
    runs the flush too: its first launch in a process loads its kernel,
    and a host that falls behind the sleep puts its own gap into the
    samples (2x-3x a 13 us kernel's time)."""
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")

    def evict():
        flush.zero_() if dirty else flush.sum()

    for _ in range(3):
        if cold:
            evict()
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda._sleep(QUEUE_CYCLES_PER_SAMPLE * max(iters, 100))
    for s, e in zip(starts, ends):
        if cold:
            evict()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def bound_ms(n_bytes: float, flops: float,
             flops_per_s: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BW * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_kernels(calls: dict) -> dict:
    """The longest device kernel of each of ``calls`` (name -> fn, called
    three times inside a ``record_function`` span that starts and ends
    with a sync), from one torch.profiler session's Chrome trace: the
    kernel events inside the span on the device's timeline (its
    ``gpu_user_annotation``; the host's span is milliseconds off that
    clock). One session serves the script: on the card's machine a
    fourth session in one process has recorded no kernels."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        for name, fn in calls.items():
            with record_function(f"part.{name}"):
                torch.cuda.synchronize()
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        p.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans = {e["name"][len("part."):]: (e["ts"], e["ts"] + e["dur"])
             for e in events if e.get("cat") == "gpu_user_annotation" and
             e.get("name", "").startswith("part.")}
    out = {}
    for name in calls:
        if name not in spans:
            raise AssertionError(f"torch.profiler saw no device work in "
                                 f"{name}")
        lo, hi = spans[name]
        by_name: dict = {}
        for e in events:
            if e.get("cat") == "kernel" and lo <= e["ts"] <= hi:
                by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
        if not by_name:
            raise AssertionError(f"torch.profiler saw no device kernel "
                                 f"in {name}")
        out[name] = max(by_name, key=by_name.get)
    return out


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max |ref|)."""
    err = float((got.float() - ref.float()).abs().max())
    return err, err / (float(ref.float().abs().max()) + 1e-30)


def worst_ratio(got: torch.Tensor, ref: torch.Tensor, rel: float,
                floor: float) -> float:
    """max |got - ref| / (rel |ref| + floor max |ref|) over the elements:
    above 1 where an element is beyond its limit."""
    got, ref = got.double(), ref.double()
    lim = rel * ref.abs() + floor * ref.abs().max()
    return float(((got - ref).abs() / lim).max())


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


def phase_kernels(spmv, dev) -> dict:
    """ell_spmv (yL and yR) and pack on the main path's operands at the
    paper's size."""
    from repro_torch.kernels.pack.ops import pack, pack_plain
    from repro_torch.kernels.spmv.kernel import SLICE_ROWS, spmv_grid
    from repro_torch.kernels.spmv.ops import (BLOCK_N, ell_matvec_t,
                                              ell_spmv_plain, sliced_matvec,
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
    return {"ell_spmv": calls, "pack": [pack_call]}


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


def flash_bf16_call(shape, flops, q, k, v, sdpa_args, sdpa_kw) -> tuple:
    """The bf16 kernel (blocks 128 x 128, causal) on q, k, v against its
    plain version (max abs error above 3e-2 fails) and SDPA on
    ``sdpa_args`` (its output (B, H, S, D)): the entry, and SDPA's call
    (its kernel is named later, in the script's one profiler session)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention.ops import attention_plain

    scale = q.shape[-1] ** -0.5
    out = torch.empty_like(q)

    def kernel():
        return fa_k.flash_attention(q, k, v, out, causal=True, block_q=128,
                                    block_k=128, scale=scale)

    def plain():
        return attention_plain(q, k, v, causal=True, scale=scale)

    def sdpa():
        return F.scaled_dot_product_attention(*sdpa_args, is_causal=True,
                                              **sdpa_kw)

    got = kernel().clone()
    ref = plain()
    err, rel = rel_err(got, ref)
    if not err <= 3e-2:
        raise AssertionError(f"flash_attention bf16 {shape}: max abs err "
                             f"{err}")
    lib = sdpa()
    if len(shape) == 5:                  # served: (B, S, H, D) here
        lib = lib.transpose(1, 2)
    lib_err = float((lib.reshape(ref.shape).float() - ref.float())
                    .abs().max())
    n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, out))
    bnd, by = bound_ms(n_bytes, flops, PEAK_FLOPS)
    return {
        "op": "flash_attention", "shape": shape, "dtype": "bfloat16",
        "causal": True, "block_q": 128, "block_k": 128, "flops": flops,
        "bytes": n_bytes, "max_abs_err": err, "rel_err": rel,
        "ms": time_cuda(kernel, iters=20),
        "plain_ms": time_cuda(plain, iters=5),
        "library_ms": time_cuda(sdpa, iters=20),
        "library_call": "scaled_dot_product_attention(is_causal=True"
                        + "".join(f", {name}={val}" for name, val in
                                  sdpa_kw.items()) + ")",
        "library_max_abs_err": lib_err,
        "bound_ms": bnd, "bound_by": by}, sdpa


def phase_attention(dev) -> dict:
    """The flash-attention kernel at three shapes against its plain
    version and SDPA: the prefill cell's shape as served and flat
    (bf16), and the autotune instance (f32, default blocks 128 x 128);
    then the reference sweep's cases (through ``mha``'s padding) against
    a float64 softmax of the same inputs (``float64_attention``). The CPU
    float32 plain path's distance from float64 is reported beside the
    kernel's; it is not what the kernel is held to, since it differs
    between processes (PERF.md)."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention.ops import attention_plain, mha
    from repro_torch.kernels.flash_attention.ref import float64_attention

    # The prefill cell's shape in bfloat16: as served (q and the output
    # (B, S, H, D), k and v (B, S, Hkv, D), as the projections leave
    # them: q head h reads kv head h // (H / Hkv) in the kernel) and flat
    # (every q head its own k and v, each head's rows contiguous, (BH, S,
    # D)).
    cfg = get_config(SERVE["arch"])
    b, s = SERVE["batch"], SERVE["prompt"]
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = (t.to(torch.bfloat16) for t in attention_inputs(
        dev, b, h, s, d, seed=3))
    # Useful causal work: query i meets i + 1 keys (S = Sq = Skv), two
    # flops per multiply-add in q.k and in p.v.
    flops = 4.0 * b * h * s * (s + 1) / 2 * d
    qs = q.transpose(1, 2).contiguous()
    ks, vs = (t[:, :hkv].transpose(1, 2).contiguous() for t in (k, v))
    served, sdpa_served = flash_bf16_call(
        [b, s, h, hkv, d], flops, qs, ks, vs,
        [t.transpose(1, 2) for t in (qs, ks, vs)],
        {"enable_gqa": True} if hkv < h else {})
    qf, kf, vf = (t.reshape(b * h, s, d) for t in (q, k, v))
    flat, sdpa_flat = flash_bf16_call([b, h, s, d], flops, qf, kf, vf,
                                      [q, k, v], {})
    del qs, ks, vs

    # The autotune instance in float32. The kernel runs its products on
    # the tensor cores in 3xTF32: three TF32 products for each float32
    # one.
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
    flops = 4.0 * b * h * s * (s + 1) / 2 * d
    n_bytes = 4 * q.numel() * q.element_size()
    bnd, by = bound_ms(n_bytes, 3 * flops, TF32_FLOPS_PER_S)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    lib_err = float((sdpa().reshape(b * h, s, d) - plain).abs().max())
    autotune = {
        "op": "mha", "shape": [b, h, s, d], "dtype": "float32",
        "causal": True, "block_q": 128, "block_k": 128, "flops": flops,
        "bytes": n_bytes, "max_abs_err": err, "rel_err": rel,
        "ms": time_cuda(kernel, iters=10),
        "plain_ms": time_cuda(lambda: attention_plain(
            qf, kf, vf, causal=True, scale=scale), iters=5),
        "library_ms": time_cuda(sdpa, iters=10),
        "library_max_abs_err": lib_err,
        "bound_ms": bnd, "bound_by": by,
        "bound_ms_f32_cores": bound_ms(n_bytes, flops)[0]}
    del plain, got
    names = library_kernels({"served": sdpa_served, "flat": sdpa_flat,
                             "autotune": sdpa})
    for call, part in ((served, "served"), (flat, "flat"),
                       (autotune, "autotune")):
        call["library_kernel"] = names[part]

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
    return {"flash_attention": {"served": served, "flat": flat,
                                "autotune": autotune},
            "flash_attention_sweep": sweep}


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
    plain version and the float64 oracle, beside ell_spmv and torch.mv on
    the same matrix, and on the reference sweep's cases."""
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
    return {"ell_onehot": [call], "ell_onehot_sweep": sweep}


def kernel_counters() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from repro_torch.kernels.adamw import kernel as adamw_k
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention import train as ft
    from repro_torch.kernels.moe_positions import kernel as positions_k
    from repro_torch.kernels.pack import kernel as pack_k
    from repro_torch.kernels.spmv import kernel as spmv_k

    return {"ell_spmv": spmv_k.ell_spmv, "pack": pack_k.pack,
            "flash_attention": fa_k.flash_attention,
            "ell_onehot": spmv_k.ell_onehot,
            "adamw_sumsq": adamw_k.sumsq, "adamw_update": adamw_k.update,
            "moe_positions": positions_k.positions,
            "flash_train_fwd": ft.forward, "flash_train_dq": ft.backward_dq,
            "flash_train_dkdv": ft.backward_dkdv}


def counted(run) -> tuple:
    """``run()``'s result and each kernel's launches in it, every count
    set to 0 just before."""
    kernels = kernel_counters()
    for kern in kernels.values():
        kern.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {name: kern.launches for name, kern in kernels.items()}


def lm_of(path: dict, dev):
    """The port's LM at ``path``'s configuration and depth, one batch of
    its shape drawn from seed 0, and its number of MoE layers."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import LM

    cfg = dataclasses.replace(get_config(path["arch"]),
                              n_layers=path["n_layers"])
    ids = torch.randint(0, cfg.vocab, (path["batch"], path["seq"] + 1),
                        generator=torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    moe_layers = (cfg.n_layers - cfg.first_k_dense) if cfg.moe else 0
    return (LM(cfg, device=dev, seed=0),
            {"tokens": ids[:, :-1], "labels": ids[:, 1:]}, moe_layers)


def prefill_path(dev) -> dict:
    """LM.prefill as the prefill cell's driver calls it: one flash launch
    and one slot-position launch a layer."""
    path = PATHS["prefill"]
    model, batch, moe_layers = lm_of(path, dev)
    (logits, _), launches = counted(
        lambda: model.prefill(batch["tokens"], path["seq"]))
    want = {"flash_attention": path["n_layers"],
            "moe_positions": moe_layers, "flash_train_fwd": 0,
            "flash_train_dq": 0, "flash_train_dkdv": 0}
    if not bool(torch.isfinite(logits).all()) or any(
            launches[k] != n for k, n in want.items()):
        raise AssertionError(f"prefill path: {launches}, {want} wanted, "
                             f"finite {bool(torch.isfinite(logits).all())}")
    return launches


def train_path(name: str, dev) -> dict:
    """One step of make_train_step under the cells' AdamW: the training
    attention's kernels (no launch of the served flash kernel), a forward
    launch a layer in the forward and one in the checkpoint's recompute
    and one of each backward pass a layer, one slot-position launch a
    MoE layer in the forward and one in the recompute, one sum of squares
    a leaf and the norm's finish, one update a leaf."""
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    from repro_torch.train.step import make_train_step

    path = PATHS[name]
    model, batch, moe_layers = lm_of(path, dev)
    opt = AdamW(learning_rate=warmup_cosine(3e-3, 20, 200),
                grad_clip_norm=1.0)
    step = make_train_step(model, opt)
    params = dict(model.named_parameters())
    state = opt.init(params)
    (_, _, met), launches = counted(lambda: step(params, state, batch))
    passes = 2 if model.cfg.remat else 1
    layers = sum(d.kind == "attn" for d in model.descs)
    want = {"flash_attention": 0, "moe_positions": moe_layers * passes,
            "adamw_sumsq": len(params) + 1, "adamw_update": len(params),
            "flash_train_fwd": layers * passes, "flash_train_dq": layers,
            "flash_train_dkdv": layers}
    if not bool(torch.isfinite(met["loss"])) or any(
            launches[k] != n for k, n in want.items()):
        raise AssertionError(f"{name} path: {launches}, {want} wanted, "
                             f"loss {float(met['loss'])}")
    return launches


def phase_main_path(spmv, dev) -> dict:
    """Each benchmark cell's entry point once (PATHS), every kernel's
    launches counted from 0 just before: the search's evaluator on the
    setup's SpMV (each design gated, ell_spmv and pack launched), the
    prefill, and a train-4k and a train-8k step. Only the kernels a path
    launched are reported."""
    from repro_torch.core.dag import spmv_dag
    from repro_torch.core.enumerate import enumerate_schedules
    from repro_torch.engine.wallclock import ExecutorEvaluator

    g, search = spmv_dag(), PATHS["search"]
    designs = list(enumerate_schedules(g, search["streams"]))
    designs = designs[:search["designs"]]
    ev = ExecutorEvaluator(g, impls=spmv.impls(), env=spmv.env(),
                           reset=spmv.poison, repeats=3, warmup=3,
                           t_measure_s=0.005, device=dev,
                           store_tag=spmv.store_tag, cuda_graph=True)
    times, launches = counted(lambda: ev.evaluate(designs))
    if not (ev.n_checked == len(designs) and launches["ell_spmv"] > 0 and
            launches["pack"] > 0 and all(0 < t < 1 for t in times)):
        raise AssertionError(f"search path: {ev.n_checked} of "
                             f"{len(designs)} gated, {launches}, {times}")
    by_path = {"search": launches, "prefill": prefill_path(dev)}
    torch.cuda.empty_cache()
    for name in ("train_4k", "train_8k"):
        by_path[name] = train_path(name, dev)
        torch.cuda.empty_cache()
    return {p: {k: n for k, n in c.items() if n}
            for p, c in by_path.items()}


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
    bytes bound; the launches of one step."""
    import dataclasses

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
    worst_abs = 0.0
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
            err = float((got - ref).abs().max())
            worst_abs = max(worst_abs, err)
            worst[name] = max(worst[name], err / float(ref.abs().max()))
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
    opt.step(grads, state, params)
    torch.cuda.synchronize()
    launches = {f"adamw_{f.__name__}": f.launches - b
                for f, b in before.items()}
    if launches != {"adamw_sumsq": len(leaves) + 1,
                    "adamw_update": len(leaves)}:
        raise AssertionError(f"adamw: a step launched {launches}")
    if not all(bool(torch.isfinite(t).all()) for leaf in leaves
               for t in leaf):
        raise AssertionError("adamw: a non-finite parameter or moment")
    bound = {"sumsq_ms": 4 * n, "update_ms": 28 * n, "step_ms": 32 * n,
             "plain_ms": 32 * n}
    return {
        "arch": ADAMW["arch"], "n_layers": ADAMW["n_layers"],
        "leaves": len(leaves), "params": n, **ms,
        "bound_ms": {k: b / HBM_BW * 1e3 for k, b in bound.items()},
        "share_of_bound": {k: b / HBM_BW * 1e3 / ms[k]
                           for k, b in bound.items()},
        "gb_per_s": {k: b / (ms[k] * 1e-3) / 1e9 for k, b in bound.items()},
        "kernel_vs_plain_rel": worst, "kernel_vs_plain_abs": worst_abs,
        "sumsq_vs_float64_rel": sum_err, "tol": ADAMW_TOL,
        "launches_per_step": launches,
        "max_memory_allocated": torch.cuda.max_memory_allocated()}


def positions_run(dev) -> dict:
    """The positions phase (module docstring) at POSITIONS' shapes, each
    on one draw of every token's 6 distinct experts of 64, as top-k
    gives them; raises where the kernel's pos or keep differ from the
    plain version's or where a call launches other than once."""
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
        pos, keep = moe._positions(view, e, c)
        launches = positions_k.positions.launches - before
        want_pos, want_keep = moe._positions_plain(top_e, e, c)
        exact = torch.equal(pos, want_pos) and torch.equal(keep, want_keep)
        if not exact or launches != 1:
            raise AssertionError(f"positions {(b, s, k)}: exact {exact}, "
                                 f"{launches} launches")
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
        bound = 17 * top_e.numel() / HBM_BW * 1e3
        rows.append({"shape": [b, s, k], "experts": e, "capacity": c,
                     "entries": top_e.numel(), "grid": list(grid), **ms,
                     "bound_ms": bound, "bound_by": "bytes",
                     "share_of_bound": bound / ms["ms"],
                     "drops": int((~keep).sum()), "exact": exact,
                     "launches_per_call": launches})
    return {"shapes": rows, "mesh": positions_mesh_check(dev)}


def positions_mesh_check(dev) -> dict:
    """``_positions`` on DTensors of a one-rank NCCL mesh: sharded on B
    and replicated, the kernel on the local shard (equal to the plain
    version, else a failure); sharded on S, refused."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels.moe_positions import kernel as positions_k
    from repro_torch.launch.mesh import free_port
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


def child_main(run, source: str) -> int:
    """``--adamw``, ``--positions``: one phase alone (its kernel's
    build), the card's name and power limit, and its JSON result last,
    with its kernel's ptxas lines."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    logs = build.build()["logs"].get(source, "")
    smi = nvidia_smi_line()
    print(smi, flush=True)
    res = run(resolve_device())
    res["nvidia_smi"] = smi
    res["ptxas"] = [ln.strip() for ln in logs.splitlines() if any(
        w in ln for w in ("Compiling entry function", "registers", "spill"))]
    print(json.dumps(res), flush=True)
    return 0


def train_attention_run(dev) -> dict:
    """The train_attention phase (module docstring) at TRAIN_ATTN's
    shapes: the autograd Function's output and gradients against the
    streaming route's on the same operands, element by element (an
    element beyond TRAIN_ATTN_TOL fails; ``worst`` is each output's
    largest |got - ref| over its limit), then CUDA-event medians, the L2
    flushed before each call, of the forward and backward together, each
    launch alone, the streaming route and SDPA, beside the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import train as ft
    from repro_torch.models import attention as attn

    out = []
    for cell, (b, s, h, d_qk, d_v) in TRAIN_ATTN["shapes"].items():
        gen = torch.Generator(device=dev).manual_seed(TRAIN_ATTN["seed"])
        q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device=dev
                                   ).to(torch.bfloat16)
                       for d in (d_qk, d_qk, d_v, d_v))
        leaves = [t.requires_grad_() for t in (q, k, v)]
        scale = attn.q_scale(d_qk, torch.bfloat16)
        pos = torch.arange(s, device=dev)
        valid = torch.ones(s, dtype=torch.bool, device=dev)

        def kernel():
            o = attn.train_attention(*leaves)
            return (o, *torch.autograd.grad(o, leaves, do))

        def plain():
            o = attn.streaming_attention(*leaves, pos, pos, valid,
                                         causal=True)
            return (o, *torch.autograd.grad(o, leaves, do))

        if not attn.trains_on_kernel(*leaves):
            raise AssertionError(f"train_attention {cell}: not on the "
                                 "kernel route")
        got, ref = ([t.detach() for t in run()] for run in (kernel, plain))
        torch.cuda.synchronize()
        errs = {name: rel_err(a, r) for name, a, r in
                zip(("o", "dq", "dk", "dv"), got, ref)}
        worst = {name: worst_ratio(a, r, *TRAIN_ATTN_TOL) for name, a, r
                 in zip(("o", "dq", "dk", "dv"), got, ref)}
        if not all(w <= 1 for w in worst.values()):
            raise AssertionError(f"train_attention {cell}: worst {worst}")
        del got, ref
        q0, k0, v0 = (t.detach() for t in leaves)
        o, o32, lse = ft.forward(q0, k0, v0, scale)
        _, delta = ft.backward_dq(q0, k0, v0, do, o32, lse, scale)
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                      for t in leaves)
        dot = do.transpose(1, 2)

        def sdpa():
            o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               scale=scale)
            return torch.autograd.grad(o, (qt, kt, vt), dot)

        try:
            library_ms, library_error = time_cuda(sdpa, iters=10), None
        except RuntimeError as e:       # a backend that refuses D_V != D_QK
            library_ms, library_error = None, str(e).splitlines()[0][:200]
        pairs = b * h * s * (s + 1) / 2
        flops = 6 * pairs * (d_qk + d_v)
        kernel_flops = 2 * pairs * ((d_qk + 2 * d_v) +
                                    (d_qk + d_v + 2 * d_v + 2 * d_qk) +
                                    (d_qk + d_v + 2 * d_qk))
        n_bytes = 2 * 2 * sum(t.numel() for t in (q, k, v, do))
        bnd, by = bound_ms(n_bytes, flops, PEAK_FLOPS)
        ms = time_cuda(kernel, iters=TRAIN_ATTN["iters"])
        out.append({
            "cell": cell, "shape": [b, s, h, d_qk, d_v],
            "dtype": "bfloat16", "flops": flops,
            "kernel_flops": kernel_flops, "bytes": n_bytes,
            "max_abs_err": max(e for e, _ in errs.values()),
            "rel_err": {name: rel for name, (_, rel) in errs.items()},
            "worst": worst,
            "ms": ms,
            "fwd_ms": time_cuda(lambda: ft.forward(q0, k0, v0, scale),
                                iters=TRAIN_ATTN["iters"]),
            "dq_ms": time_cuda(lambda: ft.backward_dq(
                q0, k0, v0, do, o32, lse, scale), iters=TRAIN_ATTN["iters"]),
            "dkdv_ms": time_cuda(lambda: ft.backward_dkdv(
                q0, k0, v0, do, lse, delta, scale),
                iters=TRAIN_ATTN["iters"]),
            "plain_ms": time_cuda(plain, iters=TRAIN_ATTN["plain_iters"]),
            "library_ms": library_ms,
            "library_call": "scaled_dot_product_attention(is_causal=True) "
                            "forward and backward",
            "library_error": library_error,
            "bound_ms": bnd, "bound_by": by,
            "kernel_tflops_per_s": kernel_flops / ms / 1e9})
        del o, o32, lse, delta, leaves, q, k, v, do, q0, k0, v0
        torch.cuda.empty_cache()
    return {"shapes": out}


def kernel_table(kern: dict, adamw: dict, positions: dict,
                 train_attention: dict, by_path: dict) -> list:
    """One entry a kernel: its source, what it replaces in the JAX
    package, its launches on each main path that launched it, ms, plain
    ms, bound ms and library ms (summed over its calls; None where a call
    has none), the worst error, and what else its calls measured."""
    def entry(name, source, replaces, calls, summed=(), **extra):
        counts = {"adamw": ("adamw_sumsq", "adamw_update"),
                  "flash_attention_train": ("flash_train_fwd",
                                            "flash_train_dq",
                                            "flash_train_dkdv")}.get(
            name, (name,))
        return {"name": name, "source": source, "replaces": replaces,
                "launches_by_path": {p: {k: n[k] for k in counts}
                                     for p, n in by_path.items()
                                     if counts[0] in n},
                "max_abs_err": max(c["max_abs_err"] for c in calls),
                **{k: (None if any(c[k] is None for c in calls)
                       else sum(c[k] for c in calls))
                   for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                             *summed)},
                "bound_by": calls[0]["bound_by"], **extra}

    timed = ("ms_warm", "floor_ms")
    fa = kern["flash_attention"]
    served = fa["served"]
    shown = ("shape", "dtype", "ms", "plain_ms", "library_ms",
             "library_kernel", "bound_ms", "bound_by", "max_abs_err")
    rows = positions["shapes"]
    return [
        entry("ell_spmv", "src/repro_torch/csrc/ell_spmv.cu",
              "src/repro/kernels/spmv/kernel.py:49", kern["ell_spmv"],
              summed=(*timed, "plain_ms_padded", "bound_ms_slots",
                      "bound_ms_layout", "nnz", "slots_read")),
        entry("pack", "src/repro_torch/csrc/pack.cu",
              "src/repro/kernels/pack/kernel.py:49", kern["pack"],
              summed=timed),
        entry("flash_attention",
              "src/repro_torch/csrc/flash_attention_bf16.cu",
              "src/repro/kernels/flash_attention/kernel.py:80", [served],
              source_float32="src/repro_torch/csrc/flash_attention.cu",
              shape=served["shape"], dtype=served["dtype"],
              library_call=served["library_call"],
              library_kernel=served["library_kernel"],
              library_max_abs_err=served["library_max_abs_err"],
              at_flat_layout={k: fa["flat"][k] for k in shown},
              at_autotune_shape={k: fa["autotune"][k] for k in (
                  *shown, "bound_ms_f32_cores")}),
        entry("ell_onehot", "src/repro_torch/csrc/ell_onehot.cu",
              "src/repro/kernels/spmv/kernel.py:98", kern["ell_onehot"],
              summed=timed),
        entry("adamw", "src/repro_torch/csrc/adamw.cu",
              "none: the JAX package's optimizer is jnp that XLA fuses",
              [{"ms": adamw["step_ms"], "plain_ms": adamw["plain_ms"],
                "bound_ms": adamw["bound_ms"]["step_ms"],
                "library_ms": None, "bound_by": "bytes",
                "max_abs_err": adamw["kernel_vs_plain_abs"]}],
              shape=f"{adamw['arch']}, {adamw['n_layers']} layers: "
                    f"{adamw['leaves']} leaves, {adamw['params']} "
                    "parameters",
              sumsq_ms=adamw["sumsq_ms"], update_ms=adamw["update_ms"],
              kernel_vs_plain_rel=adamw["kernel_vs_plain_rel"]),
        entry("moe_positions", "src/repro_torch/csrc/moe_positions.cu",
              "none: the JAX package's _positions is a jnp.cumsum over a "
              "one-hot that XLA fuses",
              [{**r, "library_ms": None, "max_abs_err": 0} for r in rows],
              shapes=[{k: r[k] for k in ("shape", "ms", "path_ms",
                                         "floor_ms", "plain_ms",
                                         "bound_ms")} for r in rows]),
        entry("flash_attention_train",
              "src/repro_torch/csrc/flash_attention_train.cu",
              "none: the JAX package trains attention through its XLA "
              "streaming softmax (its Pallas kernel has no backward)",
              train_attention["shapes"],
              shapes=[{k: r[k] for k in (
                  "cell", "shape", "ms", "fwd_ms", "dq_ms", "dkdv_ms",
                  "plain_ms", "library_ms", "library_error", "bound_ms",
                  "kernel_tflops_per_s", "rel_err", "worst")}
                  for r in train_attention["shapes"]]),
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from repro_torch.device import probe, resolve_device
    from repro_torch.kernels import build
    from repro_torch.spmv.distributed import from_reference
    from repro_torch.spmv.matrix import (band_matrix, partition,
                                         stack_partitions)

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
    x = np.random.default_rng(1).standard_normal(PAPER_N).astype(
        np.float32)
    spmv = from_reference(stack_partitions(partition(A, RANKS)), x, dev)
    torch.cuda.synchronize()
    emit("setup", n=PAPER_N, nnz=PAPER_NNZ, ranks=RANKS, m=spmv.m,
         k_local=spmv.local.vals_t.shape[0],
         k_remote=spmv.remote.vals_t.shape[0],
         slots_read_local=int(spmv.local.slice_k.sum()) * 32,
         slots_read_remote=int(spmv.remote.slice_k.sum()) * 32,
         seconds=time.perf_counter() - t0)

    kern = phase_kernels(spmv, dev)
    by_path = phase_main_path(spmv, dev)
    emit("main_path", **by_path)
    del spmv
    torch.cuda.empty_cache()
    kern.update(phase_attention(dev))
    torch.cuda.empty_cache()
    kern.update(phase_onehot(dev))
    emit("kernels", **kern)
    adamw = phase_child("--adamw", ADAMW["timeout_s"])
    emit("adamw", **adamw)
    positions = phase_child("--positions", POSITIONS["timeout_s"])
    emit("positions", **positions)
    train_attention = phase_child("--train-attention",
                                  TRAIN_ATTN["timeout_s"])
    emit("train_attention", **train_attention)

    print(smi, flush=True)
    print(json.dumps({"kernels": kernel_table(
        kern, adamw, positions, train_attention, by_path)}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--adamw"]:
        sys.exit(child_main(adamw_run, "adamw"))
    if sys.argv[1:] == ["--positions"]:
        sys.exit(child_main(positions_run, "moe_positions"))
    if sys.argv[1:] == ["--train-attention"]:
        sys.exit(child_main(train_attention_run, "flash_attention_train"))
    sys.exit(main())
