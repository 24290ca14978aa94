#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Usage: python3 chip_smoke.py        (from the repository root, one card)

Phases, each printing one JSON line:

  probe        card, capability, power limit, torch and nvcc versions
  build        nvcc build of the hand-written kernels (csrc/*.cu), with
               each function's registers and spills from ptxas
  kernels      each kernel against its plain PyTorch version on the card
               at the main path's shapes and on the reference sweep's
               cases; CUDA-event medians of kernel, plain version and one
               PyTorch library call, beside the bound (bytes or flops over
               the card's peak). ell_spmv runs on the main path's
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
  distributed  the 4-rank SpMV at the paper's size against the float64
               oracle
  race         two schedules with one sync removed must fail the value
               gate (and pass with it)
  main_path    the paper's loop: spmv_dag -> MCTS (budget 400) measured
               on real streams -> labels -> features -> Algorithm 1 ->
               rules, with every kernel's launch count over that run;
               then a second sweep of the same schedules under the same
               objective without a store (``rho_repeat``: Spearman rho
               of the two)
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

Then the card's ``name, power.limit``, one ``{"kernels": [...]}`` line
and, last, ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before the last line. Without CUDA, or without the repository beside
it, the script exits non-zero and prints no result.
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

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside tensor cores
TF32_FLOPS_PER_S = 495e12      # H100 SXM dense TF32 (NVIDIA data sheet)
PAPER_N, PAPER_NNZ, RANKS = 150_000, 1_500_000, 4
# One attention layer of qwen2.5-32b (n_heads=40, d_model=5120) at the
# train_4k length; the flash_attention space's instance.
ATTN = {"batch": 1, "heads": 40, "seq": 4096, "head_dim": 128}
ONEHOT_HB, ONEHOT_BLOCK_R = 512, 256
SLEEP_CYCLES = 50_000_000      # ~25 ms of device sleep (queues launches, delays a producer)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


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


def device_kernel(fn) -> str:
    """Name of the longest device kernel one call of ``fn`` launches,
    from a ``torch.profiler`` trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in p.key_averages()
               if e.device_time_total > 0 and "Activity Buffer" not in e.key]
    if not kernels:
        raise AssertionError("torch.profiler saw no device kernel")
    return max(kernels, key=lambda e: e.device_time_total).key


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


def phase_attention(dev) -> dict:
    """The flash-attention kernel at the autotune instance's shapes
    (default blocks 128 x 128) against its plain version and SDPA, and
    on the reference sweep's cases (through ``mha``'s padding) against
    the plain path of the same wrapper on the CPU."""
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

    # tests/test_kernels.py:118-156: causal sweep (ragged S, bf16, a
    # head dim padded to 64), cross-attention, decode alignment.
    sweep = []
    rng = np.random.default_rng(0)
    cases = [((2, 3, 256, 64), (2, 3, 256, 64), torch.float32, True),
             ((1, 2, 300, 64), (1, 2, 300, 64), torch.float32, True),
             ((2, 2, 256, 128), (2, 2, 256, 128), torch.bfloat16, True),
             ((1, 2, 64, 48), (1, 2, 64, 48), torch.float32, True),
             ((1, 2, 128, 64), (1, 2, 256, 64), torch.float32, False),
             ((1, 1, 128, 64), (1, 1, 384, 64), torch.float32, True)]
    for qs, ks, dtype, causal in cases:
        a = [rng.standard_normal(sh).astype(np.float32)
             for sh in (qs, ks, ks)]
        on_card = mha(*(torch.from_numpy(t).to(dev, dtype) for t in a),
                      causal=causal)
        on_cpu = mha(*(torch.from_numpy(t).to(dtype) for t in a),
                     causal=causal)
        e = float((on_card.float().cpu() - on_cpu.float()).abs().max())
        tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
        if not e <= tol:
            raise AssertionError(f"mha {qs} {ks} {dtype}: {e} > {tol}")
        sweep.append({"q": list(qs), "kv": list(ks), "dtype": str(dtype),
                      "causal": causal, "max_abs_err": e})
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


def phase_race(spmv, dev) -> dict:
    """Both checks must be caught by the value gate, and pass intact."""
    from repro_torch.core.dag import (BoundOp, Graph, Op, OpKind, Schedule,
                                      spmv_dag)
    from repro_torch.core.executor import op_impl, run_items
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
            return {"dropped": drop, "caught": True,
                    "gate": str(e).strip().splitlines()[0][:160]}
        raise AssertionError(f"removing {drop} was not caught by the gate")

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
    return {"checks": [spmv_race, toy_race]}


def phase_main_path(spmv, A, x, dev) -> tuple:
    from repro_torch.core.dag import spmv_dag
    from repro_torch.core.features import featurize
    from repro_torch.engine.wallclock import ExecutorEvaluator
    from repro_torch.kernels.pack import kernel as pack_k
    from repro_torch.kernels.spmv import kernel as spmv_k
    from repro_torch.rules import (algorithm1, extract_rulesets,
                                   label_times, render_rules_table,
                                   rules_by_class)
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
    labels = label_times(times)
    fm = featurize(g, res.schedules)
    tree = algorithm1(fm.X, labels.labels)
    table = render_rules_table(
        rules_by_class(extract_rulesets(tree, fm.features)), top_k=2)
    if "performance class" not in table:
        raise AssertionError("no rules table")
    print(table, flush=True)
    best, t_best = res.best()
    return res, {
        "platform": ev.platform, "objective": ev.objective_key(),
        "proposed": res.n_proposed, "schedules": len(res.schedules),
        "gated": ev.n_checked, "best_us": float(t_best) * 1e6,
        "worst_us": float(times.max()) * 1e6,
        "median_us": float(np.median(times)) * 1e6,
        "spread": float(times.max() / times.min()),
        "best_schedule": " ".join(str(i) for i in best.items),
        "classes": labels.n_classes,
        "class_sizes": np.bincount(labels.labels).tolist(),
        "features": len(fm.features), "tree_leaves": tree.n_leaves(),
        "tree_depth": tree.depth(),
        "tree_error": tree.training_error(fm.X, labels.labels),
        "y_rel_err": y_rel, "search_wall_s": wall,
        "rho_repeat": spearman(times, again),
        "sweep2_best_us": float(min(again)) * 1e6,
        "sweep2_worst_us": float(max(again)) * 1e6,
        "sweep2_wall_s": wall_again, "launches": launches}


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


def phase_model(res, card_wall_s: float) -> dict:
    """The H100 machine model on the main path's schedules, against the
    times the card measured for them."""
    import dataclasses

    from repro_torch.core import Machine, spmv_dag
    from repro_torch.engine import make_evaluator
    from repro_torch.rules import label_times

    g = spmv_dag(rows_per_rank=PAPER_N // RANKS,
                 nnz_per_rank=PAPER_NNZ // RANKS, value_bytes=4)
    t0 = time.perf_counter()
    model = make_evaluator(g, "vectorized").evaluate(res.schedules)
    vec_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim = make_evaluator(g, "sim").evaluate(res.schedules)
    sim_s = time.perf_counter() - t0
    if model != sim:
        raise AssertionError("vectorized and sim makespans differ")
    card = res.times_array()
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
        from repro_torch.spmv.distributed import (from_reference,
                                                  make_distributed_spmv)
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
    emit("probe", nvidia_smi=smi, **probe())

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

    y = make_distributed_spmv(parts, dev)(x)
    oracle = A.matvec(x)
    rel = float(np.abs(y - oracle).max() / np.abs(oracle).max())
    emit("distributed", rel_err=rel, ok=rel <= 1e-4)
    if not rel <= 1e-4:
        raise AssertionError(f"distributed y: rel err {rel} > 1e-4")

    emit("race", **phase_race(spmv, dev))
    res, main_path = phase_main_path(spmv, A, x, dev)
    emit("main_path", **main_path)
    emit("model", **phase_model(res, main_path["search_wall_s"]))
    driver = phase_driver(spmv, dev)
    emit("driver", **driver)
    del spmv
    torch.cuda.empty_cache()
    onehot_path = phase_onehot_path(dev)
    emit("onehot_path", **onehot_path)
    autotune = phase_autotune(dev)
    emit("autotune", **autotune)
    launches = {**main_path["launches"], **onehot_path["launches"],
                **autotune["launches"]}

    by_path = {"main_path": main_path["launches"],
               "driver": driver["launches"],
               "onehot_path": onehot_path["launches"],
               "autotune": autotune["launches"]}

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

    fa = kern["flash_attention"][0]

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
        entry("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention/kernel.py:80",
              kern["flash_attention"], "autotune",
              bound_ms_f32_cores=fa["bound_ms_f32_cores"],
              library_kernel=fa["library_kernel"],
              library_max_abs_err=fa["library_max_abs_err"],
              autotune_best=autotune["best"],
              autotune_best_ms=autotune["best_ms"]),
        entry("ell_onehot", "src/repro_torch/csrc/ell_onehot.cu",
              "src/repro/kernels/spmv/kernel.py:98", kern["ell_onehot"],
              "none in the JAX package; its entry point ell_matvec_onehot "
              "(onehot_path)", summed=timed),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
