"""Repeat the flash-attention kernel's sweep cases on the card.

Usage (from the repository root, one CUDA card):

    PYTHONPATH=src python examples/torch_flash_repeat.py \
        [--reps 200] [--load-s 25] [--fresh 0]

``chip_smoke.py``'s attention sweep (``ATTN_SWEEP``: the reference's
causal sweep, cross-attention and decode alignment, inputs from
``sweep_inputs``) goes through ``mha`` on the card ``--reps`` times a
case on the same inputs: first alone, then while a second process keeps
the card busy with float32 matrix products for ``--load-s`` seconds,
then ``--reps`` launches of the first case queued back to back before
one synchronisation. The kernel has no atomics and one writer for each
output element, so every launch must give the same bits. One JSON line
per case and condition: the number of distinct outputs (SHA-256 of
their bytes) and the least and largest max abs error against a float64
softmax of the same inputs (the sweep's own reference,
``kernels/flash_attention/ref.py:float64_attention``; the card tests
gate it at 2e-5 in float32 and 3e-2 in bf16). The card's name, power limit and ECC
counters come first, the ECC counters again last.

``--fresh N`` instead starts N processes, each of which launches the
kernel once, its first launch, on ``tests/test_torch_cuda.py``'s first
attention case (2 x 3 x 256 x 64 float32 causal, inputs from
``default_rng(325)``), and computes the CPU's plain path and a float64
one on the same inputs: one JSON line with the distinct outputs of each
side across the processes (SHA-256 of their bytes) and the largest
distances kernel vs plain, kernel vs float64 and plain vs float64. Each
process also records what could make its CPU path differ from
another's: ``torch.get_num_threads()``, its CPU affinity, the float32
matmul precision, oneDNN's float32 math mode, the CPU capability, the
OMP/MKL/oneDNN environment, each operand's address mod 64 as the plain
path receives it, and the plain path's output (digest and distance from
float64) again at each intra-op thread count from 1 to its own and with
k and v moved to each 16-byte offset mod 64. The first plain call runs
under a dispatch mode that keeps every aten op's output, and so does a
second call: ``first_call_ops`` names each op whose output differs
between the two, with the distance. ``processes`` lists each process's
record; ``by_plain_output`` groups the processes by their first plain
output.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import ecc_line, nvidia_smi_line, sweep_inputs  # noqa: E402,E501
from repro_torch.kernels.flash_attention.ref import float64_attention  # noqa: E402,E501


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.float().cpu().numpy().tobytes()).hexdigest()[:16]


def load(seconds: float) -> None:
    """Keep the card busy with 8192^2 float32 products."""
    a = torch.randn(8192, 8192, device="cuda")
    end = time.time() + seconds
    while time.time() < end:
        for _ in range(20):
            a = (a @ a).clamp_(-1, 1)
        torch.cuda.synchronize()


FRESH_CASE = (2, 3, 256, 64)


def cpu_math_state() -> dict:
    """What this process's CPU float32 path runs under."""
    state = {"num_threads": torch.get_num_threads(),
             "num_interop_threads": torch.get_num_interop_threads(),
             "affinity": len(os.sched_getaffinity(0)),
             "cpu_count": os.cpu_count(),
             "float32_matmul_precision":
                 torch.get_float32_matmul_precision(),
             "cpu_capability": torch.backends.cpu.get_cpu_capability(),
             "env": {k: v for k, v in sorted(os.environ.items())
                     if k.startswith(("OMP_", "MKL_", "KMP_", "DNNL_",
                                      "ONEDNN_", "GOMP_"))}}
    for name in ("fp32_precision", "mkldnn.fp32_precision",
                 "mkldnn.matmul.fp32_precision"):
        obj = torch.backends
        try:
            for part in name.split("."):
                obj = getattr(obj, part)
            state[f"torch.backends.{name}"] = str(obj)
        except AttributeError:
            state[f"torch.backends.{name}"] = None
    return state


def at_offset(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A copy of ``t`` whose data starts ``offset`` bytes past a 64-byte
    boundary."""
    words = offset // t.element_size()
    buf = torch.empty(t.numel() + 64, dtype=t.dtype)
    skip = (-buf.data_ptr() % 64) // t.element_size() + words
    out = buf[skip:skip + t.numel()].view(t.shape)
    return out.copy_(t)


def recording_mode():
    """A dispatch mode that keeps (op, output copy) of every aten op."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Recording(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.outputs = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if isinstance(out, torch.Tensor):
                self.outputs.append((str(func), out.detach().clone()))
            return out

    return Recording()


def differing_ops(first, second) -> list:
    """Each op whose output differs between two recorded calls."""
    return [{"i": i, "op": op, "max_abs_diff": float(
                (a.double() - b.double()).abs().max())}
            for i, ((op, a), (_, b)) in enumerate(zip(first, second))
            if a.dtype.is_floating_point and not torch.equal(a, b)]


def fresh_child() -> dict:
    """One process's first kernel launch on FRESH_CASE beside the CPU's
    plain path and float64, with the CPU path's state and its output
    under each thread count and operand alignment."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.device import resolve_device
    from repro_torch.kernels.flash_attention.ops import (attention_plain,
                                                         mha)

    dev = resolve_device()
    rng = np.random.default_rng(sum(FRESH_CASE))
    arrays = [rng.standard_normal(FRESH_CASE).astype(np.float32)
              for _ in range(3)]
    out = mha(*(torch.from_numpy(a).to(dev) for a in arrays), causal=True)
    out = out.cpu()
    state = cpu_math_state()
    with recording_mode() as first:
        plain = mha(*(torch.from_numpy(a) for a in arrays), causal=True)
    with recording_mode() as second:
        mha(*(torch.from_numpy(a) for a in arrays), causal=True)
    f64 = float64_attention(arrays, torch.float32, True)

    def dist(a, b):
        return float((a.double() - b.double()).abs().max())

    # mha's operands as its plain path receives them (FRESH_CASE needs
    # no padding: F.pad by zero, then the (B*H, S, D) view).
    b, h, s, d = FRESH_CASE
    ops = [F.pad(torch.from_numpy(a), (0, 0, 0, 0)).reshape(b * h, s, d)
           for a in arrays]
    state["operand_addr_mod64"] = [t.data_ptr() % 64 for t in ops]
    state["input_addr_mod64"] = [a.ctypes.data % 64 for a in arrays]
    f64_flat = f64.reshape(b * h, s, d)

    def plain_on(qf, kf, vf) -> dict:
        o = attention_plain(qf, kf, vf, causal=True, scale=d ** -0.5)
        return {"digest": digest(o), "vs_f64": dist(o, f64_flat)}

    by_threads = {}
    own = torch.get_num_threads()
    for n in range(1, own + 1):
        torch.set_num_threads(n)
        by_threads[n] = plain_on(*ops)
    torch.set_num_threads(own)
    by_offset = {off: plain_on(ops[0], at_offset(ops[1], off),
                               at_offset(ops[2], off))
                 for off in (0, 16, 32, 48)}
    again = mha(*(torch.from_numpy(a) for a in arrays), causal=True)
    return {"kernel": digest(out), "plain": digest(plain),
            "plain_again": digest(again),
            "kernel_vs_plain": dist(out, plain),
            "kernel_vs_f64": dist(out, f64), "plain_vs_f64": dist(plain, f64),
            "first_call_ops": differing_ops(first.outputs, second.outputs),
            "ops_recorded": len(first.outputs),
            "state": state, "plain_by_threads": by_threads,
            "plain_by_offset": by_offset}


def fresh(n: int) -> dict:
    """FRESH_CASE's first launch in each of ``n`` processes."""
    runs = []
    for _ in range(n):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--fresh-child"], capture_output=True,
                              text=True, timeout=300, check=True)
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    return {"condition": "fresh_processes", "q": list(FRESH_CASE),
            "processes": n,
            "distinct_kernel_outputs": len({r["kernel"] for r in runs}),
            "distinct_plain_outputs": len({r["plain"] for r in runs}),
            **{f"{k}_max": max(r[k] for r in runs)
               for k in ("kernel_vs_plain", "kernel_vs_f64",
                         "plain_vs_f64")},
            "kernel_vs_plain_by_process": [r["kernel_vs_plain"]
                                           for r in runs],
            "by_plain_output": {
                p: {"processes": [i for i, r in enumerate(runs)
                                  if r["plain"] == p],
                    "plain_vs_f64": max(r["plain_vs_f64"] for r in runs
                                        if r["plain"] == p)}
                for p in sorted({r["plain"] for r in runs})},
            "processes": runs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--load-s", type=float, default=25.0)
    ap.add_argument("--fresh", type=int, default=0)
    ap.add_argument("--load", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--fresh-child", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.load:
        load(args.load_s)
        return 0
    if args.fresh_child:
        print(json.dumps(fresh_child()), flush=True)
        return 0
    if args.fresh:
        print(nvidia_smi_line(), flush=True)
        print(json.dumps(fresh(args.fresh)), flush=True)
        print(json.dumps({"ecc": ecc_line()}), flush=True)
        return 0
    from repro_torch.device import resolve_device
    from repro_torch.kernels.flash_attention.ops import mha

    dev = resolve_device()
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ecc": ecc_line()}), flush=True)
    cases = sweep_inputs()
    refs = [float64_attention(a, dtype, causal)
            for (_, _, dtype, causal), a in cases]

    def sweep(condition: str) -> None:
        for (case, a), ref in zip(cases, refs):
            qs, ks, dtype, causal = case
            xs = [torch.from_numpy(t).to(dev, dtype) for t in a]
            errs, seen = [], set()
            for _ in range(args.reps):
                o = mha(*xs, causal=causal)
                errs.append(float((o.cpu().double() - ref).abs().max()))
                seen.add(digest(o))
            print(json.dumps({
                "condition": condition, "q": list(qs), "kv": list(ks),
                "dtype": str(dtype), "causal": causal, "reps": args.reps,
                "distinct_outputs": len(seen), "max_abs_err_min": min(errs),
                "max_abs_err_max": max(errs)}), flush=True)

    sweep("alone")
    other = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              "--load", "--load-s", str(args.load_s)])
    try:
        time.sleep(min(6.0, args.load_s / 4))   # its context and first products
        sweep("card_loaded")
    finally:
        other.wait()
    (case, a), ref = cases[0], refs[0]
    xs = [torch.from_numpy(t).to(dev, case[2]) for t in a]
    outs = [mha(*xs, causal=case[3]) for _ in range(args.reps)]
    torch.cuda.synchronize()
    print(json.dumps({
        "condition": "queued", "q": list(case[0]), "reps": args.reps,
        "distinct_outputs": len({digest(o) for o in outs}),
        "max_abs_err_max": max(float((o.cpu().double() - ref).abs().max())
                               for o in outs)}), flush=True)
    print(json.dumps({"ecc": ecc_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
