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
their bytes) and the least and largest max abs error against the CPU's
plain path (the sweep's own reference, ``chip_smoke.py`` gates it at
2e-5 in float32 and 3e-2 in bf16). The card's name, power limit and ECC
counters come first, the ECC counters again last.

``--fresh N`` instead starts N processes, each of which launches the
kernel once, its first launch, on ``tests/test_torch_cuda.py``'s first
attention case (2 x 3 x 256 x 64 float32 causal, inputs from
``default_rng(325)``), and computes the CPU's plain path and a float64
one on the same inputs: one JSON line with the distinct outputs of each
side across the processes (SHA-256 of their bytes) and the largest
distances kernel vs plain, kernel vs float64 and plain vs float64.
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

from chip_smoke import ecc_line, nvidia_smi_line, sweep_inputs  # noqa: E402


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


def fresh_child() -> dict:
    """One process's first kernel launch on FRESH_CASE beside the CPU's
    plain path and float64."""
    import numpy as np

    from repro_torch.device import resolve_device
    from repro_torch.kernels.flash_attention.ops import mha

    dev = resolve_device()
    rng = np.random.default_rng(sum(FRESH_CASE))
    arrays = [rng.standard_normal(FRESH_CASE).astype(np.float32)
              for _ in range(3)]
    out = mha(*(torch.from_numpy(a).to(dev) for a in arrays), causal=True)
    out = out.cpu()
    plain = mha(*(torch.from_numpy(a) for a in arrays), causal=True)
    q, k, v = (torch.from_numpy(a).double() for a in arrays)
    scores = q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5
    scores = scores.masked_fill(torch.ones(
        scores.shape[-2:], dtype=torch.bool).triu(1), float("-inf"))
    f64 = torch.softmax(scores, dim=-1) @ v

    def dist(a, b):
        return float((a.double() - b.double()).abs().max())
    return {"kernel": digest(out), "plain": digest(plain),
            "kernel_vs_plain": dist(out, plain),
            "kernel_vs_f64": dist(out, f64), "plain_vs_f64": dist(plain, f64)}


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
                                           for r in runs]}


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
    refs = [mha(*(torch.from_numpy(t).to(dtype) for t in a),
                causal=causal).float()
            for (_, _, dtype, causal), a in cases]

    def sweep(condition: str) -> None:
        for (case, a), ref in zip(cases, refs):
            qs, ks, dtype, causal = case
            xs = [torch.from_numpy(t).to(dev, dtype) for t in a]
            errs, seen = [], set()
            for _ in range(args.reps):
                o = mha(*xs, causal=causal)
                errs.append(float((o.float().cpu() - ref).abs().max()))
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
        "max_abs_err_max": max(float((o.float().cpu() - ref).abs().max())
                               for o in outs)}), flush=True)
    print(json.dumps({"ecc": ecc_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
