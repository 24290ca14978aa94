"""Repeat the flash-attention kernel's sweep cases on the card.

Usage (from the repository root, one CUDA card):

    PYTHONPATH=src python examples/torch_flash_repeat.py \
        [--reps 200] [--load-s 25]

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--load-s", type=float, default=25.0)
    ap.add_argument("--load", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.load:
        load(args.load_s)
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
