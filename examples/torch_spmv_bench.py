"""Time the SpMV path's two kernels alone on the card, and show where
their time goes.

Usage (from the repository root, one CUDA card):

    PYTHONPATH=src python examples/torch_spmv_bench.py [--diagnose] [--sass]
    PYTHONPATH=src python examples/torch_spmv_bench.py --onehot [--sass]

At the paper's size (n = 150,000, nnz = 1,500,000, half-bandwidth n/4,
4 ranks in one process, as ``chip_smoke.py`` builds it) it prints one
JSON line for each kernel op of the distributed SpMV, called through
``DistributedSpmv``'s own methods: yL (``multiply_local``), yR
(``multiply_remote``) and Pack (``pack``). Each line has the CUDA-event
median µs cold (L2 flushed before each call) and warm
(``chip_smoke.time_cuda``), and yL and yR a SHA-256 of y's bytes, equal
wherever two runs agree bit for bit. Every tree of the port has those
methods, so the same script times another tree's package: unpack it
under ``build/`` (``git archive``), and alternate ``PYTHONPATH`` between
the two ``src`` directories in one call. Each line names the package.

``--diagnose`` (the sorted-slice layout's package) adds, for yL and yR,
the same kernel on two other inputs, each with an empty kernel of the
same grid timed the same way (the launch's floor):
- ``padded``: the same rows in row order, each read to K, which shows
  what the sorted-slice layout saves;
- ``diagonal``: the main path's operands with every slot's column
  replaced by its own position, so that a warp's 32 gathers of x fall
  on one 128-byte line instead of 32 scattered ones, with the same
  slots and bytes of vals_t and cols_t; which shows what the scattered
  gathers cost.

``--onehot`` times the narrow-band kernel instead (``ell_onehot``, the
one ``chip_smoke.py``'s kernels phase times): at the paper's n and nnz on
a band of half-width 512 (K = 10, block_r 256, a window of 1,280
floats, 586 CTAs), one JSON line with its cold and warm µs, its cold µs
with L2 flushed by a read (``us_clean_l2``: no dirty line of the flush
to write back while it reads), those of an empty kernel of its grid,
and a SHA-256 of y.

``--sass`` adds, for each function of the built ``libell_spmv.so`` and
``libpack.so`` (``libell_onehot.so`` with ``--onehot``), its global and
shared loads, stores, FMAs, bulk copies (``UBLKCP``), barrier
operations (``SYNCS.*``, ``BAR``) and branches in program order
(``cuobjdump -sass``, runs of one opcode collapsed to ``OPxN``), which
shows whether loads issue back to back or each waits on the one before.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (ONEHOT_BLOCK_R, ONEHOT_HB, PAPER_N,  # noqa: E402
                        PAPER_NNZ, RANKS, nvidia_smi_line, onehot_matrix,
                        time_cuda)

SASS_OPS = re.compile(r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?"
                      r"((?:LDG|STG|FFMA|LDS|STS|UBLKCP|SYNCS|BAR|BRA|EXIT)"
                      r"[.\w]*)")


def sass_schedule(lib: str) -> dict[str, str]:
    """Each function's LDG/STG/FFMA/BRA/EXIT opcodes in program order,
    runs collapsed (``LDGx8``)."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    out, name, ops = {}, None, []
    for line in text.splitlines() + ["Function : end"]:
        if "Function :" in line:
            if name is not None:
                runs, prev, count = [], None, 0
                for op in ops + [None]:
                    if op == prev:
                        count += 1
                        continue
                    if prev is not None:
                        runs.append(prev if count == 1 else f"{prev}x{count}")
                    prev, count = op, 1
                out[name] = " ".join(runs)
            name, ops = line.split("Function :", 1)[1].strip(), []
            continue
        m = SASS_OPS.match(line)
        if m:
            parts = m.group(1).split(".")
            ops.append(".".join(parts[:2]) if parts[0] == "SYNCS"
                       else parts[0])
    return out


def y_sha256(fn, y: torch.Tensor) -> str:
    """SHA-256 (16 hex digits) of y's bytes after one call of ``fn``
    into ``y``, which is filled with NaN first."""
    y.fill_(float("nan"))
    fn()
    torch.cuda.synchronize()
    return hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()[:16]


def onehot(tree: str, dev: torch.device, sass: bool) -> int:
    from repro_torch.kernels import build
    from repro_torch.kernels._launch import launch_floor
    from repro_torch.kernels.spmv.kernel import ell_onehot
    from repro_torch.kernels.spmv.ops import onehot_operands

    _, _, (vals, cols, x) = onehot_matrix(dev)
    br, window = ONEHOT_BLOCK_R, 2 * ONEHOT_HB + ONEHOT_BLOCK_R
    vt, cwt, xp = onehot_operands(vals, cols, x, ONEHOT_HB, br)
    k, n = vt.shape
    out = torch.empty(n, dtype=torch.float32, device=dev)

    def kernel():
        ell_onehot(vt, cwt, xp, out, window, br)

    def floor():
        launch_floor(dev, n // br, br)

    print(json.dumps({
        "kernel": "ell_onehot", "tree": tree, "K": k, "N": n,
        "window": window, "ctas": n // br,
        "y_sha256": y_sha256(kernel, out),
        "us": time_cuda(kernel) * 1e3,
        "us_warm": time_cuda(kernel, cold=False) * 1e3,
        "us_clean_l2": time_cuda(kernel, dirty=False) * 1e3,
        "floor_us": time_cuda(floor) * 1e3,
        "floor_us_warm": time_cuda(floor, cold=False) * 1e3}), flush=True)
    if sass:
        lib = build.build()["dir"] / "libell_onehot.so"
        print(json.dumps({"sass": "ell_onehot", "tree": tree,
                          "functions": sass_schedule(str(lib))}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--diagnose", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--onehot", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_spmv_bench: needs a CUDA device", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.kernels import build
    from repro_torch.spmv.distributed import from_reference
    from repro_torch.spmv.matrix import (band_matrix, partition,
                                         stack_partitions)

    tree = os.path.dirname(os.path.abspath(repro_torch.__file__))
    print(nvidia_smi_line(), flush=True)
    dev = torch.device("cuda")
    if args.onehot:
        return onehot(tree, dev, args.sass)
    A = band_matrix(n=PAPER_N, nnz=PAPER_NNZ, seed=0)
    x_np = np.random.default_rng(1).standard_normal(PAPER_N).astype(
        np.float32)
    spmv = from_reference(stack_partitions(partition(A, RANKS)), x_np, dev)
    spmv.post_send(spmv.pack(spmv.x))
    torch.cuda.synchronize()
    halo = spmv.halo.clone()

    def line(fn, y=None, **fields) -> None:
        if y is not None:
            fields["y_sha256"] = y_sha256(fn, y)
        print(json.dumps({**fields, "tree": tree,
                          "us": time_cuda(fn) * 1e3,
                          "us_warm": time_cuda(fn, cold=False) * 1e3}),
              flush=True)

    line(lambda: spmv.multiply_local(spmv.x), spmv.yL, kernel="ell_spmv",
         op="yL")
    line(lambda: spmv.multiply_remote(halo), spmv.yR, kernel="ell_spmv",
         op="yR")
    line(lambda: spmv.pack(spmv.x), kernel="pack", op="Pack")
    if args.diagnose:
        from repro_torch.kernels._launch import launch_floor
        from repro_torch.kernels.spmv.kernel import spmv_grid
        from repro_torch.kernels.spmv.ops import (BLOCK_N, ell_matvec_t,
                                                  sliced_matvec, unsliced)
        for name, part, xin in (("yL", spmv.local, spmv.x),
                                ("yR", spmv.remote, halo)):
            n = part.perm.numel()
            out = torch.empty(n, dtype=torch.float32, device=dev)
            vt, ct = unsliced(part)
            diagonal = part._replace(cols_t=torch.arange(
                n, dtype=torch.int32, device=dev).expand_as(ct).contiguous())
            line(lambda: ell_matvec_t(vt, ct, xin, out=out, block_n=BLOCK_N),
                 out, kernel="ell_spmv", op=name, layout="padded")
            line(lambda: sliced_matvec(diagonal, xin, out), out,
                 kernel="ell_spmv", op=name, layout="diagonal")
            line(lambda: launch_floor(dev, *spmv_grid(n, BLOCK_N)),
                 kernel="launch_floor", op=name)
    if args.sass:
        lib_dir = build.build()["dir"]
        for lib in ("ell_spmv", "pack"):
            print(json.dumps({"sass": lib, "tree": tree, "functions":
                              sass_schedule(str(lib_dir / f"lib{lib}.so"))}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
