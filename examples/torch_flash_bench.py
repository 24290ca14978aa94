"""Time the hand-written flash-attention kernel on the card.

Usage (from the repository root, one CUDA card):

    PYTHONPATH=src python examples/torch_flash_bench.py \
        [--served] [--blocks 128x128 64x64 | --blocks all] [--sdpa] \
        [--profile]

At one attention layer of qwen2.5-32b (1 x 40 x 4096 x 128, float32,
causal; ``chip_smoke.py``'s ``ATTN``) it prints one JSON line per
(block_q, block_k): CUDA-event median ms (``chip_smoke.time_cuda``: L2
flushed before each call) and max abs error against the plain version.
``--served`` takes the serve path's prefill instead (``SERVE``): bfloat16, 4 x
1,024 tokens, 40 q heads on qwen2.5-32b's 8 kv heads in the (B, S, H,
D) layout the projections leave (the bf16 kernel; ``--blocks all`` is
its four pairs). ``--sdpa`` adds ``scaled_dot_product_attention`` on
the same inputs (with ``enable_gqa`` when served; its time and its max
abs error against the plain version).
``--profile`` runs one kernel call and one SDPA call under
``torch.profiler`` and prints each device kernel's name, µs, registers,
blocks and warps per SM and estimated occupancy (traces in
``chiprun_out/``), then asks the profiler's CUPTI metrics for the
kernel's shared-memory bank conflicts (and says so where the trace
holds none). The card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (ATTN, SERVE, attention_inputs,  # noqa: E402
                        nvidia_smi_line, time_cuda)

BANK_CONFLICT_METRICS = [
    "smsp__sass_l1tex_data_bank_conflicts_pipe_lsu_mem_shared_op_ld.sum",
    "smsp__sass_l1tex_data_bank_conflicts_pipe_lsu_mem_shared_op_st.sum",
    "smsp__sass_inst_executed_op_shared_ld.sum",
]


KERNEL_ARGS = ("registers per thread", "shared memory", "blocks per SM",
               "warps per SM", "est. achieved occupancy %", "grid", "block")


def traced_kernels(fn, path: str, config=None) -> list[dict]:
    """Device kernels of one call of ``fn`` from a ``torch.profiler``
    trace (exported to ``path``): name, µs, and the launch's args."""
    from torch.profiler import ProfilerActivity, profile

    kw = {} if config is None else {"experimental_config": config}
    with profile(activities=[ProfilerActivity.CUDA], **kw) as p:
        fn()
        torch.cuda.synchronize()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    p.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    return [{"name": e["name"], "us": e.get("dur"),
             **{k: v for k, v in e.get("args", {}).items()
                if k in KERNEL_ARGS or k in BANK_CONFLICT_METRICS}}
            for e in events if e.get("cat") == "kernel"]


def profile(fn_kernel, fn_sdpa) -> dict:
    out_dir = os.path.join(ROOT, "chiprun_out")
    out = {"kernel": traced_kernels(
               fn_kernel, os.path.join(out_dir, "flash_kernel_trace.json")),
           "sdpa": traced_kernels(
               fn_sdpa, os.path.join(out_dir, "flash_sdpa_trace.json"))}
    from torch._C._profiler import _ExperimentalConfig
    cfg = _ExperimentalConfig(profiler_metrics=BANK_CONFLICT_METRICS,
                              profiler_measure_per_kernel=True)
    counted = [k for k in traced_kernels(
        fn_kernel, os.path.join(out_dir, "flash_metrics_trace.json"), cfg)
        if any(m in k for m in BANK_CONFLICT_METRICS)]
    out["bank_conflicts"] = counted or (
        "not measured: the trace holds no CUPTI counters")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--blocks", nargs="+", default=["128x128"],
                    help="block_qxblock_k pairs, or 'all' for the grid")
    ap.add_argument("--sdpa", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--served", action="store_true",
                    help="bf16 at the serve phase's prefill, 40 q heads "
                         "on 8 kv heads")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_flash_bench: needs a CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention.ops import attention_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    print(nvidia_smi_line(), flush=True)
    dev = torch.device("cuda")
    if args.served:
        from repro_torch.configs import get_config
        cfg = get_config(SERVE["arch"])
        b, s, h, d = SERVE["batch"], SERVE["prompt"], cfg.n_heads, \
            cfg.head_dim
        hkv = cfg.n_kv_heads
        q, k, v = (t.to(torch.bfloat16) for t in attention_inputs(
            dev, b, h, s, d, seed=3))
        qf = q.transpose(1, 2).contiguous()              # (B, S, H, D)
        kf, vf = (t[:, :hkv].transpose(1, 2).contiguous() for t in (k, v))
        q, k, v = (t.transpose(1, 2) for t in (qf, kf, vf))
        sdpa_kw = {"enable_gqa": True}
        grid_pairs = list(fa_k.BF16_BLOCKS)
    else:
        b, h, s, d = (ATTN[k] for k in ("batch", "heads", "seq",
                                        "head_dim"))
        q, k, v = attention_inputs(dev, b, h, s, d)
        qf, kf, vf = (t.reshape(b * h, s, d) for t in (q, k, v))
        sdpa_kw = {}
        grid = (16, 32, 64, 128)
        grid_pairs = [(bq, bk) for bq in grid for bk in grid]
    out = torch.empty_like(qf)
    scale = d ** -0.5
    plain = attention_plain(qf, kf, vf, causal=True, scale=scale)
    pairs = (grid_pairs if args.blocks == ["all"] else
             [tuple(int(x) for x in p.split("x")) for p in args.blocks])

    def kernel(bq, bk):
        return lambda: fa_k.flash_attention(qf, kf, vf, out, causal=True,
                                            block_q=bq, block_k=bk,
                                            scale=scale)

    for bq, bk in pairs:
        fn = kernel(bq, bk)
        err = float((fn().float() - plain.float()).abs().max())
        print(json.dumps({"block_q": bq, "block_k": bk,
                          "dtype": str(qf.dtype).split(".")[-1],
                          "ms": time_cuda(fn, iters=args.iters),
                          "max_abs_err": err}), flush=True)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              **sdpa_kw)

    if args.sdpa:
        lib = sdpa().transpose(1, 2) if args.served else sdpa()
        err = float((lib.reshape(plain.shape).float() - plain.float())
                    .abs().max())
        print(json.dumps({"sdpa_ms": time_cuda(sdpa, iters=args.iters),
                          "sdpa_max_abs_err": err}), flush=True)
    if args.profile:
        print(json.dumps(profile(kernel(*pairs[0]), sdpa)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
