"""Batched serving with the PyTorch port: prefill a batch of prompts,
decode greedily.

The KV/state-cache serving path for any architecture family (attention,
SSM, hybrid, enc-dec and VLM caches), on the card unless ``--device
cpu``. Weights come from ``--seed``, prompts from ``--seed + 1`` and the
enc-dec and VLM families' frame or patch embeddings from ``--seed + 2``.

Usage: PYTHONPATH=src python examples/torch_serve_lm.py
           [--arch rwkv6-3b] [--batch 4] [--prompt-len 24] [--new 16]
           [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_reduced
from repro_torch.models.model import LM
from repro_torch.serve.engine import Engine


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="smollm-360m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch)
    model = LM(cfg, device=args.device, seed=args.seed)
    prompts = torch.from_numpy(np.random.default_rng(args.seed + 1).integers(
        0, cfg.vocab, (args.batch, args.prompt_len))).to(model.device)
    frontend = None
    if cfg.frontend is not None:
        gen = torch.Generator(device=model.device).manual_seed(args.seed + 2)
        frontend = torch.randn(
            (args.batch, cfg.frontend.n_positions, cfg.frontend.d_frontend),
            generator=gen, device=model.device)

    engine = Engine(model, t_max=model.n_front + args.prompt_len +
                    args.new + 1)
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.new, frontend=frontend)
    if out.is_cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"arch={args.arch} family={cfg.family} batch={args.batch} "
          f"new={args.new} device={model.device}")
    for b in range(args.batch):
        print(f"  seq{b}: prompt..{prompts[b, -4:].tolist()} -> "
              f"{out[b].tolist()}")
    total = args.batch * args.new
    print(f"{total} tokens in {wall:.2f}s ({total / wall:.1f} tok/s)")

    # Consistency check: generated tokens equal the argmax continuation
    # of a full forward pass over (prompt + generated).
    full = torch.cat([prompts, out[:, :-1]], dim=1)
    with torch.inference_mode():
        logits = model(full, frontend=frontend)
    ref = logits[:, args.prompt_len - 1:].argmax(dim=-1)
    ok = bool(torch.equal(ref, out))
    print("decode == forward argmax:", ok)
    if not ok:
        raise SystemExit("decode and the full forward disagree")


if __name__ == "__main__":
    main()
