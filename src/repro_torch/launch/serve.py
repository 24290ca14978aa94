"""Serving launcher: batched prefill + greedy decode of a reduced config.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
      --new 12 [--device cpu]

Every architecture of ``repro_torch.configs``; the decode-cell dry-run
on a production mesh (``--dry-run``) waits for the distribution layer
(ROADMAP Queue 1 item 9). Weights come from ``--seed``, prompts from
``--seed + 1`` (numpy) and, for the enc-dec and VLM families, frame or
patch embeddings from a standard normal on the model's device seeded
with ``--seed + 2``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    if args.dry_run:
        raise NotImplementedError(
            "--dry-run waits for the distribution layer (ROADMAP Queue 1 "
            "item 9)")

    from repro_torch.configs import get_reduced
    from repro_torch.models.model import LM
    from repro_torch.serve.engine import Engine

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
    out = engine.generate(prompts, args.new, frontend=frontend)
    for b in range(args.batch):
        print(f"seq{b}: {out[b].tolist()}")


if __name__ == "__main__":
    main()
