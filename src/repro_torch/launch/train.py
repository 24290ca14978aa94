"""Training launcher: a reduced config trained on packed synthetic data.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --steps 100 [--device cpu] [--ckpt-dir DIR]
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-32b \\
      --dry-run [--shape train_4k] [--multi-pod] [--reduced --mesh 2x4]

Port of the reference's real-run mode (``repro/launch/train.py``):
reduced config, packed synthetic data, AdamW under warmup_cosine(3e-3,
20, steps), checkpoints every 50 steps and at the end, straggler
accounting. It prints every step's loss (the reference prints every
tenth). Parameters are drawn from seed 0 on ``--device``, the card
unless ``cpu`` is given. Without ``--ckpt-dir`` the checkpoints go to a
temporary directory, removed at exit. Any ``--arch`` of the configs
trains: its batches come from ``batch_for`` (whisper's frames and
internvl2's patches with them), RWKV in its sequential form, as the
reference's launcher runs it. ``--dry-run`` runs the
train cell of the full config on a production mesh instead
(``launch/dryrun.py``: one step over a fake process group, counted,
nothing allocated); ``--reduced`` and ``--mesh`` shrink it.
"""
from __future__ import annotations

import argparse
import tempfile


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--shape", default="train_4k",
                    help="the dry run's cell")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="the dry run at the arch's reduced config")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="the dry run on a (data, model) mesh")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    if args.dry_run:
        from repro_torch.launch import dryrun

        cmd = ["--arch", args.arch, "--shape", args.shape, "--force"]
        cmd += ["--multi-pod"] * args.multi_pod + ["--reduced"] * \
            args.reduced + (["--mesh", args.mesh] if args.mesh else [])
        return dryrun.main(cmd)

    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import DataConfig, batch_for
    from repro_torch.ft.restart import LoopConfig, TrainLoop
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    from repro_torch.train.step import make_train_step

    cfg = get_reduced(args.arch)
    model = LM(cfg, device=args.device, seed=0)
    print(f"{cfg.name}: {model.n_params():,} params on {model.device}")
    params = dict(model.named_parameters())
    opt = AdamW(learning_rate=warmup_cosine(3e-3, 20, args.steps))
    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch,
                      vocab=cfg.vocab, packed=True)
    with tempfile.TemporaryDirectory() as tmp:
        loop = TrainLoop(make_train_step(model, opt),
                         lambda s: batch_for(dcfg, s, cfg),
                         CheckpointStore(args.ckpt_dir or tmp),
                         LoopConfig(total_steps=args.steps, ckpt_every=50,
                                    log_every=1))
        loop.run(params, opt.init(params))
    for h in loop.history:
        print(f"step {int(h['step']):5d}  loss {h['loss']:.4f}")
    return loop.history


if __name__ == "__main__":
    main()
