"""End-to-end training with the PyTorch port: data -> train step ->
checkpoints, on the card unless ``--device cpu``.

The default is a small smollm-family model (~10M parameters) for a few
hundred steps; ``--preset 100m`` selects a ~100M-parameter config;
``--arch`` trains any config's reduced version, the MoE, Mamba, RWKV,
enc-dec and VLM families included (whisper's frames and internvl2's
patches come with the batches). Weights are drawn from seed 0, the
data from ``DataConfig``'s seed; without ``--ckpt-dir`` the checkpoints
go to a temporary directory, removed at exit.

Usage:
  PYTHONPATH=src python examples/torch_train_lm.py --steps 200
  PYTHONPATH=src python examples/torch_train_lm.py --preset 100m --steps 300
  PYTHONPATH=src python examples/torch_train_lm.py --arch jamba-v0.1-52b \\
      --steps 20 --device cpu
"""
import argparse
import tempfile
import time

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import ARCHS, get_reduced
from repro_torch.data.pipeline import DataConfig, batch_for
from repro_torch.ft.restart import LoopConfig, TrainLoop
from repro_torch.ft.straggler import StragglerMonitor
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM
from repro_torch.optim.adamw import AdamW, warmup_cosine
from repro_torch.train.step import make_train_step

PRESETS = {
    "cpu": ModelConfig(
        name="smol-cpu", family="dense", n_layers=4, d_model=256,
        n_heads=4, n_kv_heads=2, d_ff=1024, vocab=8192, mlp="swiglu"),
    "100m": ModelConfig(
        name="smol-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=2048, vocab=32768, mlp="swiglu"),
}


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=list(PRESETS), default="cpu")
    ap.add_argument("--arch", choices=ARCHS, default=None,
                    help="train an arch's reduced config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.arch else PRESETS[args.preset]
    model = LM(cfg, device=args.device, seed=0)
    print(f"model {cfg.name}: {model.n_params():,} params on "
          f"{model.device}")
    params = dict(model.named_parameters())
    opt = AdamW(learning_rate=warmup_cosine(args.lr, 20, args.steps))
    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch,
                      vocab=cfg.vocab, packed=True)
    step = make_train_step(model, opt, microbatches=args.microbatches)

    monitor = StragglerMonitor()
    with tempfile.TemporaryDirectory() as tmp:
        loop = TrainLoop(
            step, lambda s: batch_for(dcfg, s, cfg),
            CheckpointStore(args.ckpt_dir or tmp),
            LoopConfig(total_steps=args.steps, ckpt_every=50,
                       log_every=10),
            monitor=monitor)
        t0 = time.perf_counter()
        loop.run(params, opt.init(params))
        wall = time.perf_counter() - t0
    for h in loop.history:
        print(f"step {int(h['step']):5d}  loss {h['loss']:.4f}  "
              f"ce {h['ce']:.4f}")
    tok = args.steps * args.batch * args.seq
    print(f"{args.steps} steps, {tok:,} tokens in {wall:.1f}s "
          f"({tok / wall:,.0f} tok/s)")
    rep = monitor.report()
    print("stragglers:", rep.slow_ranks if rep else "none")
    return loop.history


if __name__ == "__main__":
    main()
