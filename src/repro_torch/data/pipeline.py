"""Synthetic token data pipeline: deterministic and stateless.

Port of ``repro/data/pipeline.py``. The batch for step ``s`` is a pure
function of ``(seed, s)``, so a restart needs only the step counter.
The draws are the reference's ``jax.random`` draws, bit for bit, made
in numpy by :mod:`.prng`; batches are CPU tensors (ids int32, frontends
float32), which the train step moves to the model's device.

  * ``lm_batch``     iid tokens with a learnable rule mixed in.
  * ``packed_batch`` documents packed to seq_len with EOS separators and
    -1 labels on the targets that cross a boundary.
  * ``frontend_batch`` the audio/VLM frontends' pseudo-embeddings:
    standard normal float32 (B, n_positions, d_frontend), which
    ``batch_for`` adds for whisper and internvl2.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.data import prng
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    seq_len: int = 512
    global_batch: int = 8
    vocab: int = 32_000
    eos: int = 0
    packed: bool = False
    mean_doc_len: int = 192


def _key(cfg: DataConfig, step: int, salt: int) -> np.ndarray:
    return prng.fold_in(prng.fold_in(prng.key(cfg.seed), salt), int(step))


def _tensors(**arrays) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.int32))
            for k, v in arrays.items()}


def lm_batch(cfg: DataConfig, step: int) -> dict:
    """Tokens with a repetition structure a model can learn."""
    k1, k2, k3 = prng.split(_key(cfg, step, 1), 3)
    b, s = cfg.global_batch, cfg.seq_len
    base = prng.randint(k1, (b, s), 0, cfg.vocab)
    # Mixture: with p=0.5 copy the previous token + 1 (learnable rule).
    copy = np.concatenate([base[:, :1], (base[:, :-1] + 1) % cfg.vocab],
                          axis=1)
    tokens = np.where(prng.bernoulli(k2, 0.5, (b, s)), copy, base)
    labels = np.concatenate(
        [tokens[:, 1:], prng.randint(k3, (b, 1), 0, cfg.vocab)], axis=1)
    return _tensors(tokens=tokens, labels=labels)


def packed_batch(cfg: DataConfig, step: int) -> dict:
    """Documents packed to seq_len; EOS-separated; pad labels = -1."""
    k1, k2 = prng.split(_key(cfg, step, 2), 2)
    b, s = cfg.global_batch, cfg.seq_len
    tokens = prng.randint(k1, (b, s), 1, cfg.vocab)
    # Deterministic doc boundaries: geometric-ish via uniform threshold.
    boundary = prng.uniform(k2, (b, s)) < np.float32(1.0 / cfg.mean_doc_len)
    tokens = np.where(boundary, cfg.eos, tokens)
    labels = np.concatenate(
        [tokens[:, 1:], np.full((b, 1), cfg.eos, np.int32)], axis=1)
    # No loss on predicting across a document boundary target pad.
    labels = np.where(labels == cfg.eos, -1, labels)
    return _tensors(tokens=tokens, labels=labels)


def frontend_batch(cfg: DataConfig, step: int,
                   model_cfg: ModelConfig) -> dict:
    fe = model_cfg.frontend
    emb = prng.normal(_key(cfg, step, 3),
                      (cfg.global_batch, fe.n_positions, fe.d_frontend))
    return {"frontend": torch.from_numpy(emb)}


def batch_for(cfg: DataConfig, step: int, model_cfg: ModelConfig) -> dict:
    out = packed_batch(cfg, step) if cfg.packed else lm_batch(cfg, step)
    if model_cfg.frontend is not None:
        out.update(frontend_batch(cfg, step, model_cfg))
    return out
