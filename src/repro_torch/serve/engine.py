"""Batched serving: prefill + greedy decode loop with KV caches.

Port of ``repro/serve/engine.py``. ``serve_step`` is one new token for
the whole batch against the caches (keys and values, Mamba and RWKV
states, cross-attention memories); :class:`Engine` drives prefill and
then ``serve_step`` for greedy, position-aligned sequences (continuous
batching is out of scope, as in the reference). :func:`cache_axes` and
:func:`serve_shardings` give the placements of the caches, parameters
and tokens on a mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

from repro_torch.dist import sharding as shd
from repro_torch.models.blocks import CACHE_AXES, init_cache
from repro_torch.models.model import LM


def make_serve_step(model: LM):
    """serve_step(caches, tokens (B, 1), pos) -> (next_tokens (B, 1),
    logits, caches). The model holds the parameters."""

    def serve_step(caches, tokens, pos):
        logits, caches = model.decode_step(tokens, pos, caches)
        # On a mesh each vocab shard's (max, index) pair is gathered,
        # not the logit rows.
        return shd.argmax(logits[:, -1], -1)[:, None], logits, caches

    return serve_step


def abstract_caches(model: LM, batch: int, t_max: int,
                    n_memory: int = 0) -> list[dict]:
    """The decode caches as meta tensors (shapes and dtypes only)."""
    return [init_cache(model.cfg, d, batch, t_max, n_memory, model.dtype,
                       torch.device("meta")) for d in model.descs]


def cache_axes(model: LM) -> list[dict]:
    """Logical axes for the decode caches (mirrors ``init_caches``: one
    dict per decoder layer, keyed as its cache entry)."""
    return [{k: CACHE_AXES[k] for k in c}
            for c in abstract_caches(model, 1, 8, n_memory=8)]


def serve_shardings(model: LM, mesh, batch: int, t_max: int,
                    n_memory: int = 0,
                    rules: Mapping[str, Any] | None = None):
    """(params, caches, tokens) placements on ``mesh``."""
    p_sh = shd.tree_shardings(model.param_axes(), mesh, rules,
                              model.abstract_params())
    c_sh = shd.tree_shardings(cache_axes(model), mesh, rules,
                              abstract_caches(model, batch, t_max,
                                              n_memory))
    tok_sh = shd.batch_spec(mesh, 1, rules, batch_size=batch)
    return p_sh, c_sh, tok_sh


@dataclasses.dataclass
class Engine:
    model: LM
    t_max: int

    @torch.inference_mode()
    def generate(self, prompts: torch.Tensor, n_new: int,
                 frontend: torch.Tensor | None = None) -> torch.Tensor:
        """prompts: (B, S) token ids on the model's device -> (B, n_new)
        greedy continuation. ``frontend``: the frame or patch embeddings
        of the enc-dec and VLM families; a VLM's prefix takes the first
        positions, so the text's positions start behind it."""
        n_front = self.model.n_front
        if n_front + prompts.shape[1] + n_new > self.t_max:
            raise ValueError(f"generate: {n_front} prefix + "
                             f"{prompts.shape[1]} prompt + {n_new} new "
                             f"tokens exceed t_max={self.t_max}")
        logits, caches = self.model.prefill(prompts, self.t_max,
                                            frontend=frontend)
        step = make_serve_step(self.model)
        tok = logits[:, -1].argmax(dim=-1)[:, None]
        out = [tok]
        pos = prompts.shape[1] + n_front
        for i in range(n_new - 1):
            tok, _, caches = step(caches, tok, pos + i)
            out.append(tok)
        return torch.cat(out, dim=1)
