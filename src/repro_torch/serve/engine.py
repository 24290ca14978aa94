"""Batched serving: prefill + greedy decode loop with KV caches.

Port of ``repro/serve/engine.py``. ``serve_step`` is one new token for
the whole batch against the caches (keys and values, Mamba and RWKV
states, cross-attention memories); :class:`Engine` drives prefill and
then ``serve_step`` for greedy, position-aligned sequences (continuous
batching is out of scope, as in the reference). Cache and parameter
placements on a mesh (``cache_axes``, ``serve_shardings``) wait for the
distribution layer (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.model import LM


def make_serve_step(model: LM):
    """serve_step(caches, tokens (B, 1), pos) -> (next_tokens (B, 1),
    logits, caches). The model holds the parameters."""

    def serve_step(caches, tokens, pos):
        logits, caches = model.decode_step(tokens, pos, caches)
        return logits[:, -1].argmax(dim=-1)[:, None], logits, caches

    return serve_step


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
