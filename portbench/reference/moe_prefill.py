"""The plain reference of a DeepSeekMoE decoder's serving forward: the
logits at every position of one sequence, composed from
``reference/moe_lm.py``'s functions (its attention, norms, SwiGLU and
products, and its routing with the capacity set as below), in float32
with TF32 off, in plain PyTorch. Imports nothing of the program.

The capacity: the program's prefill routes a prompt of S tokens with
the capacity of S tokens, C = int(S k cf / E) + 1 an expert, and drops
in the order (token, choice); its decode takes one token a sequence and
drops none. So this forward over a prompt and the tokens decoded after
it routes every position with the capacity of ``prompt_len`` tokens,
counts the prompt's choices alone against it, and never drops a
position from ``prompt_len`` on.
"""
from __future__ import annotations

import torch

from portbench.reference.moe_lm import (attention, matmul, rmsnorm,
                                        routing, swiglu)


def moe(p: dict, h: torch.Tensor, s: dict, prompt_len: int,
        precision: str) -> torch.Tensor:
    """``moe_lm.moe`` of one sequence (1, T, D): the prompt's first
    ``prompt_len`` positions routed by ``moe_lm.routing`` with their
    capacity, later positions dropless."""
    t, d = h.shape[1], h.shape[2]
    out = swiglu(h, p["mlp.shared.wi"], p["mlp.shared.wg"],
                 p["mlp.shared.wo"], precision)
    logits = matmul(h, p["mlp.router"], precision)
    top_w, top_e, kept, _ = routing(logits[:, :prompt_len], s)
    if t > prompt_len:
        probs = torch.softmax(logits[:, prompt_len:], dim=-1)
        w, e = torch.sort(probs, dim=-1, descending=True, stable=True)
        w, e = w[..., :s["top_k"]], e[..., :s["top_k"]]
        top_w = torch.cat([top_w, w / w.sum(-1, keepdim=True)], dim=1)
        top_e = torch.cat([top_e, e], dim=1)
        kept = torch.cat([kept, torch.ones_like(e, dtype=torch.bool)], dim=1)
    flat = h.reshape(t, d)
    routed = torch.zeros_like(flat)
    tok = torch.arange(t, device=h.device)[:, None].expand(-1, s["top_k"])
    e_all, w_all, keep = top_e[0], top_w[0], kept[0]
    for e in range(s["experts"]):
        sel = (e_all == e) & keep
        rows = tok[sel]
        if rows.numel() == 0:
            continue
        y = swiglu(flat[rows], p["mlp.experts.wi"][e], p["mlp.experts.wg"][e],
                   p["mlp.experts.wo"][e], precision)
        routed = routed.index_add(0, rows, y * w_all[sel][:, None])
    return out + routed.reshape(1, t, d)


@torch.no_grad()
def logits(params: dict, tokens: torch.Tensor, s: dict, prompt_len: int,
           precision: str = "float32") -> torch.Tensor:
    """The logits (T, vocab) at every position of ``tokens`` (T,), the
    first ``prompt_len`` of them the prompt."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        x = params["embed.tokens"][tokens[None]]
        for i in range(s["layers"]):
            pre = f"decoder.{i}."
            p = {k[len(pre):]: v for k, v in params.items()
                 if k.startswith(pre)}
            x = x + attention(p, rmsnorm(x, p["norm_mix"], s["eps"]), s,
                              precision)
            x = x + moe(p, rmsnorm(x, p["norm_mlp"], s["eps"]), s,
                        prompt_len, precision)
        x = rmsnorm(x, params["final_norm"], s["eps"])
        return matmul(x, params["embed.lm_head"], precision)[0]
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev
