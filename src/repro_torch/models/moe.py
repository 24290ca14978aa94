"""Mixture-of-experts MLP (DeepSeekMoE-style: shared + routed top-k).

Port of ``repro/models/moe.py``. Tokens are grouped by the batch dim
(one group per sequence) and the capacity C is per group: C = int(S *
top_k * cf / E) + 1, at most S. The experts of a layer are stacked
``(E, ...)`` in one parameter per matrix. Two dispatches, selected by
``MoeConfig.dispatch``, with the same routing and drops:

  * ``einsum`` (the configs' default): one-hot dispatch and combine
    tensors (B, S, E, C) contracted with the tokens;
  * ``gather``: each (expert, slot) takes its token by index, and the
    weighted outputs are added back to their tokens (``scatter_add_``:
    on a CUDA tensor the adds are atomic, so their order, and the last
    bits of a sum, vary from run to run).

Routing: float32 softmax over the expert logits, top-k, renormalised
weights, and the Switch load-balancing loss. Among equal probabilities
the lower expert comes first, as ``jax.lax.top_k`` orders them: a
stable descending sort, since ``torch.topk`` promises no order among
ties. The reference's ``constrain`` calls stand where it puts them
(no-ops off a mesh), and two more place what XLA's propagation places
unasked: the expert one-hots on the experts axis and the combine's
output in the residual's placement.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import constrain, contiguous_grad
from repro_torch.models.config import ModelConfig, MoeConfig
from repro_torch.models.layers import mlp, mlp_specs
from repro_torch.models.params import Spec, stack_specs


def moe_specs(cfg: ModelConfig) -> dict:
    assert cfg.moe is not None
    mc = cfg.moe
    de = mc.d_expert or cfg.d_ff
    out = {
        "router": Spec((cfg.d_model, mc.n_experts),
                       ("d_model", "experts")),
        "experts": stack_specs(mlp_specs(cfg, de), mc.n_experts,
                               "experts"),
    }
    if mc.n_shared:
        out["shared"] = mlp_specs(cfg, de * mc.n_shared)
    return out


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, largest
    first and, among equals, the lower index first."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _routing(router_logits: torch.Tensor, mc: MoeConfig):
    """Top-k routing per token. logits: (B, S, E).

    Returns (weights (B,S,k) float32, experts (B,S,k), aux_loss)."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    top_w, top_e = top_k(probs, mc.top_k)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * p_e.
    e = probs.shape[-1]
    f = F.one_hot(top_e, e).float().mean(dim=(0, 1, 2))
    p = probs.mean(dim=(0, 1))
    aux = e * torch.sum(f * p) * mc.router_aux_weight
    return top_w, top_e, aux


def _capacity(s: int, mc: MoeConfig, override: int | None = None) -> int:
    """Per-group expert capacity."""
    if override is not None:
        return min(s, override)
    c = int(s * mc.top_k * mc.capacity_factor / mc.n_experts) + 1
    return max(1, min(s, c))


def _positions(top_e: torch.Tensor, e: int, c: int):
    """Slot positions within each (group, expert) capacity buffer: a
    cumsum over the flattened (S*k) order, so among one token's k
    choices the first takes a slot first.

    top_e: (B, S, k). Returns (pos (B,S,k), keep (B,S,k))."""
    b, s, k = top_e.shape
    flat = top_e.reshape(b, s * k)
    onehot = F.one_hot(flat, e)                             # (B,S*k,E)
    pos_all = torch.cumsum(onehot, dim=1) - onehot
    pos = torch.gather(pos_all, -1, flat[..., None])[..., 0]
    pos = pos.reshape(b, s, k)
    return pos, pos < c


def _moe_experts(p, xe: torch.Tensor, kind: str) -> torch.Tensor:
    """xe: (B, E, C, d) -> (B, E, C, d) through the per-expert MLPs: one
    batched product per stacked matrix, experts leading."""
    b, e, c, d = xe.shape
    xe_t = xe.transpose(0, 1).reshape(e, b * c, d)          # (E,B*C,d)
    ye = mlp(p["experts"], xe_t, kind, lead=("experts", None))
    # On a mesh the transpose's gradient reaches the reshape's backward
    # (a view) with a transposed local shard (contiguous_grad says why).
    ye = contiguous_grad(ye.reshape(e, b, c, d)).transpose(0, 1)
    return constrain(ye, ("batch", "experts", None, "d_model"))


def _dispatch_einsum(p, x: torch.Tensor, top_w, top_e, mc: MoeConfig,
                     kind: str, capacity: int | None) -> torch.Tensor:
    b, s, d = x.shape
    e, c = mc.n_experts, _capacity(s, mc, capacity)
    pos, keep = _positions(top_e, e, c)
    # Sharded on the experts from the start, so that the dispatch and
    # combine tensors and their products are computed for the local
    # experts only (what XLA's propagation back from xe's constraint
    # gives; DTensor propagates forward only).
    oh_e = constrain(F.one_hot(top_e, e).to(x.dtype),
                     ("batch", None, None, "experts"))      # (B,S,k,E)
    oh_c = F.one_hot(torch.where(keep, pos, c), c + 1).to(
        x.dtype)[..., :c]                                   # (B,S,k,C)
    disp = torch.einsum("bske,bskc->bsec", oh_e, oh_c)      # (B,S,E,C)
    comb = torch.einsum("bske,bskc,bsk->bsec", oh_e, oh_c,
                        top_w.to(x.dtype))
    xe = torch.einsum("bsec,bsd->becd", disp, x)
    xe = constrain(xe, ("batch", "experts", None, "d_model"))
    ye = _moe_experts(p, xe, kind)
    return constrain(torch.einsum("bsec,becd->bsd", comb, ye),
                     ("batch", "seq", "d_model"))


def _dispatch_gather(p, x: torch.Tensor, top_w, top_e, mc: MoeConfig,
                     kind: str, capacity: int | None) -> torch.Tensor:
    b, s, d = x.shape
    e, c = mc.n_experts, _capacity(s, mc, capacity)
    pos, keep = _positions(top_e, e, c)
    k = mc.top_k
    # Slot index within the group's (E*C) buffer; drops -> scratch slot
    # e*c, which takes several writes and is cut off.
    slot = torch.where(keep, top_e * c + pos, e * c)        # (B,S,k)
    flat_slot = slot.reshape(b, s * k)
    token_idx = torch.arange(s, device=x.device).repeat_interleave(k)
    token_of_slot = torch.zeros((b, e * c + 1), dtype=torch.long,
                                device=x.device).scatter_(
        1, flat_slot, token_idx.expand(b, -1))[:, :e * c]
    filled = torch.zeros((b, e * c + 1), dtype=torch.bool,
                         device=x.device).scatter_(
        1, flat_slot, flat_slot < e * c)[:, :e * c]
    xe = torch.gather(x, 1, token_of_slot[..., None].expand(-1, -1, d))
    xe = torch.where(filled[..., None], xe, 0.0)            # (B,E*C,d)
    xe = constrain(xe.reshape(b, e, c, d),
                   ("batch", "experts", None, "d_model"))
    ye = _moe_experts(p, xe, kind).reshape(b, e * c, d)
    w_of_slot = torch.zeros((b, e * c + 1), dtype=top_w.dtype,
                            device=x.device).scatter_(
        1, flat_slot, top_w.reshape(b, s * k))[:, :e * c]
    weighted = ye * w_of_slot[..., None].to(ye.dtype)
    weighted = torch.where(filled[..., None], weighted, 0.0)
    return torch.zeros((b, s, d), dtype=weighted.dtype,
                       device=x.device).scatter_add_(
        1, token_of_slot[..., None].expand(-1, -1, d), weighted)


def moe_mlp(p, x: torch.Tensor, cfg: ModelConfig,
            capacity: int | None = None):
    """x: (B, S, d) -> (y, aux_loss). Groups = batch dim.

    ``capacity`` overrides the per-group capacity: decode passes the
    batch size, which for its one token a group is dropless.
    """
    mc = cfg.moe
    logits = x @ p["router"].to(x.dtype)                    # (B,S,E)
    top_w, top_e, aux = _routing(logits, mc)
    if mc.dispatch == "einsum":
        y = _dispatch_einsum(p, x, top_w, top_e, mc, cfg.mlp, capacity)
    else:
        y = _dispatch_gather(p, x, top_w, top_e, mc, cfg.mlp, capacity)
    y = y.to(x.dtype)
    if mc.n_shared:
        y = y + mlp(p["shared"], x, cfg.mlp)
    return y, aux
