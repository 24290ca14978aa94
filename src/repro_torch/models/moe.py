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
weights, and the Switch load-balancing loss; or (``scoring="sigmoid"``,
DeepSeek-V3's router, a field the JAX package lacks) float32 sigmoid
scores, the top-k chosen by score plus the layer's balancing bias (a
buffer ``router_bias``, state and not a parameter, that the train step
moves after the optimizer, ``LM.update_router_bias``), the weights
renormalised from the scores alone and scaled by ``routed_scale``, and
the sequence-wise balance loss. Among equal probabilities
the lower expert comes first, as ``jax.lax.top_k`` orders them: a
stable descending sort, since ``torch.topk`` promises no order among
ties. The reference's ``constrain`` calls stand where it puts them
(no-ops off a mesh), and three more place what XLA's propagation places
unasked: the router's logits and the expert one-hots on the experts
axis (so the router's weight gradient is each model shard's experts'
alone) and the combine's output in the residual's placement.

With a telemetry registry current (:mod:`repro_torch.obs`) a forward
counts its token choices (``moe.routed``), those past capacity
(``moe.dropped``, added up on the device) and the capacity slots it
offers (``moe.slots``, groups x E x C), and the busiest expert's
token choices before the drops (``moe.load_max``, one a layer a call);
a layer checkpoint's recomputation does not count again. Under a train
step's forward a layer with a balancing bias adds each expert's token
choices, before the drops, to its buffer ``router_load``, once a step
as well.

Slot positions (``_positions``, shared by both dispatches): on a CUDA
device the hand-written kernel of ``kernels/moe_positions`` gives them,
one launch a call, exactly the plain version's; elsewhere the plain
version (``_positions_plain``), an int32 scan of a bool one-hot along
the choices. A DTensor's positions come from its local shard, whose
groups must be whole.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Shard

from repro_torch import obs
from repro_torch.dist.sharding import (constrain, contiguous_grad, current,
                                      run_local_sum, spec_entries, zeros)
from repro_torch.kernels.moe_positions import kernel as positions_k
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


def _sigmoid_routing(router_logits: torch.Tensor, mc: MoeConfig,
                     bias: torch.Tensor | None):
    """Top-k routing per token as :func:`_routing` returns it, by
    DeepSeek-V3's router (``noaux_tc`` with one group): scores s =
    sigmoid(logits) in float32; the top-k by s + bias (the lower expert
    first among equals); weights s[top] / (sum s[top] + 1e-20) x
    ``routed_scale``; the sequence-wise balance loss over the scores
    normalised across all experts."""
    s = torch.sigmoid(router_logits.float())
    _, top_e = top_k(s if bias is None else s + bias, mc.top_k)
    top_s = torch.gather(s, -1, top_e)
    top_w = top_s / (top_s.sum(-1, keepdim=True) + 1e-20) * mc.routed_scale
    probs = s / s.sum(-1, keepdim=True)
    e = s.shape[-1]
    # Sequence-wise (DeepSeek-V3 §2.1.2): per sequence f_i = E / (k S)
    # x the choices of expert i and P_i the mean of its normalised score;
    # alpha sum_i f_i P_i, averaged over the sequences.
    f = F.one_hot(top_e, e).float().sum(dim=(1, 2)) * \
        (e / (top_e.shape[1] * top_e.shape[2]))
    aux = (f * probs.mean(dim=1)).sum(-1).mean() * mc.router_aux_weight
    return top_w, top_e, aux


def _loads(p, top_e: torch.Tensor, e: int) -> None:
    """Each expert's token choices of this call, before the drops: added
    to the layer's ``router_load`` under a train step's forward (gradients
    on; not a checkpoint's recomputation) and, the busiest expert's, to
    ``moe.load_max`` where telemetry is on."""
    train = "router_load" in p and torch.is_grad_enabled()
    if not (train or obs.enabled()) or \
            torch._C._current_graph_task_id() != -1:
        return
    if isinstance(top_e, DTensor):
        top_e = top_e.to_local()
    load = torch.bincount(top_e.reshape(-1), minlength=e)
    if train:
        p["router_load"].add_(load)
    obs.counter("moe.load_max").add(load.max())


def _capacity(s: int, mc: MoeConfig, override: int | None = None) -> int:
    """Per-group expert capacity."""
    if override is not None:
        return min(s, override)
    c = int(s * mc.top_k * mc.capacity_factor / mc.n_experts) + 1
    return max(1, min(s, c))


def _positions_plain(top_e: torch.Tensor, e: int, c: int):
    """Slot positions within each (group, expert) capacity buffer: a
    bool one-hot laid out (B, E, S*k) and scanned in int32 along the
    flattened (S*k) order, each choice's own expert's count read back,
    so among one token's k choices the first takes a slot first.

    top_e: (B, S, k). Returns (pos (B,S,k) int64, keep (B,S,k))."""
    b, s, k = top_e.shape
    flat = top_e.reshape(b, 1, s * k)
    hit = flat == torch.arange(e, device=top_e.device)[:, None]
    upto = torch.cumsum(hit, dim=-1, dtype=torch.int32)     # (B,E,S*k)
    pos = (torch.gather(upto, 1, flat) - 1).reshape(b, s, k).long()
    return pos, pos < c


def _positions_local(top_e: DTensor, e: int, c: int, fn):
    """``fn`` on each device's shard of ``top_e``, whose groups are whole
    on every device (sharded on B or replicated), as DTensors of
    ``top_e``'s placements."""
    places = tuple(top_e.placements)
    if not all(p.is_replicate() or p.is_shard(0) for p in places):
        raise ValueError(f"moe positions: the (S, k) choices of a group "
                         f"must be whole on each device, got {places}")
    # A shard of whole groups has the whole tensor's contiguous strides.
    return tuple(DTensor.from_local(t, top_e.device_mesh, places,
                                    run_check=False, shape=top_e.shape,
                                    stride=t.stride())
                 for t in fn(top_e.to_local().contiguous(), e, c))


def _positions(top_e: torch.Tensor, e: int, c: int):
    """:func:`_positions_plain`'s (pos, keep): on a CUDA device from the
    kernel, elsewhere from the plain version (a DTensor's from its local
    shard)."""
    fn = positions_k.positions if top_e.device.type == "cuda" else \
        _positions_plain
    if isinstance(top_e, DTensor):
        return _positions_local(top_e, e, c, fn)
    return fn(top_e.contiguous(), e, c)


def _counting() -> bool:
    """Telemetry is on and this is not a layer checkpoint's recomputation
    (which runs inside the backward, in an autograd graph task)."""
    return obs.enabled() and torch._C._current_graph_task_id() == -1


def _count(keep: torch.Tensor, e: int, c: int) -> None:
    """The routing's counters, where :func:`_counting`. On a mesh a
    process counts its own shard."""
    if not _counting():
        return
    if isinstance(keep, DTensor):
        keep = keep.to_local()
    obs.counter("moe.routed").add(keep.numel())
    obs.counter("moe.dropped").add((~keep).sum())
    obs.counter("moe.slots").add(keep.shape[0] * e * c)


def _moe_experts(p, xe: torch.Tensor, kind: str) -> torch.Tensor:
    """xe: (B, E, C, d) -> (B, E, C, d) through the per-expert MLPs: one
    batched product per stacked matrix, experts leading."""
    b, e, c, d = xe.shape
    xe_t = xe.transpose(0, 1).reshape(e, b * c, d)          # (E,B*C,d)
    # Each data shard's experts compute on its own tokens, as under the
    # reference's vmap: the merged (B*C) dim is named "batch" when B is
    # sharded (Shard(B*C) is then Shard(B)); else it stays whole, as B.
    bound = current()
    tokens = "batch" if bound is not None and \
        spec_entries((b,), ("batch",), *bound) else None
    ye = mlp(p["experts"], xe_t, kind, lead=("experts", tokens))
    # On a mesh the transpose's gradient reaches the reshape's backward
    # (a view) with a transposed local shard (contiguous_grad says why).
    ye = contiguous_grad(ye.reshape(e, b, c, d)).transpose(0, 1)
    return constrain(ye, ("batch", "experts", None, "d_model"))


def _dispatch_einsum(p, x: torch.Tensor, top_w, top_e, mc: MoeConfig,
                     kind: str, capacity: int | None) -> torch.Tensor:
    b, s, d = x.shape
    e, c = mc.n_experts, _capacity(s, mc, capacity)
    pos, keep = _positions(top_e, e, c)
    _count(keep, e, c)
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
    _count(keep, e, c)
    k = mc.top_k
    # Slot index within the group's (E*C) buffer; drops -> scratch slot
    # e*c, which takes several writes and is cut off.
    slot = torch.where(keep, top_e * c + pos, e * c)        # (B,S,k)
    flat_slot = slot.reshape(b, s * k)
    token_idx = torch.arange(s, device=x.device).repeat_interleave(k)
    token_of_slot = zeros((b, e * c + 1), ("batch", None), dtype=torch.long,
                          device=x.device).scatter_(
        1, flat_slot, token_idx.expand(b, -1))[:, :e * c]
    filled = zeros((b, e * c + 1), ("batch", None), dtype=torch.bool,
                   device=x.device).scatter_(
        1, flat_slot, flat_slot < e * c)[:, :e * c]
    xe = torch.gather(x, 1, token_of_slot[..., None].expand(-1, -1, d))
    xe = torch.where(filled[..., None], xe, 0.0)            # (B,E*C,d)
    xe = constrain(xe.reshape(b, e, c, d),
                   ("batch", "experts", None, "d_model"))
    ye = _moe_experts(p, xe, kind).reshape(b, e * c, d)
    w_of_slot = zeros((b, e * c + 1), ("batch", None), dtype=top_w.dtype,
                      device=x.device).scatter_(
        1, flat_slot, top_w.reshape(b, s * k))[:, :e * c]
    weighted = ye * w_of_slot[..., None].to(ye.dtype)
    weighted = torch.where(filled[..., None], weighted, 0.0)
    return _add_to_tokens(token_of_slot, weighted, s)


def _add_to_tokens(token_of_slot, weighted, s: int):
    """(B, E*C, d) weighted slot outputs added to their tokens, (B, S,
    d). On a mesh each device adds the slots of its own experts (their
    shard of E*C), a partial sum that the constraint reduces over the
    experts axis, as the combine einsum's is (DTensor's own in-place
    scatter-add gives its output placements its shards do not have)."""
    def add(tos, w):
        out = torch.zeros((w.shape[0], s, w.shape[2]), dtype=w.dtype,
                          device=w.device)
        return out.scatter_add_(1, tos[..., None].expand(-1, -1,
                                                        w.shape[2]), w)

    if not isinstance(weighted, DTensor):
        return add(token_of_slot, weighted)
    mesh, places = weighted.device_mesh, tuple(weighted.placements)
    tos = token_of_slot.redistribute(mesh, places)
    out = run_local_sum(add, [tos, weighted],
                        (weighted.shape[0], s, weighted.shape[2]),
                        [Partial() if p == Shard(1) else p for p in places])
    return constrain(out, ("batch", "seq", "d_model"))


def moe_mlp(p, x: torch.Tensor, cfg: ModelConfig,
            capacity: int | None = None):
    """x: (B, S, d) -> (y, aux_loss). Groups = batch dim.

    ``capacity`` overrides the per-group capacity: decode passes the
    batch size, which for its one token a group is dropless.
    """
    mc = cfg.moe
    # XLA drops a recomputed op whose result the backward does not read;
    # the layer checkpoint's recomputation (non-reentrant) stops once the
    # tensors the backward saved are rebuilt, that is before the last op
    # that saves one computes. The shared experts go first, so that the
    # routed experts' combine is that op, and their output projection
    # goes through ``layers.kept`` (the layer's checkpoint keeps its
    # output, ``LM._run_stage``): neither runs in the recomputation.
    shared = mlp(p["shared"], x, cfg.mlp, keep_out=True) \
        if mc.n_shared else None
    logits = constrain(x @ p["router"].to(x.dtype),
                       ("batch", None, "experts"))          # (B,S,E)
    if mc.scoring == "sigmoid":
        top_w, top_e, aux = _sigmoid_routing(
            logits, mc, p["router_bias"] if "router_bias" in p else None)
    else:
        top_w, top_e, aux = _routing(logits, mc)
    _loads(p, top_e, mc.n_experts)
    if mc.dispatch == "einsum":
        y = _dispatch_einsum(p, x, top_w, top_e, mc, cfg.mlp, capacity)
    else:
        y = _dispatch_gather(p, x, top_w, top_e, mc, cfg.mlp, capacity)
    y = y.to(x.dtype)
    if shared is not None:
        y = y + shared
    return y, aux
