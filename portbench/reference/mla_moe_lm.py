"""The plain reference of a DeepSeek-V3-style decoder's train step
(Moonlight-16B-A3B: multi-head latent attention, a sigmoid router with a
balancing bias, leading dense layers), as the configuration file states
it: the forward, the loss, its gradients, AdamW and the bias update, in
float32 with TF32 off, in plain PyTorch. Imports nothing of the program;
the products, norms, rotary embedding, SwiGLU and AdamW are
``reference/moe_lm.py``'s.

The model (configuration keys as in the published ``config.json``):
token embedding; per layer a pre-norm RMSNorm, latent attention, a
residual; a pre-norm RMSNorm, an MLP, a residual; a final RMSNorm,
untied output head. Latent attention with no query latent
(``q_lora_rank`` null): q = x wq, (S, H, qk_nope + qk_rope); [c | k_pe]
= x wkva, c of ``kv_lora_rank`` normed by its own RMSNorm; [k_nope | v]
= c wkvb; rotary embeddings on q's rotary part and on k_pe, which is one
a token for every head; scores (q_nope . k_nope + q_pe . k_pe) x
(qk_nope + qk_rope) ** -0.5, causal softmax, o = P v, then wo. The
first ``first_k_dense_replace`` layers' MLP is a SwiGLU of
``intermediate_size``; the others hold ``n_shared_experts`` SwiGLU
experts merged into one of that many times the width, unweighted, and
``n_routed_experts`` routed ones: scores s = sigmoid(x w_router), the
``num_experts_per_tok`` largest of s + b (b the layer's balancing bias;
the lower expert first among equals), weights s[top] / (sum s[top] +
1e-20) x ``routed_scaling_factor``, each expert taking at most C =
int(S k cf / E) + 1 of a sequence's tokens in the order (token, choice)
and dropping the rest. Loss = mean cross-entropy + z_loss mean
logsumexp^2 + the sequence-wise balance loss alpha sum_i f_i P_i of
every MoE layer (DeepSeek-V3 §2.1.2: f_i = E / (k S) x the choices of
expert i, P_i the mean over the sequence of s_i / sum_j s_j; averaged
over the sequences). Each layer is checkpointed. After AdamW, each
layer's b_i += gamma x sign(mean load - load_i), the loads the step's
choices made before the drops (DeepSeek-V3 §2.1.2).

Departures from the published description, each a size the
configuration file lists under ``assumed``: rotary embeddings rotate
halves, where the published modeling code first de-interleaves each
pair (on random weights a fixed permutation of wq's and wkva's rotary
columns); experts have a capacity and drop tokens past it (the
published model is dropless); alpha and gamma are assumed (the
published file gives neither); the z-loss is added.

``precision="fp8"`` is ``moe_lm``'s control: every product with a
weight in float8.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.moe_lm import (adamw, matmul, rmsnorm, rotary,
                                        swiglu)

# Heads attended at a time: the (heads, S, S) float32 scores of a whole
# 8,192-token sequence would take 4.3 GB a layer.
HEAD_BLOCK = 4
# Positions whose logits the loss holds at a time (each block
# checkpointed): an 8,192-token sequence's float32 logits over 163,840
# entries would take 5.4 GB, and as much again for their gradient.
LOSS_BLOCK = 1024


# -- the configuration ---------------------------------------------------------

def sizes(c: dict) -> dict:
    """The sizes the reference reads from a configuration file."""
    a = c["assumed"]
    return {"layers": c["num_hidden_layers"], "d_model": c["hidden_size"],
            "heads": c["num_attention_heads"],
            "q_nope": c["qk_nope_head_dim"], "q_rope": c["qk_rope_head_dim"],
            "v_dim": c["v_head_dim"], "kv_rank": c["kv_lora_rank"],
            "d_ff": c["intermediate_size"],
            "dense": c["first_k_dense_replace"],
            "vocab": c["vocab_size"], "d_expert": c["moe_intermediate_size"],
            "experts": c["n_routed_experts"],
            "top_k": c["num_experts_per_tok"],
            "shared": c["n_shared_experts"], "eps": c["rms_norm_eps"],
            "theta": c["rope_theta"],
            "routed_scale": c["routed_scaling_factor"],
            "aux": a["aux_loss_alpha"], "bias_rate": a["bias_update_rate"],
            "capacity_factor": a["capacity_factor"], "z_loss": a["z_loss"]}


def leaf_shapes(s: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter's shape, by the program's names."""
    d, h = s["d_model"], s["heads"]
    r, dr = s["kv_rank"], s["q_rope"]
    de, e, sh = s["d_expert"], s["experts"], s["shared"]
    out = {"embed.tokens": (s["vocab"], d), "embed.lm_head": (d, s["vocab"]),
           "final_norm": (d,)}
    for i in range(s["layers"]):
        p = f"decoder.{i}."
        out.update({
            p + "norm_mix": (d,), p + "norm_mlp": (d,),
            p + "mixer.wq": (d, h, s["q_nope"] + dr),
            p + "mixer.wkva": (d, r + dr), p + "mixer.kv_norm": (r,),
            p + "mixer.wkvb": (r, h, s["q_nope"] + s["v_dim"]),
            p + "mixer.wo": (h, s["v_dim"], d)})
        if i < s["dense"]:
            out.update({p + "mlp.wi": (d, s["d_ff"]),
                        p + "mlp.wg": (d, s["d_ff"]),
                        p + "mlp.wo": (s["d_ff"], d)})
            continue
        out.update({
            p + "mlp.router": (d, e),
            p + "mlp.experts.wi": (e, d, de), p + "mlp.experts.wg": (e, d, de),
            p + "mlp.experts.wo": (e, de, d),
            p + "mlp.shared.wi": (d, de * sh), p + "mlp.shared.wg": (d, de * sh),
            p + "mlp.shared.wo": (de * sh, d)})
    return out


def leaf_scales(shapes: dict) -> dict[str, float | str]:
    """The initial scale of each leaf: norms are ones, the token table
    std 1, every other matrix std 1 / sqrt(its fan-in): d_model for wq
    and wkva, the latent's width for wkvb, heads x v_head_dim for wo,
    the second-to-last size of the others."""
    out: dict[str, float | str] = {}
    for name, shape in shapes.items():
        if len(shape) == 1:
            out[name] = "ones"
        elif name == "embed.tokens":
            out[name] = 1.0
        elif name.endswith(("mixer.wq", "mixer.wkvb")):
            out[name] = 1.0 / math.sqrt(shape[0])
        elif name.endswith("mixer.wo"):
            out[name] = 1.0 / math.sqrt(shape[0] * shape[1])
        else:
            out[name] = 1.0 / math.sqrt(shape[-2])
    return out


def moe_layers(s: dict) -> list[int]:
    return list(range(s["dense"], s["layers"]))


def initial_biases(s: dict, device) -> dict[int, torch.Tensor]:
    """Each MoE layer's balancing bias at the start: zeros."""
    return {i: torch.zeros(s["experts"], device=device)
            for i in moe_layers(s)}


# -- the model ------------------------------------------------------------------

def attention(p: dict, h: torch.Tensor, s: dict, precision: str):
    """Causal latent attention of h (B, S, D) at positions 0..S-1."""
    b, t, d = h.shape
    hq, dn, dr, dv, r = (s["heads"], s["q_nope"], s["q_rope"], s["v_dim"],
                         s["kv_rank"])
    q = matmul(h, p["mixer.wq"].reshape(d, hq * (dn + dr)),
               precision).reshape(b, t, hq, dn + dr)
    kva = matmul(h, p["mixer.wkva"], precision)
    c = rmsnorm(kva[..., :r], p["mixer.kv_norm"], s["eps"])
    kvb = matmul(c, p["mixer.wkvb"].reshape(r, hq * (dn + dv)),
                 precision).reshape(b, t, hq, dn + dv)
    q = torch.cat([q[..., :dn], rotary(q[..., dn:], s["theta"])], dim=-1)
    k_pe = rotary(kva[..., None, r:], s["theta"]).expand(-1, -1, hq, -1)
    k = torch.cat([kvb[..., :dn], k_pe], dim=-1)
    v = kvb[..., dn:]
    q, k, v = (z.transpose(1, 2) for z in (q, k, v))       # (B, H, S, .)
    causal = torch.ones(t, t, dtype=torch.bool, device=h.device).tril()
    outs = []
    for h0 in range(0, hq, HEAD_BLOCK):
        sl = slice(h0, h0 + HEAD_BLOCK)
        scores = (q[:, sl] @ k[:, sl].transpose(-1, -2)) * (dn + dr) ** -0.5
        probs = torch.softmax(scores.masked_fill(~causal, -math.inf), -1)
        outs.append(probs @ v[:, sl])
    o = torch.cat(outs, dim=1).transpose(1, 2).reshape(b, t, hq * dv)
    return matmul(o, p["mixer.wo"].reshape(hq * dv, d), precision)


def capacity(t: int, s: dict) -> int:
    return max(1, min(t, int(t * s["top_k"] * s["capacity_factor"] /
                             s["experts"]) + 1))


def routing(logits: torch.Tensor, bias: torch.Tensor, s: dict,
            prompt_len: int | None = None):
    """(weights (B,S,k), experts (B,S,k), kept (B,S,k), balance loss,
    loads (E,)). The capacity is that of ``prompt_len`` tokens (the
    sequence's by default) and positions from ``prompt_len`` on are
    never dropped: a prompt's prefill, then dropless decode."""
    e, k = s["experts"], s["top_k"]
    b, t = logits.shape[:2]
    scores = torch.sigmoid(logits)
    _, top_e = torch.sort(scores + bias, dim=-1, descending=True,
                          stable=True)
    top_e = top_e[..., :k]
    top_s = torch.gather(scores, -1, top_e)
    top_w = top_s / (top_s.sum(-1, keepdim=True) + 1e-20) * s["routed_scale"]
    n = t if prompt_len is None else prompt_len
    chosen = F.one_hot(top_e.reshape(b, t * k), e)          # (B, S k, E)
    before = torch.cumsum(chosen, dim=1) - chosen
    slot = torch.gather(before, -1, top_e.reshape(b, t * k, 1))[..., 0]
    late = torch.arange(t, device=logits.device) >= n
    kept = (slot.reshape(b, t, k) < capacity(n, s)) | late[None, :, None]
    counts = F.one_hot(top_e, e).float().sum(dim=(1, 2))    # (B, E)
    f = counts * (e / (t * k))
    probs = scores / scores.sum(-1, keepdim=True)
    balance = (f * probs.mean(dim=1)).sum(-1).mean() * s["aux"]
    return top_w, top_e, kept, balance, counts.sum(0).detach()


def moe(p: dict, h: torch.Tensor, bias: torch.Tensor, s: dict,
        precision: str, prompt_len: int | None = None):
    """(output, balance loss, loads) of a MoE MLP."""
    b, t, d = h.shape
    out = swiglu(h, p["mlp.shared.wi"], p["mlp.shared.wg"],
                 p["mlp.shared.wo"], precision)
    top_w, top_e, kept, balance, loads = routing(
        matmul(h, p["mlp.router"], precision), bias, s, prompt_len)
    flat = h.reshape(b * t, d)
    routed = torch.zeros_like(flat)
    tok = torch.arange(b * t, device=h.device)[:, None].expand(-1, s["top_k"])
    e_all, w_all = top_e.reshape(b * t, -1), top_w.reshape(b * t, -1)
    keep = kept.reshape(b * t, -1)
    for e in range(s["experts"]):
        sel = (e_all == e) & keep
        rows = tok[sel]
        if rows.numel() == 0:
            continue
        y = swiglu(flat[rows], p["mlp.experts.wi"][e], p["mlp.experts.wg"][e],
                   p["mlp.experts.wo"][e], precision)
        routed = routed.index_add(0, rows, y * w_all[sel][:, None])
    return out + routed.reshape(b, t, d), balance, loads


def layer(x: torch.Tensor, p: dict, bias: torch.Tensor | None, s: dict,
          precision: str, prompt_len: int | None = None):
    """(x, balance loss, loads) after one layer; ``bias`` None: dense."""
    x = x + attention(p, rmsnorm(x, p["norm_mix"], s["eps"]), s, precision)
    h = rmsnorm(x, p["norm_mlp"], s["eps"])
    if bias is None:
        zero = torch.zeros((), device=x.device)
        return x + swiglu(h, p["mlp.wi"], p["mlp.wg"], p["mlp.wo"],
                          precision), zero, zero
    y, balance, loads = moe(p, h, bias, s, precision, prompt_len)
    return x + y, balance, loads


def hidden(params: dict, biases: dict, tokens: torch.Tensor, s: dict,
           precision: str = "float32", prompt_len: int | None = None):
    """(the final normed hidden states (B, S, D), summed balance loss,
    {layer: loads})."""
    x = params["embed.tokens"][tokens]
    balance = torch.zeros((), device=x.device)
    loads = {}
    for i in range(s["layers"]):
        pre = f"decoder.{i}."
        p = {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}
        x, b_i, loads[i] = checkpoint(layer, x, p, biases.get(i), s,
                                      precision, prompt_len,
                                      use_reentrant=False)
        balance = balance + b_i
    return rmsnorm(x, params["final_norm"], s["eps"]), balance, loads


def logits(params: dict, biases: dict, tokens: torch.Tensor, s: dict,
           precision: str = "float32", prompt_len: int | None = None):
    """The logits at every position, (B, S, vocab)."""
    x, _, _ = hidden(params, biases, tokens, s, precision, prompt_len)
    return matmul(x, params["embed.lm_head"], precision)


def _head_sums(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
               precision: str):
    """(sum of cross-entropy, sum of logsumexp^2) over the kept labels of
    a block of positions."""
    out = matmul(x, head, precision)
    mask = (labels >= 0).float()
    lse = torch.logsumexp(out, dim=-1)
    gold = torch.gather(out, -1, labels.clamp_min(0)[..., None])[..., 0]
    return ((lse - gold) * mask).sum(), ((lse * lse) * mask).sum()


def loss(params: dict, biases: dict, batch: dict, s: dict,
         precision: str = "float32"):
    """(total loss, cross-entropy, {layer: loads}) of ``batch`` =
    {"tokens", "labels"} (B, S), labels below 0 left out; the logits are
    taken LOSS_BLOCK positions at a time."""
    x, balance, loads = hidden(params, biases, batch["tokens"], s, precision)
    labels = batch["labels"]
    ce = z = torch.zeros((), device=x.device)
    for s0 in range(0, labels.shape[1], LOSS_BLOCK):
        blk = slice(s0, s0 + LOSS_BLOCK)
        c, zz = checkpoint(_head_sums, x[:, blk], params["embed.lm_head"],
                           labels[:, blk], precision, use_reentrant=False)
        ce, z = ce + c, z + zz
    n = (labels >= 0).float().sum().clamp_min(1.0)
    ce = ce / n
    return ce + s["z_loss"] * z / n + balance, ce, loads


# -- the step -------------------------------------------------------------------

@torch.no_grad()
def update_biases(biases: dict, loads: dict, s: dict) -> None:
    """b_i += gamma x sign(mean load - load_i), in place."""
    for i, b in biases.items():
        b.add_(torch.sign(loads[i].mean() - loads[i]), alpha=s["bias_rate"])


def train_steps(params: dict, biases: dict, batches: list, s: dict,
                opt: dict, precision: str = "float32") -> dict:
    """The steps of ``batches`` from ``params`` and ``biases`` (both
    updated in place): each step's loss, each leaf's norm of the first
    step's clipped gradient; the caller takes the changes afterwards."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        state = {"mu": {}, "nu": {}, "count": 0}
        losses, first = [], None
        for p in params.values():
            p.requires_grad_(True)
        for batch in batches:
            total, _, loads = loss(params, biases, batch, s, precision)
            grads = dict(zip(params, torch.autograd.grad(
                total, list(params.values()))))
            losses.append(float(total.detach()))
            taken = adamw(params, grads, state, opt)
            update_biases(biases, loads, s)
            if first is None:
                first = {k: float(torch.linalg.vector_norm(g.double()))
                         for k, g in taken.items()}
            del grads, taken
        for p in params.values():
            p.requires_grad_(False)
        del state
        return {"losses": losses, "grad_norms": first}
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev
