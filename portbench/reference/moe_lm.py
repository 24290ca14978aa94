"""The plain reference of a DeepSeekMoE decoder's train step, as the
configuration file states it: the loss, its gradients and AdamW, in
float32 with TF32 off, in plain PyTorch. Imports nothing of the program.

The model (configuration keys as in the published ``config.json``):
token embedding; per layer a pre-norm RMSNorm, causal multi-head
attention with rotary embeddings (halves rotated, not interleaved) and
the scores scaled by head_dim ** -0.5, a residual; a pre-norm RMSNorm,
then ``n_shared_experts`` SwiGLU experts merged into one of that many
times the width and ``n_routed_experts`` routed ones: softmax over the
router's logits, the ``num_experts_per_tok`` largest (the lower expert
first among equals), their weights renormalised to sum to 1, each
expert taking at most C = int(S k cf / E) + 1 of a sequence's tokens in
the order (token, choice) and dropping the rest; a residual. A final
RMSNorm, untied output head; loss = mean cross-entropy + z_loss mean
logsumexp^2 + the Switch balance loss E sum_e f_e p_e times
``aux_loss_alpha`` summed over the layers. Each layer is checkpointed,
so that the whole step fits on one card beside nothing else.

``precision="fp8"`` is the control: every product with a weight takes
its operands rounded to float8 e4m3 (one scale a tensor, its largest
magnitude at 448) and the backward's output gradients rounded to e5m2,
the step below the bfloat16 the configuration computes in.

The optimizer is AdamW as the configuration states it: gradients scaled
by min(1, clip / global norm), bias-corrected moments, eps added to the
root, weight decay added to the normalised step, lr from a linear
warm-up to a cosine.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


# -- the configuration ---------------------------------------------------------

def sizes(c: dict) -> dict:
    """The sizes the reference reads from a configuration file."""
    a = c["assumed"]
    return {"layers": c["num_hidden_layers"], "d_model": c["hidden_size"],
            "heads": c["num_attention_heads"],
            "kv_heads": c["num_key_value_heads"],
            "head_dim": c["hidden_size"] // c["num_attention_heads"],
            "vocab": c["vocab_size"], "d_expert": c["moe_intermediate_size"],
            "experts": c["n_routed_experts"],
            "top_k": c["num_experts_per_tok"],
            "shared": c["n_shared_experts"], "eps": c["rms_norm_eps"],
            "theta": c["rope_theta"], "aux": c["aux_loss_alpha"],
            "capacity_factor": a["capacity_factor"], "z_loss": a["z_loss"]}


def leaf_shapes(s: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter's shape, by name."""
    d, h, kv, dh = s["d_model"], s["heads"], s["kv_heads"], s["head_dim"]
    de, e, sh = s["d_expert"], s["experts"], s["shared"]
    out = {"embed.tokens": (s["vocab"], d), "embed.lm_head": (d, s["vocab"]),
           "final_norm": (d,)}
    for i in range(s["layers"]):
        p = f"decoder.{i}."
        out.update({
            p + "norm_mix": (d,), p + "norm_mlp": (d,),
            p + "mixer.wq": (d, h, dh), p + "mixer.wk": (d, kv, dh),
            p + "mixer.wv": (d, kv, dh), p + "mixer.wo": (h, dh, d),
            p + "mlp.router": (d, e),
            p + "mlp.experts.wi": (e, d, de), p + "mlp.experts.wg": (e, d, de),
            p + "mlp.experts.wo": (e, de, d),
            p + "mlp.shared.wi": (d, de * sh), p + "mlp.shared.wg": (d, de * sh),
            p + "mlp.shared.wo": (de * sh, d)})
    return out


def leaf_scales(shapes: dict) -> dict[str, float | str]:
    """The initial scale of each leaf: norms are ones, the token table
    std 1, every other matrix std 1 / sqrt(its fan-in): the attention
    projections' d_model (q, k, v) and heads x head_dim (the output),
    the experts', router's and head's second-to-last size."""
    out: dict[str, float | str] = {}
    for name, shape in shapes.items():
        if len(shape) == 1:
            out[name] = "ones"
        elif name == "embed.tokens":
            out[name] = 1.0
        elif name.endswith(("mixer.wq", "mixer.wk", "mixer.wv")):
            out[name] = 1.0 / math.sqrt(shape[0])
        elif name.endswith("mixer.wo"):
            out[name] = 1.0 / math.sqrt(shape[0] * shape[1])
        else:
            out[name] = 1.0 / math.sqrt(shape[-2])
    return out


# -- products -----------------------------------------------------------------

def _round_fp8(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp_min(1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Fp8Matmul(torch.autograd.Function):
    """a @ b with both rounded to e4m3 and the output gradient to e5m2."""

    @staticmethod
    def forward(ctx, a, b):
        a8 = _round_fp8(a, torch.float8_e4m3fn, E4M3_MAX)
        b8 = _round_fp8(b, torch.float8_e4m3fn, E4M3_MAX)
        ctx.save_for_backward(a8, b8)
        return a8 @ b8

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = _round_fp8(g, torch.float8_e5m2, E5M2_MAX)
        return g8 @ b8.transpose(-1, -2), a8.transpose(-1, -2) @ g8


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return _Fp8Matmul.apply(a, b)
    return a @ b


# -- the model ------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, Dh) rotated by its positions 0..S-1, halves split."""
    s, half = x.shape[1], x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float64,
                                   device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * \
        freq
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p: dict, h: torch.Tensor, s: dict, precision: str):
    b, t, d = h.shape
    hq, kv, dh = s["heads"], s["kv_heads"], s["head_dim"]

    def proj(w, n):
        return matmul(h, w.reshape(d, n * dh), precision).reshape(b, t, n, dh)

    q = rotary(proj(p["mixer.wq"], hq), s["theta"])
    k = rotary(proj(p["mixer.wk"], kv), s["theta"])
    v = proj(p["mixer.wv"], kv)
    if kv != hq:
        k = k.repeat_interleave(hq // kv, dim=2)
        v = v.repeat_interleave(hq // kv, dim=2)
    q, k, v = (z.transpose(1, 2) for z in (q, k, v))       # (B, H, S, Dh)
    scores = (q @ k.transpose(-1, -2)) * dh ** -0.5
    causal = torch.ones(t, t, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, -math.inf), dim=-1)
    o = (probs @ v).transpose(1, 2).reshape(b, t, hq * dh)
    return matmul(o, p["mixer.wo"].reshape(hq * dh, d), precision)


def swiglu(x, wi, wg, wo, precision):
    return matmul(F.silu(matmul(x, wg, precision)) * matmul(x, wi, precision),
                  wo, precision)


def routing(logits: torch.Tensor, s: dict):
    """(weights (B,S,k), experts (B,S,k), kept (B,S,k), balance loss)."""
    e, k = s["experts"], s["top_k"]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., :k], top_e[..., :k]
    top_w = top_w / top_w.sum(-1, keepdim=True)
    b, t = logits.shape[:2]
    cap = max(1, min(t, int(t * k * s["capacity_factor"] / e) + 1))
    chosen = F.one_hot(top_e.reshape(b, t * k), e)          # (B, S k, E)
    before = torch.cumsum(chosen, dim=1) - chosen
    slot = torch.gather(before, -1, top_e.reshape(b, t * k, 1))[..., 0]
    kept = (slot < cap).reshape(b, t, k)
    f = F.one_hot(top_e, e).float().mean(dim=(0, 1, 2))
    balance = e * torch.sum(f * probs.mean(dim=(0, 1))) * s["aux"]
    return top_w, top_e, kept, balance


def moe(p: dict, h: torch.Tensor, s: dict, precision: str):
    b, t, d = h.shape
    out = swiglu(h, p["mlp.shared.wi"], p["mlp.shared.wg"],
                 p["mlp.shared.wo"], precision)
    top_w, top_e, kept, balance = routing(
        matmul(h, p["mlp.router"], precision), s)
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
    return out + routed.reshape(b, t, d), balance


def layer(x: torch.Tensor, p: dict, s: dict, precision: str):
    x = x + attention(p, rmsnorm(x, p["norm_mix"], s["eps"]), s, precision)
    y, balance = moe(p, rmsnorm(x, p["norm_mlp"], s["eps"]), s, precision)
    return x + y, balance


def loss(params: dict, batch: dict, s: dict, precision: str = "float32"):
    """(total loss, cross-entropy) of ``batch`` = {"tokens", "labels"}
    (B, S), labels below 0 left out."""
    x = params["embed.tokens"][batch["tokens"]]
    balance = torch.zeros((), device=x.device)
    for i in range(s["layers"]):
        pre = f"decoder.{i}."
        p = {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}
        x, b_i = checkpoint(layer, x, p, s, precision, use_reentrant=False)
        balance = balance + b_i
    x = rmsnorm(x, params["final_norm"], s["eps"])
    logits = matmul(x, params["embed.lm_head"], precision)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp_min(0)[..., None])[..., 0]
    n = mask.sum().clamp_min(1.0)
    ce = ((lse - gold) * mask).sum() / n
    z = s["z_loss"] * ((lse * lse) * mask).sum() / n
    return ce + z + balance, ce


# -- the optimizer --------------------------------------------------------------

def learning_rate(step: int, opt: dict) -> float:
    """Linear warm-up to ``peak_lr`` over ``warmup`` steps, then a cosine
    to ``final_frac`` of it at ``total`` steps."""
    peak, warm, total = opt["peak_lr"], opt["warmup"], opt["total"]
    if step < warm:
        return peak * step / max(1, warm)
    frac = min(1.0, max(0.0, (step - warm) / max(1, total - warm)))
    return peak * (opt["final_frac"] + (1 - opt["final_frac"]) * 0.5 *
                   (1 + math.cos(math.pi * frac)))


@torch.no_grad()
def adamw(params: dict, grads: dict, state: dict, opt: dict) -> dict:
    """One AdamW step in place; returns each leaf's gradient as the
    moments take it (clipped), for the caller's norms."""
    state["count"] += 1
    c = state["count"]
    gnorm = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                          for g in grads.values()))
    scale = min(1.0, opt["clip"] / max(gnorm, 1e-9))
    b1, b2 = opt["b1"], opt["b2"]
    bc1, bc2 = 1 - b1 ** c, 1 - b2 ** c
    lr = learning_rate(c, opt)
    taken = {}
    for k, p in params.items():
        g = grads[k] * scale
        m = state["mu"].setdefault(k, torch.zeros_like(p))
        v = state["nu"].setdefault(k, torch.zeros_like(p))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        p.add_(-lr * ((m / bc1) / ((v / bc2).sqrt() + opt["eps"]) +
                      opt["weight_decay"] * p))
        taken[k] = g
    return taken


def train_steps(params: dict, batches: list, s: dict, opt: dict,
                precision: str = "float32") -> dict:
    """The steps of ``batches`` from ``params`` (updated in place):
    each step's loss, each leaf's norm of the first step's clipped
    gradient; the caller takes the change of ``params`` afterwards."""
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
            total, _ = loss(params, batch, s, precision)
            grads = dict(zip(params, torch.autograd.grad(
                total, list(params.values()))))
            losses.append(float(total.detach()))
            taken = adamw(params, grads, state, opt)
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
