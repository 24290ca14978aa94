"""RWKV-6 (Finch) time-mixing: attention-free, data-dependent decay.

Port of ``repro/models/rwkv6.py``. A matrix-valued state S (N x N) per
head with the RWKV-6 recurrence::

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

where the decay w_t = exp(-exp(w0 + LoRA(x_t))) depends on the data.
Token-shift mixing on the projections, SiLU gate, per-head group
normalisation of the readout. Two forms over time, both float32:

  * sequential (``chunk=None``): one step per token, exact; serving
    uses it;
  * chunked (``chunk=C``): within a chunk the contributions come from
    cumulative decay products, and the state passes from chunk to chunk.
    Its per-step decay is clamped at exp(-30/C), so it equals the
    sequential form within the reference's own test bound.

Decode carries (shift, S): O(1) state a token.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import constrain, unflatten
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import Spec

LORA_RANK = 32


def rwkv_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    n = cfg.rwkv_head_dim
    h = d // n
    return {
        "mu": Spec((5, d), (None, "d_model"), init="zeros"),  # r,k,v,g,w
        "wr": Spec((d, d), ("d_model", "heads_x_dim")),
        "wk": Spec((d, d), ("d_model", "heads_x_dim")),
        "wv": Spec((d, d), ("d_model", "heads_x_dim")),
        "wg": Spec((d, d), ("d_model", "heads_x_dim")),
        "wo": Spec((d, d), ("heads_x_dim", "d_model")),
        "w0": Spec((d,), ("heads_x_dim",), init="zeros"),
        "w_lora_a": Spec((d, LORA_RANK), ("d_model", None)),
        "w_lora_b": Spec((LORA_RANK, d), (None, "heads_x_dim"),
                         init="zeros"),
        "u": Spec((h, n), ("heads", "head_dim"), init="zeros"),
        "ln_scale": Spec((h, n), ("heads", "head_dim"), init="ones"),
    }


def _projections(p, x: torch.Tensor, x_shift: torch.Tensor,
                 cfg: ModelConfig):
    """Token-shift mix + r/k/v/g/w projections."""
    dt = x.dtype
    mu = p["mu"].to(dt)                                     # (5, d)
    mix = x[None] + (x_shift - x)[None] * mu[:, None, None, :]
    xr, xk, xv, xg, xw = mix
    n = cfg.rwkv_head_dim
    h = cfg.d_model // n
    b, s, _ = x.shape
    def cst(a):
        return constrain(a, ("batch", "seq", "heads_x_dim"))

    def heads(a):
        return unflatten(a, 2, (h, n))

    r = heads(cst(xr @ p["wr"].to(dt)))
    k = heads(cst(xk @ p["wk"].to(dt)))
    v = heads(cst(xv @ p["wv"].to(dt)))
    g = F.silu(cst(xg @ p["wg"].to(dt)))
    # Data-dependent decay (the RWKV-6 contribution).
    lora = torch.tanh(xw @ p["w_lora_a"].to(dt)) @ p["w_lora_b"].to(dt)
    w = heads(torch.exp(-torch.exp((p["w0"].float() + lora.float())
                                   .clamp(-8.0, 4.0))))
    return r, k, v, g, w


def _readout(p, y: torch.Tensor, g: torch.Tensor, cfg: ModelConfig):
    """Per-head group norm (population variance), gate, output
    projection."""
    b, s, h, n = y.shape
    yf = y.float()
    mean = yf.mean(-1, keepdim=True)
    var = yf.var(-1, keepdim=True, correction=0)
    yn = (yf - mean) * torch.rsqrt(var + 1e-5) * p["ln_scale"].float()
    out = yn.reshape(b, s, h * n).to(g.dtype) * g
    return out @ p["wo"].to(g.dtype)


def rwkv_forward(p, x: torch.Tensor, cfg: ModelConfig,
                 state: tuple[torch.Tensor, torch.Tensor] | None = None,
                 chunk: int | None = None):
    """x: (B, S, d). state: (shift (B, d), S (B, H, N, N)) or None.

    Returns (y, new_state).
    """
    b, s, d = x.shape
    n = cfg.rwkv_head_dim
    h = d // n
    if state is None:
        shift0 = torch.zeros((b, d), dtype=x.dtype, device=x.device)
        s0 = torch.zeros((b, h, n, n), dtype=torch.float32,
                         device=x.device)
    else:
        shift0, s0 = state
    x_shift = torch.cat([shift0[:, None], x[:, :-1]], dim=1)
    r, k, v, g, w = _projections(p, x, x_shift, cfg)
    u = p["u"].float()
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))      # (B,S,H,N)

    if chunk is None:
        st = s0
        ys = []
        for t in range(s):
            kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]  # (B,H,N,N)
            ys.append(torch.einsum("bhn,bhnm->bhm", rf[:, t],
                                   st + u[..., :, None] * kv))
            st = wf[:, t, :, :, None] * st + kv
        s_final, y = st, torch.stack(ys, dim=1)
    else:
        s_final, y = _chunked(rf, kf, vf, wf, u, s0, chunk)
    out = _readout(p, y, g, cfg)
    return out, (x[:, -1], s_final)


def _chunked(r, k, v, w, u, s0, chunk: int):
    """Block-parallel RWKV evaluation (O(T/C) sequential steps), all in
    float32. r, k, v, w: (B, S, H, N).

    Within a chunk: y_t = r_t (prod_{i<t} w_i) S_in plus the causal pairs
    inside the chunk, each with the decay product between k_i and r_t.
    """
    b, s, h, n = r.shape
    if s % chunk:
        raise ValueError(f"sequence {s} must divide by chunk {chunk}")
    mask = torch.tril(torch.ones((chunk, chunk), device=r.device), -1)
    st = s0
    ys = []
    for c0 in range(0, s, chunk):
        rc, kc, vc, wc = (a[:, c0:c0 + chunk] for a in (r, k, v, w))
        logw = torch.log(wc.clamp_min(1e-38))
        # Stability clamp for the factored decay products: a per-step
        # decay below exp(-30/C) compounds to < 1e-13 across the chunk,
        # numerically zero in f32, while exp(-cum) stays <= e^30.
        logw = logw.clamp_min(-30.0 / chunk)
        cum = torch.cumsum(logw, dim=1)         # prod_{i<=t} w_i
        cum_excl = cum - logw                   # prod_{i<t} w_i
        # Inter-chunk: r_t decayed against the incoming state.
        r_dec = rc * torch.exp(cum_excl)
        y_inter = torch.einsum("bchn,bhnm->bchm", r_dec, st)
        # Intra-chunk causal pairs: the decay between i (k) and t (r) is
        # prod_{j in (i, t)} w_j = exp(cum_excl[t] - cum[i]).
        att = torch.einsum("bchn,bdhn->bhcd", r_dec, kc * torch.exp(-cum))
        att = att * mask
        # Current-token bonus term (diag(u)).
        bonus = torch.einsum("bchn,bchn->bch", rc * u, kc)
        y_intra = torch.einsum("bhcd,bdhn->bchn", att, vc) + \
            bonus[..., None] * vc
        # State update across the chunk.
        k_dec = kc * torch.exp(cum[:, -1:] - cum)
        st = torch.exp(cum[:, -1])[..., :, None] * st + torch.einsum(
            "bchn,bchm->bhnm", k_dec, vc)
        ys.append(y_inter + y_intra)
    return st, torch.cat(ys, dim=1)


def rwkv_decode(p, x: torch.Tensor, cfg: ModelConfig,
                state: tuple[torch.Tensor, torch.Tensor]):
    """Single-token decode; x: (B, 1, d)."""
    return rwkv_forward(p, x, cfg, state=state)
