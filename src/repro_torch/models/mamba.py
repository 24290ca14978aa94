"""Mamba (S6) selective state-space block: Jamba's recurrent layer.

Port of ``repro/models/mamba.py``::

    x -> in_proj -> (xp, z);  xp -> causal depthwise conv -> SiLU
    xp -> (dt, B, C);  dt = softplus(dt_proj(dt_r))
    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t * xp_t      (per channel)
    y_t = (h_t . C_t) + D * xp_t;   out = out_proj(y * SiLU(z))

An exact sequential recurrence over time in float32, one step of
(B, d_inner, N) work per token. Decode carries (conv_state, h): O(1) a
token. The reference scans in checkpointed chunks so that its backward
pass saves the state once a chunk; the port has no backward for this
layer yet (ROADMAP Queue 1 item 11), and the forward values are the
same.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import constrain
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import Spec


def _dt_rank(cfg: ModelConfig) -> int:
    return max(1, (cfg.d_model + 15) // 16)


def mamba_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di = cfg.mamba_expand * d
    n = cfg.mamba_d_state
    dr = _dt_rank(cfg)
    return {
        "in_proj": Spec((d, 2 * di), ("d_model", "d_inner")),
        "conv_w": Spec((cfg.mamba_d_conv, di), (None, "d_inner"),
                       scale=0.5),
        "conv_b": Spec((di,), ("d_inner",), init="zeros"),
        "x_proj": Spec((di, dr + 2 * n), ("d_inner", None)),
        "dt_proj": Spec((dr, di), (None, "d_inner")),
        "dt_bias": Spec((di,), ("d_inner",), init="zeros"),
        "a_log": Spec((di, n), ("d_inner", None), init="zeros"),
        "d_skip": Spec((di,), ("d_inner",), init="ones"),
        "out_proj": Spec((di, d), ("d_inner", "d_model")),
    }


def _conv(p, xp: torch.Tensor, conv_state: torch.Tensor):
    """Causal depthwise conv over time. xp: (B, S, di).

    conv_state: (B, d_conv-1, di), the trailing inputs of the previous
    segment. Returns (convolved, new_state).
    """
    dc = p["conv_w"].shape[0]
    hist = torch.cat([conv_state.to(xp.dtype), xp], dim=1)
    w = p["conv_w"].to(xp.dtype)
    s = xp.shape[1]
    out = sum(hist[:, i:i + s] * w[i] for i in range(dc))
    out = out + p["conv_b"].to(xp.dtype)
    return F.silu(out), hist[:, -(dc - 1):]


def mamba_forward(p, x: torch.Tensor, cfg: ModelConfig,
                  state: tuple[torch.Tensor, torch.Tensor] | None = None):
    """x: (B, S, d); state = (conv_state, h) or None -> zeros.

    Returns (y (B, S, d), new_state); h stays float32.
    """
    b, s, d = x.shape
    di = cfg.mamba_expand * d
    n = cfg.mamba_d_state
    dr = _dt_rank(cfg)
    dc = cfg.mamba_d_conv
    if state is None:
        conv_state = torch.zeros((b, dc - 1, di), dtype=x.dtype,
                                 device=x.device)
        h = torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
    else:
        conv_state, h = state

    dt_ = x.dtype
    xz = x @ p["in_proj"].to(dt_)
    xp, z = xz.chunk(2, dim=-1)
    xp = constrain(xp, ("batch", "seq", "d_inner"))
    z = constrain(z, ("batch", "seq", "d_inner"))
    xp, conv_state = _conv(p, xp, conv_state)

    dbc = xp @ p["x_proj"].to(dt_)
    dt_r, bmat, cmat = dbc.split([dr, n, n], dim=-1)
    dt = F.softplus(dt_r @ p["dt_proj"].to(dt_) +
                    p["dt_bias"].to(dt_)).float()           # (B,S,di)
    a = -torch.exp(p["a_log"].float())                      # (di,N)

    xpf, bf, cf = xp.float(), bmat.float(), cmat.float()
    ys = []
    for t in range(s):
        dtt = dt[:, t]
        da = torch.exp(dtt[..., None] * a)                  # (B,di,N)
        h = da * h + (dtt * xpf[:, t])[..., None] * bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]))
    y = torch.stack(ys, dim=1).to(dt_)                      # (B,S,di)
    y = y + xp * p["d_skip"].to(dt_)
    y = y * F.silu(z)
    out = constrain(y @ p["out_proj"].to(dt_), ("batch", "seq", "d_model"))
    return out, (conv_state, h)


def mamba_decode(p, x: torch.Tensor, cfg: ModelConfig,
                 state: tuple[torch.Tensor, torch.Tensor]):
    return mamba_forward(p, x, cfg, state=state)
