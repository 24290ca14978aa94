"""Mamba (S6) selective state-space block: Jamba's recurrent layer.

Port of ``repro/models/mamba.py``::

    x -> in_proj -> (xp, z);  xp -> causal depthwise conv -> SiLU
    xp -> (dt, B, C);  dt = softplus(dt_proj(dt_r))
    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t * xp_t      (per channel)
    y_t = (h_t . C_t) + D * xp_t;   out = out_proj(y * SiLU(z))

An exact recurrence over time in float32, one step of (B, d_inner, N)
work per token, as the reference's two-level scan: the steps run in
chunks (the first of 128, 64, ..., 2 that divides S, when S is longer),
and with gradients on each chunk is checkpointed, so the backward pass
holds the state once a chunk and recomputes the chunk's steps, instead
of holding every step's (B, d_inner, N) tensors. Decode carries
(conv_state, h): O(1) a token.

The dry run's analyzer (``launch/inputs.py``) sets :data:`count_one_chunk`:
then the first two chunks run and the second, counted once for each
chunk after the first, stands in for those (shapes only).
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.sharding import constrain
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import Spec


#: None, or (in the dry run) a callable ``n -> context manager`` under
#: which the analyzer counts every op ``n`` times (``launch/hlo.py``
#: ``Counter.scaled``): the chunked time loop then runs its first two
#: chunks only, the second counted once for each chunk after the first
#: (forward, recompute and backward alike), and the skipped chunks'
#: outputs and saved states are allocated but not computed.
count_one_chunk: contextvars.ContextVar = contextvars.ContextVar(
    "count_one_chunk", default=None)


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

    # The time loop's inputs take one placement for the whole loop (on a
    # mesh the contraction over d_inner leaves a Partial sum, reduced
    # here once, as XLA reduces a scan's operand before the loop,
    # instead of once a step).
    dbc = constrain(xp @ p["x_proj"].to(dt_), ("batch", "seq", None))
    dt_r, bmat, cmat = dbc.split([dr, n, n], dim=-1)
    dt = F.softplus(dt_r @ p["dt_proj"].to(dt_) +
                    p["dt_bias"].to(dt_)).float()           # (B,S,di)
    a = -torch.exp(p["a_log"].float())                      # (di,N)

    xs = (xp.float(), dt, bmat.float(), cmat.float())
    h, y = _scan(h, a, xs)
    y = y.to(dt_)                                           # (B,S,di)
    y = y + xp * p["d_skip"].to(dt_)
    y = y * F.silu(z)
    out = constrain(y @ p["out_proj"].to(dt_), ("batch", "seq", "d_model"))
    return out, (conv_state, h)


def chunk_len(s: int) -> int:
    """The reference's chunk: the first of 128, 64, ..., 2 dividing
    ``s``, else 1."""
    return next((c for c in (128, 64, 32, 16, 8, 4, 2) if s % c == 0), 1)


def _steps(h, a, xs, dt, bm, cm):
    """The recurrence over dim 1 of (xs, dt, bm, cm) from state ``h``:
    (the last state, y (B, T, di)), float32."""
    ys = []
    for t in range(xs.shape[1]):
        dtt = dt[:, t]
        da = torch.exp(dtt[..., None] * a)                  # (B,di,N)
        h = da * h + (dtt * xs[:, t])[..., None] * bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cm[:, t]))
    return h, torch.stack(ys, dim=1)


class _Scope(torch.autograd.Function):
    """The identity on ``ts``, whose backward calls ``action`` first: on
    a chunk's outputs it enters the analyzer's weight, on its inputs it
    leaves it. Autograd runs a chunk's backward nodes one after another
    (the highest sequence number first, and every node of the chunk
    waits only on later ones), so the two bracket the chunk's backward
    and its checkpoint's recompute."""

    @staticmethod
    def forward(ctx, action, *ts):
        ctx.action = action
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        ctx.action()
        return (None, *grads)


def _scan(h, a, xs: tuple):
    """The time loop, in the reference's chunks when S is longer than
    one: each chunk checkpointed under grad (the state saved once a
    chunk); under :data:`count_one_chunk` only the first two run, the
    second counted for all but the first."""
    s = xs[0].shape[1]
    c = chunk_len(s)
    if c == 1 or s <= c:
        return _steps(h, a, *xs)
    n = s // c
    scaled = count_one_chunk.get()
    ys = []
    for i in range(n if scaled is None else 2):
        blk = tuple(x[:, i * c:(i + 1) * c] for x in xs)
        if scaled is not None and i == 1:
            h, y = _counted_chunk(h, a, blk, n - 1, scaled)
        elif torch.is_grad_enabled():
            h, y = checkpoint(_steps, h, a, *blk, use_reentrant=False)
        else:
            h, y = _steps(h, a, *blk)
        ys.append(y)
    if scaled is not None:
        ys += ys[-1:] * (n - 2)
    return h, torch.cat(ys, dim=1)


def _counted_chunk(h, a, blk: tuple, n: int, scaled):
    """One chunk, run as :func:`_scan` runs it, its forward, recompute
    and backward counted ``n`` times: it stands for the chunks after the
    first, each of which starts from a state that takes a gradient (the
    first starts from zeros). The n - 1 further states a checkpoint
    would hold between those chunks are allocated and held until the
    backward."""
    if not torch.is_grad_enabled():
        with scaled(n):
            return _steps(h, a, *blk)
    held = [torch.empty_like(h) for _ in range(n - 1)]
    weight = scaled(n)

    def leave():
        weight.__exit__(None, None, None)
        held.clear()

    ins = [h, a, *blk]
    scoped = iter(_Scope.apply(leave, *(t for t in ins if t.requires_grad)))
    h, a, *blk = (next(scoped) if t.requires_grad else t for t in ins)
    out = checkpoint(_steps, h, a, *blk, use_reentrant=False,
                     context_fn=lambda: (scaled(n), contextlib.nullcontext()))
    return _Scope.apply(weight.__enter__, *out)


def mamba_decode(p, x: torch.Tensor, cfg: ModelConfig,
                 state: tuple[torch.Tensor, torch.Tensor]):
    return mamba_forward(p, x, cfg, state=state)
