"""The training kernels' route on the CPU: which causal self-attention
calls ``models/attention.py`` sends to ``train_attention`` (the kernels
of csrc/flash_attention_train.cu) and which to the streaming softmax,
the wrappers' refusals, and the plain versions the CPU runs (the same
forward and FlashAttention-2 backward in float32) against float64
autograd and the streaming route. The kernels themselves are checked on
the card (tests/test_torch_cuda.py)."""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.kernels.flash_attention import train as ft
from repro_torch.models import attention as attn

TEMPLATE_SHAPES = [(1, 128, 2, 128, 128), (2, 256, 3, 192, 128)]


def operands(b, s, h, dq, dv, *, kv_heads=None, dtype=torch.bfloat16,
             grad=True, seed=0):
    g = torch.Generator().manual_seed(seed)
    hk = kv_heads or h
    q, k, v = (torch.randn(shape, generator=g).to(dtype) for shape in (
        (b, s, h, dq), (b, s, hk, dq), (b, s, hk, dv)))
    return [t.requires_grad_(grad) for t in (q, k, v)]


@pytest.fixture
def on_card(monkeypatch):
    """Operands report a CUDA device to the route's choice; the training
    route's Function is stubbed and records its calls."""
    calls = []

    def stub(q, k, v, scale):
        calls.append((tuple(q.shape), tuple(k.shape), tuple(v.shape),
                      scale))
        return torch.zeros(v.shape, dtype=q.dtype) + 0 * q.sum()

    monkeypatch.setattr(attn, "_on_card", lambda t: True)
    monkeypatch.setattr(attn.flash_train, "attention", stub)
    return calls


@pytest.mark.parametrize("shape", TEMPLATE_SHAPES)
def test_an_eligible_cuda_operand_selects_the_kernel_route(on_card, shape):
    q, k, v = operands(*shape)
    assert attn.trains_on_kernel(q, k, v)
    o = attn.train_attention(q, k, v)
    assert o.shape == v.shape
    assert on_card == [(tuple(q.shape), tuple(k.shape), tuple(v.shape),
                        attn.q_scale(shape[3], torch.bfloat16))]


INELIGIBLE = {
    "window": (dict(), dict(window=64)),
    "softcap": (dict(), dict(softcap=30.0)),
    "grouped heads": (dict(kv_heads=1), dict()),
    "ragged S": (dict(s=200), dict()),
    "short S": (dict(s=64), dict()),
    "head width 64": (dict(dq=64, dv=64), dict()),
    "head width 192 / 192": (dict(dq=192, dv=192), dict()),
    "head width 128 / 64": (dict(dv=64), dict()),
    "float32": (dict(dtype=torch.float32), dict()),
    "no operand needs grad": (dict(grad=False), dict()),
}


@pytest.mark.parametrize("case", list(INELIGIBLE))
def test_every_ineligible_case_stays_on_the_streaming_route(on_card, case):
    shape = dict(b=1, s=256, h=2, dq=128, dv=128)
    kw, flags = dict(INELIGIBLE[case][0]), INELIGIBLE[case][1]
    shape.update({k: kw.pop(k) for k in list(kw) if k in shape})
    q, k, v = operands(*shape.values(), **kw)
    assert not attn.trains_on_kernel(q, k, v, **flags)


def test_grad_off_stays_on_the_streaming_route(on_card):
    q, k, v = operands(1, 256, 2, 128, 128)
    assert attn.trains_on_kernel(q, k, v)
    with torch.no_grad():
        assert not attn.trains_on_kernel(q, k, v)


@pytest.mark.parametrize("shape", TEMPLATE_SHAPES)
def test_cpu_operands_stay_on_the_streaming_route(shape):
    q, k, v = operands(*shape)
    assert not attn.trains_on_kernel(q, k, v)


def _dense_cfg(**kw):
    cfg = get_reduced("deepseek-moe-16b")
    return dataclasses.replace(cfg, **kw)


@pytest.mark.parametrize("attention", ["plain", "flash"])
def test_self_attention_sends_eligible_calls_to_the_kernel(on_card,
                                                           monkeypatch,
                                                           attention):
    """``self_attention`` at positions ``arange(S)``, causal, no window
    and no softcap: on either route name the eligible call takes the
    training kernels and never the streaming softmax."""
    monkeypatch.setattr(attn, "streaming_attention", None)
    q, k, v = operands(1, 128, 2, 128, 128)
    o = attn.self_attention(q, k, v, _dense_cfg(), None, causal=True,
                            attention=attention)
    assert o.shape == v.shape and len(on_card) == 1


@pytest.mark.parametrize("case", ["positions given", "not causal",
                                  "window", "softcap"])
def test_self_attention_keeps_the_streaming_route(on_card, monkeypatch,
                                                  case):
    seen = []
    monkeypatch.setattr(attn, "streaming_attention",
                        lambda q, k, v, *a, **kw: seen.append(kw) or
                        torch.zeros(v.shape, dtype=q.dtype))
    cfg = _dense_cfg(attn_window=64 if case == "window" else None,
                     attn_logit_softcap=30.0 if case == "softcap" else None)
    q, k, v = operands(1, 128, 2, 128, 128)
    attn.self_attention(
        q, k, v, cfg, torch.arange(128) if case == "positions given" else
        None, causal=case != "not causal", attention="plain")
    assert len(seen) == 1 and on_card == []


def _mla_cfg():
    """The reduced Moonlight with latent attention's published head
    widths (128 + 64 for q and k, 128 for v) on a narrow model."""
    cfg = get_reduced("moonlight-16b-a3b")
    return dataclasses.replace(cfg, mla=dataclasses.replace(
        cfg.mla, qk_nope_head_dim=128, qk_rope_head_dim=64,
        v_head_dim=128))


@pytest.mark.parametrize("given", [False, True])
def test_mla_forward_takes_the_kernel_at_arange_positions(on_card, given):
    from repro_torch.models import params as prm
    cfg = _mla_cfg()
    specs = attn.mla_specs(cfg)
    p = prm.Params(specs, device="cpu", dtype=torch.float32)
    prm.init(p, specs, torch.Generator().manual_seed(0))
    p.requires_grad_(True)
    x = torch.randn(1, 128, cfg.d_model).to(torch.bfloat16)
    y, _, _ = attn.mla_forward(p, x, cfg,
                               torch.arange(128) if given else None)
    assert y.shape == x.shape
    want = [] if given else [((1, 128, cfg.n_heads, 192),
                              (1, 128, cfg.n_heads, 192),
                              (1, 128, cfg.n_heads, 128),
                              attn.q_scale(192, torch.bfloat16))]
    assert on_card == want


@pytest.mark.parametrize("shape", TEMPLATE_SHAPES)
def test_takes_the_templates_only(shape):
    q, k, v = operands(*shape, grad=False)
    assert ft.takes(q, k, v)
    assert not ft.takes(q, k[:, :, :1], v[:, :, :1])
    assert not ft.takes(q.float(), k.float(), v.float())
    assert not ft.takes(q[:, :100], k[:, :100], v[:, :100])


REFUSALS = {
    "float32": (TypeError, lambda q, k, v: (q.float(), k, v)),
    "another head width": (ValueError, lambda q, k, v: (
        q[..., :64], k[..., :64], v)),
    "ragged S": (ValueError, lambda q, k, v: (q[:, :100], k[:, :100],
                                              v[:, :100])),
    "grouped heads": (ValueError, lambda q, k, v: (q, k[:, :, :1],
                                                   v[:, :, :1])),
    "CPU tensors": (ValueError, lambda q, k, v: (q, k, v)),
}


@pytest.mark.parametrize("case", list(REFUSALS))
@pytest.mark.parametrize("launch", ["forward", "backward_dq",
                                    "backward_dkdv"])
def test_the_wrappers_refuse_what_the_kernels_do_not_take(case, launch):
    err, make = REFUSALS[case]
    q, k, v = make(*operands(1, 128, 2, 128, 128, grad=False))
    b, s, h = v.shape[:3]
    rows = torch.zeros(b, h, s)
    args = {"forward": (q, k, v, 0.1),
            "backward_dq": (q, k, v, v, torch.zeros(v.shape), rows, 0.1),
            "backward_dkdv": (q, k, v, v, rows, rows, 0.1)}[launch]
    before = getattr(ft, launch).launches
    with pytest.raises(err):
        getattr(ft, launch)(*args)
    assert getattr(ft, launch).launches == before


def test_readable_and_ready():
    """The kernels read D-contiguous operands with 16-byte rows where
    they lie; anything else is copied first."""
    x = torch.zeros(2, 128, 3, 256, dtype=torch.bfloat16)
    v = x[..., 128:]                       # latent attention's v view
    assert ft.readable(x) and ft.readable(v) and ft.ready(v) is v
    odd = torch.zeros(2, 128, 3, 129, dtype=torch.bfloat16)[..., :128]
    assert not ft.readable(odd)
    assert ft.ready(odd).is_contiguous()
    wide = torch.zeros(1, 128, 1, 128, dtype=torch.bfloat16).expand(
        1, 128, 4, 128)
    assert not ft.readable(wide)           # a stride of 0 over heads
    assert not ft.readable(x.transpose(2, 3))


def _float64_reference(q, k, v, do, scale):
    """o, lse and the gradients of causal attention in float64 autograd
    on the same (bf16) values."""
    qd, kd, vd = (t.detach().double().requires_grad_() for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * scale
    n = s.shape[-1]
    s = s.masked_fill(torch.ones(n, n, dtype=torch.bool).triu(1),
                      float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vd)
    o.backward(do.double())
    return o.detach(), torch.logsumexp(s, -1).detach(), qd.grad, kd.grad, \
        vd.grad


@pytest.mark.parametrize("shape", TEMPLATE_SHAPES)
def test_plain_versions_are_flashattention_2_in_float32(shape):
    """forward_plain's o32 and lse and backward_plain's gradients (P =
    exp(S - LSE), D = rowsum(dO o32)) against float64 autograd on the
    same bf16 values: f32 within 1e-5 of the largest, the bf16 outputs
    within their rounding (2^-8 of each value) plus 1e-5."""
    q, k, v = operands(*shape, grad=False)
    do = torch.randn(v.shape, generator=torch.Generator().manual_seed(9)
                     ).to(torch.bfloat16)
    scale = attn.q_scale(shape[3], torch.bfloat16)
    o, o32, lse = ft.forward_plain(q, k, v, scale)
    grads = ft.backward_plain(q, k, v, do, o32, lse, scale)
    ref_o, ref_lse, *ref_grads = _float64_reference(q, k, v, do, scale)

    def close(got, ref, rel, floor):
        got = got.double()
        return bool(((got - ref).abs() <= rel * ref.abs() +
                     floor * ref.abs().max()).all())

    assert o.dtype == torch.bfloat16 and close(o, ref_o, 2 ** -8, 1e-5)
    assert close(o32, ref_o, 0, 1e-5) and close(lse, ref_lse, 0, 1e-5)
    for got, ref in zip(grads, ref_grads):
        assert got.dtype == torch.bfloat16
        assert close(got, ref, 2 ** -8, 1e-5)


@pytest.mark.parametrize("shape", TEMPLATE_SHAPES)
def test_the_function_on_the_cpu_matches_the_streaming_route(shape):
    """``FlashTrain`` on CPU operands (the plain versions) against
    ``streaming_attention``'s autograd: o and every gradient within 2^-7
    of each value plus 1e-5 of the largest (each side rounds an
    f32-accurate value once to bf16); no kernel launches."""
    before = (ft.forward.launches, ft.backward_dq.launches,
              ft.backward_dkdv.launches)
    do = torch.randn(shape[:3] + (shape[4],),
                     generator=torch.Generator().manual_seed(3)
                     ).to(torch.bfloat16)
    s = shape[1]
    pos = torch.arange(s)
    outs = []
    for route in ("function", "streaming"):
        q, k, v = operands(*shape, seed=1)
        if route == "function":
            o = ft.attention(q, k, v, attn.q_scale(shape[3], q.dtype))
        else:
            o = attn.streaming_attention(q, k, v, pos, pos,
                                         torch.ones(s, dtype=torch.bool),
                                         causal=True)
        outs.append((o, *torch.autograd.grad(o, (q, k, v), do)))
    for got, ref in zip(*outs):
        got, ref = got.double(), ref.double()
        assert bool(((got - ref).abs() <= 2 ** -7 * ref.abs() +
                     1e-5 * ref.abs().max()).all())
    assert (ft.forward.launches, ft.backward_dq.launches,
            ft.backward_dkdv.launches) == before


@pytest.mark.parametrize("dims", [(128, 128), (192, 128)])
def test_the_function_on_the_cpu_matches_the_reference_gradients(dims):
    """``FlashTrain`` on CPU operands (the plain versions) against the
    JAX package's ``streaming_attention`` and its ``jax.vjp``, jitted, on
    the same bf16 q, k, v and dO at the training kernels' head widths
    (1 x 256 tokens, 2 heads): o and every gradient within 2^-7 of each
    value plus 1e-5 of the largest, that is within one bf16 step of the
    reference's (the step is 2^-7 of a power of two, less above it). The
    port rounds an f32-accurate value once to bf16; the reference's dq
    rounds twice (its cotangent reaches bf16 q through ``q * scale`` in
    bf16), about 2^-8 of each value from float64. A P rounded to one
    bf16 in the forward misses by 20-60 times the limit. The reference's
    v is as wide as its q, so latent
    attention's 128-wide v and dO enter it padded with zeros to 192: the
    padding adds nothing to o's first 128 columns or to any gradient."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.models import attention as r_attn
    d_qk, d_v = dims
    s = 256
    q, k, v = operands(1, s, 2, d_qk, d_v, seed=5)
    do = torch.randn(v.shape, generator=torch.Generator().manual_seed(6)
                     ).to(torch.bfloat16)
    o = ft.attention(q, k, v, attn.q_scale(d_qk, q.dtype))
    got = (o, *torch.autograd.grad(o, (q, k, v), do))

    def to_jax(t, width):
        a = t.detach().float().numpy()
        a = np.pad(a, [(0, 0)] * 3 + [(0, width - a.shape[-1])])
        return jnp.asarray(a, dtype=jnp.bfloat16)

    pos = jnp.arange(s)

    def reference(qj, kj, vj, doj):
        o, vjp = jax.vjp(lambda a, b, c: r_attn.streaming_attention(
            a, b, c, pos, pos, jnp.ones(s, bool), causal=True), qj, kj, vj)
        return (o, *vjp(doj))

    ref = jax.jit(reference)(to_jax(q, d_qk), to_jax(k, d_qk),
                             to_jax(v, d_qk), to_jax(do, d_qk))
    ref = [torch.from_numpy(np.asarray(r, dtype=np.float32)).double()
           for r in ref]
    ref[0], ref[3] = ref[0][..., :d_v], ref[3][..., :d_v]
    for name, a, r in zip(("o", "dq", "dk", "dv"), got, ref):
        a = a.double()
        assert a.shape == r.shape, name
        assert bool(((a - r).abs() <= 2 ** -7 * r.abs() +
                     1e-5 * r.abs().max()).all()), name
