"""moonlight-16b-a3b (latent attention, a sigmoid router with a
balancing bias, a dense first layer) on the port against the plain
reference ``portbench/reference/mla_moe_lm.py``, on the CPU at the
reduced config, float32, on seeded random weights (every leaf drawn at
1 / sqrt(its fan-in), the reference's scales).

Tolerances: 2e-5 x max |reference| for logits and decode (float32
summation order; the port scales q by ``q_scale``, the reference by the
exact constant, which in float32 are equal), 1e-4 for each leaf's
gradient over its own largest entry, 1e-5 relative for the loss; the
bias is compared exactly (its steps are multiples of gamma).
"""
import dataclasses

import pytest
import torch

from portbench import inputs
from portbench.reference import mla_moe_lm as ref
from repro_torch.configs import ARCHS, PORT_ARCHS, get_config, get_reduced
from repro_torch.models import attention as attn
from repro_torch.models.model import LM
from repro_torch.optim.adamw import AdamW, warmup_cosine
from repro_torch.serve.engine import Engine
from repro_torch.train.step import make_train_step

ARCH = "moonlight-16b-a3b"
B, S, S0 = 2, 16, 12          # decode steps S0..S-1 after a prefill
OPT = {"peak_lr": 3e-3, "warmup": 20, "total": 200, "final_frac": 0.1,
       "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1, "clip": 1.0}


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def sizes(cfg) -> dict:
    """The reference's sizes of a port config (vocab padded as the
    port's)."""
    m, mc = cfg.mla, cfg.moe
    return {"layers": cfg.n_layers, "d_model": cfg.d_model,
            "heads": cfg.n_heads, "q_nope": m.qk_nope_head_dim,
            "q_rope": m.qk_rope_head_dim, "v_dim": m.v_head_dim,
            "kv_rank": m.kv_lora_rank, "d_ff": cfg.d_ff,
            "dense": cfg.first_k_dense, "vocab": 2048,
            "d_expert": mc.d_expert, "experts": mc.n_experts,
            "top_k": mc.top_k, "shared": mc.n_shared, "eps": cfg.rms_eps,
            "theta": cfg.rope_theta, "routed_scale": mc.routed_scale,
            "aux": mc.router_aux_weight, "bias_rate": mc.bias_rate,
            "capacity_factor": mc.capacity_factor, "z_loss": cfg.z_loss}


def build(seed: int = 3, bias: bool = True, **over):
    """(model, reference params, reference biases, sizes): one set of
    weights in both; with ``bias`` each router's bias drawn too (so that
    the choice by score plus bias differs from the choice by score)."""
    cfg = dataclasses.replace(get_reduced(ARCH), dtype="float32", **over)
    s = sizes(cfg)
    shapes = ref.leaf_shapes(s)
    _, params = inputs.draw_weights(shapes, ref.leaf_scales(shapes), seed,
                                    "cpu")
    model = LM(cfg, device="cpu")
    own = dict(model.named_parameters())
    assert {k: tuple(p.shape) for k, p in own.items()} == shapes
    biases = ref.initial_biases(s, "cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k, p in own.items():
            p.copy_(params[k])
        for i, p in zip(ref.moe_layers(s), model.routers()):
            if bias:
                biases[i].copy_(torch.randn(s["experts"], generator=g) * 0.1)
            p["router_bias"].copy_(biases[i])
    return model, params, biases, s


def batch(seed: int = 5, seq: int = S) -> dict:
    return inputs.TokenStream(seed, B, seq, 512, "cpu").next()


def rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def test_registry_keeps_the_jax_list_and_adds_moonlight():
    assert ARCH in PORT_ARCHS and ARCH not in ARCHS
    cfg = get_config(ARCH)
    assert cfg.n_layers == 27 and cfg.first_k_dense == 1
    assert cfg.mla.kv_lora_rank == 512 and cfg.mla.qk_head_dim == 192
    assert cfg.moe.scoring == "sigmoid" and cfg.moe.routed_scale == 2.446
    # 16B total, 3B active, as the name says; five layers as the cell.
    assert 15.9e9 < cfg.param_count() < 16.0e9
    assert 2.9e9 < cfg.active_param_count() < 3.0e9
    five = dataclasses.replace(cfg, n_layers=5)
    assert five.param_count() == pytest.approx(3.0935e9, rel=1e-4)
    assert five.active_param_count() == pytest.approx(1.0865e9, rel=1e-4)


def test_param_count_counts_mla_and_the_dense_layer():
    cfg = get_reduced(ARCH)
    model = LM(cfg, device="meta")
    padded = dataclasses.replace(cfg, vocab=model.cfg.vocab)
    assert padded.param_count() == model.n_params()
    assert model.n_params() == sum(p.numel() for p in model.parameters())


@pytest.mark.parametrize("bias", [False, True])
def test_logits_match_the_reference(bias):
    model, params, biases, s = build(bias=bias)
    toks = batch()["tokens"]
    with torch.no_grad():
        got = model(toks, attention="plain")
        want = ref.logits(params, biases, toks, s)
    assert rel(got, want) < 2e-5


def test_loss_and_every_gradient_match_the_reference():
    model, params, biases, s = build()
    b = batch()
    own = dict(model.named_parameters())
    for p in own.values():
        p.requires_grad_(True)
    total, metrics = model.loss(b, attention="plain")
    grads = torch.autograd.grad(total, list(own.values()))
    for p in params.values():
        p.requires_grad_(True)
    want, ce, _ = ref.loss(params, biases, b, s)
    want_grads = dict(zip(params, torch.autograd.grad(
        want, list(params.values()))))
    assert float(total.detach()) == pytest.approx(float(want.detach()),
                                                  rel=1e-5)
    assert float(metrics["ce"].detach()) == pytest.approx(
        float(ce.detach()), rel=1e-5)
    assert float(metrics["aux"].detach()) > 0
    for k, g in zip(own, grads):
        w = want_grads[k]
        assert float((g - w).abs().max()) <= \
            1e-4 * float(w.abs().max()) + 1e-12, k


def test_two_train_steps_and_the_bias_update_match_the_reference():
    model, params, biases, s = build(bias=False)
    opt = AdamW(learning_rate=warmup_cosine(OPT["peak_lr"], OPT["warmup"],
                                            OPT["total"], OPT["final_frac"]),
                b1=OPT["b1"], b2=OPT["b2"], eps=OPT["eps"],
                weight_decay=OPT["weight_decay"], grad_clip_norm=OPT["clip"])
    step = make_train_step(model, opt)
    own = dict(model.named_parameters())
    state = opt.init(own)
    batches = [batch(11), batch(12)]
    losses = []
    for b in batches:
        own, state, met = step(own, state, b)
        losses.append(float(met["loss"]))
    out = ref.train_steps(params, biases, batches, s, OPT)
    assert losses == pytest.approx(out["losses"], rel=1e-5)
    for k, p in own.items():
        assert float((p - params[k]).detach().abs().max()) <= \
            1e-5 * float(params[k].abs().max()), k
    moved = 0
    for i, p in zip(ref.moe_layers(s), model.routers()):
        assert torch.equal(p["router_bias"], biases[i])
        assert not p["router_load"].any()
        moved += int(p["router_bias"].ne(0).sum())
    assert moved > 0


def test_the_bias_is_state_not_a_parameter():
    model, _, _, _ = build(bias=False)
    names = set(dict(model.named_parameters()))
    assert not any("router_bias" in n or "router_load" in n for n in names)
    opt = AdamW(learning_rate=1e-2, weight_decay=0.5)
    state = opt.init(dict(model.named_parameters()))
    assert set(state["mu"]) == names
    step = make_train_step(model, opt)
    own = dict(model.named_parameters())
    own, state, _ = step(own, state, batch(4))
    gamma = model.cfg.moe.bias_rate
    for p in model.routers():
        b = p["router_bias"]
        assert not b.requires_grad
        # One step of +-gamma (or 0 for an expert at the mean load), no
        # decay and no AdamW update.
        assert torch.equal(b.abs() / gamma, (b.abs() / gamma).round())
        assert float(b.abs().max()) == pytest.approx(gamma)


def test_loads_are_counted_once_a_step_under_remat():
    model, _, _, s = build(bias=False)
    assert model.cfg.remat
    for p in model.parameters():
        p.requires_grad_(True)
    total, _ = model.loss(batch(6), attention="plain")
    total.backward()
    for p in model.routers():
        assert float(p["router_load"].sum()) == B * S * s["top_k"]
    with torch.no_grad():
        model.loss(batch(7), attention="plain")
    for p in model.routers():           # no count outside a train step
        assert float(p["router_load"].sum()) == B * S * s["top_k"]


def test_prefill_and_decode_through_the_latent_cache_match_the_forward():
    model, params, biases, s = build()
    toks = batch(9)["tokens"]
    last, caches = model.prefill(toks[:, :S0], t_max=S)
    assert set(caches[0]) == {"c", "kpe"}
    assert caches[0]["c"].shape == (B, S, s["kv_rank"])
    assert caches[0]["kpe"].shape == (B, S, s["q_rope"])
    got = [last[:, -1]]
    for pos in range(S0, S):
        out, caches = model.decode_step(toks[:, pos:pos + 1], pos, caches)
        got.append(out[:, -1])
    with torch.no_grad():
        want = ref.logits(params, biases, toks, s, prompt_len=S0)
    for i, g in enumerate(got[:-1]):
        assert rel(g, want[:, S0 - 1 + i]) < 2e-5, i
    assert rel(got[-1], want[:, S - 1]) < 2e-5


def test_absorbed_decode_matches_attention_over_the_widened_cache():
    """mla_decode reads the latent with wkvb absorbed; the same token
    attending over keys and values widened from that cache (k = c
    wkvb_k with the shared k_pe, v = c wkvb_v) gives the same output."""
    model, _, _, s = build()
    cfg, p = model.cfg, model.decoder[1]["mixer"]
    g = torch.Generator().manual_seed(2)
    x = torch.randn(B, S0, cfg.d_model, generator=g)
    _, c, k_pe = attn.mla_forward(p, x, cfg)
    cache_c = torch.zeros(B, S, s["kv_rank"])
    cache_kpe = torch.zeros(B, S, s["q_rope"])
    cache_c[:, :S0], cache_kpe[:, :S0] = c, k_pe
    xn = torch.randn(B, 1, cfg.d_model, generator=g)
    got = attn.mla_decode(p, xn, cfg, S0, cache_c, cache_kpe)
    m, h = cfg.mla, cfg.n_heads
    q_nope, q_pe, _, _ = attn._mla_project(
        p, xn, cfg, torch.tensor([S0]))
    kvb = torch.einsum("btr,rhk->bthk", cache_c[:, :S0 + 1], p["wkvb"])
    k = torch.cat([kvb[..., :m.qk_nope_head_dim], cache_kpe[:, :S0 + 1, None]
                   .expand(-1, -1, h, -1)], -1)
    v = kvb[..., m.qk_nope_head_dim:]
    q = torch.cat([q_nope, q_pe], -1)[:, 0]                   # (B, H, dqk)
    pr = torch.softmax(torch.einsum("bhk,bthk->bht", q, k) *
                       m.qk_head_dim ** -0.5, -1)
    o = torch.einsum("bht,bthv->bhv", pr, v)
    want = torch.einsum("bhv,hvd->bd", o, p["wo"])
    assert rel(got[:, 0], want) < 2e-5


def test_engine_serves_moonlight_through_the_latent_cache():
    model, _, _, _ = build()
    toks = batch(10)["tokens"][:, :S0]
    out = Engine(model, t_max=S).generate(toks, S - S0)
    assert out.shape == (B, S - S0)
    logits, _ = model.prefill(toks, t_max=S)
    assert torch.equal(out[:, 0], logits[:, -1].argmax(-1))


def test_bfloat16_forward_stays_near_the_reference():
    """In bfloat16 a router near a tie can choose another expert for one
    token, which moves that position alone: each position's gap over its
    largest reference logit, the median within a few bf16 ulps (3e-2)."""
    model, params, biases, s = build()
    model.cfg = dataclasses.replace(model.cfg, dtype="bfloat16")
    model.dtype = torch.bfloat16
    toks = batch()["tokens"]
    with torch.no_grad():
        got = model(toks, attention="plain").float()
        want = ref.logits(params, biases, toks, s)
    per_position = (got - want).abs().amax(-1) / want.abs().amax(-1)
    assert float(per_position.median()) < 3e-2
