"""The model cells that the benchmark gained with latent attention:
``deepseek-moe-16b.prefill`` (driver ``serve_prefill``) and
``moonlight-16b-a3b.train-8k`` (driver ``train_step_mla``). Each loads
from its files alone; each runs on the CPU at a tiny size, its look for
a card skipped, and reads correct when sound and not correct with its
control's arithmetic or a fault planted underneath; the new yardstick
counts are pinned by values worked by hand; the new references hold to
float64 and to ``moe_lm``'s."""
from __future__ import annotations

import json
import math

import pytest
import torch

from portbench import control_models as cm
from portbench import inputs
from portbench.harness import HERE, ROOT, Context, load_cell, load_module
from portbench.metrics import _yardstick_models as M
from portbench.reference import mla_moe_lm, moe_lm, moe_prefill
from portbench.tests.tiny import run_tiny
from portbench.tests.tiny_models import TINY, tiny_model_root

PREFILL, TRAIN = "deepseek-moe-16b.prefill", "moonlight-16b-a3b.train-8k"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_model_root(tmp_path_factory.mktemp("portbench_models"))


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# -- the cells from their files ------------------------------------------------

def test_both_cells_load_from_their_files_alone():
    pre, mla = load_cell(PREFILL), load_cell(TRAIN)
    assert pre.chips == mla.chips == 1
    assert pre.traffic["driver"] == "serve_prefill"
    assert (pre.traffic["batch"], pre.traffic["seq"],
            pre.traffic["t_max"]) == (4, 1024, 1024)
    assert pre.config["name"] == "deepseek-moe-16b"
    assert mla.traffic["driver"] == "train_step_mla"
    assert (mla.traffic["batch"], mla.traffic["seq"]) == (1, 8192)
    assert mla.config["num_hidden_layers"] == 5
    assert {m["name"] for m in pre.end_to_end} == {"tokens_per_s",
                                                   "setup_s"}
    assert {m["name"] for m in pre.per_layer} == {
        "flash_bf16_roofline", "prefill.mfu", "device_idle_pct.prefill"}
    assert {m["name"] for m in mla.per_layer} == {
        "model.fwd_bwd_ms", "train.opt_ms", "device_idle_pct.train",
        "mla.fwd_ms", "moe.load_imbalance", "train_mla.mfu"}
    for cell in (pre, mla):
        assert (HERE / "drivers" / f"{cell.traffic['driver']}.py").is_file()


def test_the_moonlight_file_holds_the_published_config():
    """Every key of the published config.json as published, but the one
    cut under ``reduced``; the sizes set by hand under ``assumed``."""
    c = load_cell(TRAIN).config
    published = {
        "attention_bias": False, "ep_size": 1, "first_k_dense_replace": 1,
        "hidden_act": "silu", "hidden_size": 2048,
        "intermediate_size": 11264, "kv_lora_rank": 512,
        "max_position_embeddings": 8192, "model_type": "deepseek_v3",
        "moe_intermediate_size": 1408, "moe_layer_freq": 1, "n_group": 1,
        "n_routed_experts": 64, "n_shared_experts": 2,
        "norm_topk_prob": True, "num_attention_heads": 16,
        "num_experts_per_tok": 6, "num_hidden_layers": 27,
        "num_key_value_heads": 16, "num_nextn_predict_layers": 0,
        "q_lora_rank": None, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
        "rms_norm_eps": 1e-05, "rope_theta": 50000,
        "routed_scaling_factor": 2.446, "scoring_func": "sigmoid",
        "seq_aux": True, "tie_word_embeddings": False, "topk_group": 1,
        "topk_method": "noaux_tc", "v_head_dim": 128, "vocab_size": 163840}
    changed = {k for k, v in published.items() if c[k] != v}
    assert changed == set(c["reduced"]) == {"num_hidden_layers"}
    assert c["published"] == {"num_hidden_layers": 27}
    for key in ("aux_loss_alpha", "bias_update_rate", "capacity_factor",
                "z_loss", "rope_layout", "init", "optimizer"):
        assert key in c["assumed"]
    entry = next(x for x in BENCH["configs"] if x["name"] ==
                 "moonlight-16b-a3b")
    assert entry["source"] == ("https://huggingface.co/moonshotai/"
                               "Moonlight-16B-A3B/blob/main/config.json")


def test_new_metric_readers_find_nothing_in_an_old_record():
    """Run over a checkout whose program lacks what they read, each new
    reader returns None rather than raising."""
    old = {"steps": 3, "window_s": 1.0, "tokens": 12, "batch": 1, "seq": 4,
           "parts": {"fwd_bwd": [], "opt": []}}
    for name in ("flash_bf16_roofline", "prefill.mfu",
                 "device_idle_pct.prefill", "mla.fwd_ms",
                 "moe.load_imbalance", "train_mla.mfu"):
        reader = load_module(HERE / "metrics" / f"{name}.py", f"m_{name}")
        assert reader.read(old) is None, name


# -- the yardstick, worked by hand ------------------------------------------------

def test_flash_counts_by_hand():
    # deepseek-moe-16b's prefill: 4 x 1,024 tokens, 16 heads of 128.
    # Bytes: 2 (bf16) x 4 x 1,024 x 128 x (2 x 16 + 2 x 16) = 67,108,864.
    assert M.flash_bytes(4, 16, 16, 1024, 128) == 67_108_864
    # FLOPs: 2 x 4 x 16 x 1,024^2 x 128 = 17,179,869,184.
    assert M.flash_flops(4, 16, 1024, 128) == 17_179_869_184
    # 67.1 MB at 3.35 TB/s is 20.03 us, over 17.18 GFLOP at 989 TFLOP/s
    # (17.37 us): bytes bound it.
    from portbench.metrics import _yardstick as Y
    assert Y.bound_s(67_108_864, 17_179_869_184, Y.BF16_FLOPS) == \
        pytest.approx(67_108_864 / 3.35e12)


def test_prefill_flops_by_hand():
    c = {"layers": 4, "d_model": 2048, "heads": 16, "kv_heads": 16,
         "head_dim": 128, "vocab": 102400, "d_expert": 1408, "experts": 64,
         "top_k": 6, "shared": 2}
    # A layer's active parameters: 2 norms 4,096, attention 4 x 2,048^2
    # = 16,777,216, 8 SwiGLU experts (6 routed + 2 shared) 8 x 3 x 2,048
    # x 1,408 = 69,206,016, router 131,072: 86,118,400; four 344,473,600.
    layers = 4 * (4096 + 16_777_216 + 69_206_016 + 131_072)
    assert layers == 344_473_600
    # 2 N D over 4,096 tokens, the head 2 x 4 x 2,048 x 102,400 and four
    # layers' causal attention 4 x 2 x 4 x 16 x 1,024^2 x 128.
    want = 2 * layers * 4096 + 2 * 4 * 2048 * 102400 + \
        4 * 2 * 4 * 16 * 1024 ** 2 * 128
    assert M.prefill_flops(c, 4, 1024) == want == 2_892_324_929_536


def test_moonlight_counts_by_hand():
    c = {"layers": 5, "dense": 1, "d_model": 2048, "heads": 16,
         "q_nope": 128, "q_rope": 64, "v_dim": 128, "kv_rank": 512,
         "d_ff": 11264, "vocab": 163840, "d_expert": 1408, "experts": 64,
         "top_k": 6, "shared": 2}
    # Attention: wq 2,048 x 16 x 192 = 6,291,456; wkva 2,048 x 576 =
    # 1,179,648; its norm 512; wkvb 512 x 16 x 256 = 2,097,152; wo 16 x
    # 128 x 2,048 = 4,194,304: 13,763,072.
    attn = 6_291_456 + 1_179_648 + 512 + 2_097_152 + 4_194_304
    assert attn == 13_763_072
    dense = 4096 + attn + 3 * 2048 * 11264                  # 82,973,184
    moe = 4096 + attn + 66 * 3 * 2048 * 1408 + 2048 * 64    # 584,847,872
    table = 163840 * 2048                                   # 335,544,320
    total = 2 * table + dense + 4 * moe + 2048
    inactive = 4 * 58 * 3 * 2048 * 1408
    assert (dense, moe) == (82_973_184, 584_847_872)
    assert M.mla_param_counts(c) == (total, total - inactive)
    assert total == 3_093_455_360 and total - inactive == 1_086_480_896
    # 6 N D over 8,192 tokens and 6 x 5 x (8,192^2 / 2) x 16 x 320 of
    # attention.
    assert M.mla_train_flops(c, 1, 8192) == \
        6 * 1_086_480_896 * 8192 + 6 * 5 * 8192 ** 2 / 2 * 16 * 320


def test_port_counts_the_parameters_the_yardstick_counts():
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("moonlight-16b-a3b"), n_layers=5)
    total, active = M.mla_param_counts(mla_moe_lm.sizes(
        load_cell(TRAIN).config) | {"dense": 1})
    assert cfg.param_count() == total
    assert cfg.active_param_count() == active


# -- the references ---------------------------------------------------------------

def _mla_small():
    c = {**load_cell(TRAIN).config, **TINY["moonlight-16b-a3b"]}
    s = mla_moe_lm.sizes(c)
    shapes = mla_moe_lm.leaf_shapes(s)
    return s, shapes, mla_moe_lm.leaf_scales(shapes)


def test_position_gaps_read_each_position_and_infinite_where_not_finite():
    drv = load_module(HERE / "drivers" / "serve_prefill.py", "drv_gaps")
    want = [torch.ones(2, 3, 4)]
    got = [torch.ones(2, 3, 4)]
    got[0][1, 2] = 3.0                       # one position off by 2 x
    gaps = drv.position_gaps(got, want)
    assert gaps.tolist() == [0, 0, 0, 0, 0, 2.0]
    got[0][0, 0, 0] = math.nan
    assert drv.position_gaps(got, want)[0] == math.inf
    assert drv.position_gaps([torch.ones(2, 4)], want)[0] == math.inf
    two = drv.position_gaps(got + [torch.ones(1, 4)],
                            want + [torch.ones(1, 4)])
    assert two.shape == (7,) and two[-1] == 0
    one = [torch.ones(2, 4)]
    r = drv.readings({"logits": got, "last": one,
                      "decode": [torch.ones(2, 1, 4)]},
                     {"logits": want, "last": one,
                      "decode": [torch.ones(2, 1, 4)]})
    assert r == {"logit_gap": math.inf, "last_gap": 0.0, "decode_gap": 0.0}


def test_decode_gap_reads_a_slot_whose_tokens_are_all_off():
    """Two batches of 2 slots x 4 decoded tokens: a slot with one token
    off in four reads 0 (its lower quartile), a slot whose every token is
    off reads that gap, the other slots 0 all the same."""
    drv = load_module(HERE / "drivers" / "serve_prefill.py", "drv_slots")
    want = [torch.ones(2, 4, 3), torch.ones(2, 4, 3)]
    got = [w.clone() for w in want]
    got[0][0, 2] = 2.0                       # slot 0: one token in eight
    gaps = drv.slot_gaps(got, want)
    assert gaps.shape == (2, 8) and gaps[0, 2] == 1.0 and gaps.sum() == 1
    r = drv.readings({"logits": want, "last": [w[:, 0] for w in want],
                      "decode": got},
                     {"logits": want, "last": [w[:, 0] for w in want],
                      "decode": want})
    assert r["decode_gap"] == 0.0
    for g in got:
        g[1] = 1.5                           # slot 1: every token
    r = drv.readings({"logits": want, "last": [w[:, 0] for w in want],
                      "decode": got},
                     {"logits": want, "last": [w[:, 0] for w in want],
                      "decode": want})
    assert r["decode_gap"] == pytest.approx(0.5)
    assert drv.slot_gaps(got[:1], want)[0, 0] == math.inf


def test_mla_reference_float32_against_float64():
    s, shapes, scales = _mla_small()
    _, p32 = inputs.draw_weights(shapes, scales, 5, "cpu")
    p64 = {k: v.double().requires_grad_(True) for k, v in p32.items()}
    p32 = {k: v.clone().requires_grad_(True) for k, v in p32.items()}
    b32 = mla_moe_lm.initial_biases(s, "cpu")
    b64 = {i: b.double() for i, b in b32.items()}
    batch = inputs.TokenStream(5, 2, 32, s["vocab"], "cpu").next()
    l32, _, loads32 = mla_moe_lm.loss(p32, b32, batch, s)
    l64, _, loads64 = mla_moe_lm.loss(p64, b64, batch, s)
    assert float(l32.detach()) == pytest.approx(float(l64.detach()),
                                                rel=1e-6)
    for i in loads32:
        assert torch.equal(loads32[i].double(), loads64[i])
    g32 = torch.autograd.grad(l32, list(p32.values()))
    g64 = torch.autograd.grad(l64, list(p64.values()))
    for a, b in zip(g32, g64):
        assert torch.allclose(a.double(), b, rtol=0,
                              atol=1e-4 * float(b.abs().max()) + 1e-12)


def test_mla_reference_heads_in_blocks_are_the_whole_softmax(monkeypatch):
    s, shapes, scales = _mla_small()
    _, params = inputs.draw_weights(shapes, scales, 2, "cpu")
    p = {k[len("decoder.1."):]: v for k, v in params.items()
         if k.startswith("decoder.1.")}
    h = torch.randn(2, 24, s["d_model"], generator=torch.Generator()
                    .manual_seed(1))
    blocked = mla_moe_lm.attention(p, h, s, "float32")
    monkeypatch.setattr(mla_moe_lm, "HEAD_BLOCK", s["heads"])
    assert torch.allclose(blocked, mla_moe_lm.attention(p, h, s, "float32"),
                          rtol=0, atol=1e-6)


def test_prefill_reference_is_moe_lms_forward():
    """At the prompt's own capacity ``moe_prefill.logits`` is the
    forward ``moe_lm.loss`` takes its logits from; a token after the
    prompt changes no earlier position."""
    c = {**load_cell(PREFILL).config,
         "num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
         "num_key_value_heads": 4, "moe_intermediate_size": 32,
         "n_routed_experts": 8, "num_experts_per_tok": 2,
         "n_shared_experts": 1, "vocab_size": 2048}
    s = moe_lm.sizes(c)
    shapes = moe_lm.leaf_shapes(s)
    _, params = inputs.draw_weights(shapes, moe_lm.leaf_scales(shapes), 3,
                                    "cpu")
    toks = inputs.TokenStream(3, 1, 40, s["vocab"], "cpu").next()["tokens"]
    got = moe_prefill.logits(params, toks[0], s, 40)
    x = params["embed.tokens"][toks]
    with torch.no_grad():
        for i in range(s["layers"]):
            pre = f"decoder.{i}."
            p = {k[len(pre):]: v for k, v in params.items()
                 if k.startswith(pre)}
            x, _ = moe_lm.layer(x, p, s, "float32")
        want = moe_lm.rmsnorm(x, params["final_norm"], s["eps"]) @ \
            params["embed.lm_head"]
    assert torch.allclose(got, want[0], rtol=0, atol=1e-5)
    longer = moe_prefill.logits(params, toks[0, :39], s, 30)
    assert torch.allclose(longer[:30], moe_prefill.logits(
        params, toks[0, :30], s, 30), rtol=0, atol=1e-5)


# -- the cells, sound and with faults, at a tiny size -----------------------------

@pytest.mark.parametrize("seed", [6, 7])
def test_prefill_cell_reads_correct_when_sound(root, seed):
    line = run_tiny(root, PREFILL, seed=seed, seconds=0.3, trace=seed == 7)
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == {"logit_gap", "last_gap", "decode_gap"}
    if seed == 7:
        assert set(line["metrics"]) == {"prefill.mfu"}    # no card trace
    else:
        assert set(line["metrics"]) == {"tokens_per_s", "setup_s"}


@pytest.mark.parametrize("fault", sorted(cm.PREFILL_FAULTS))
def test_prefill_cell_reads_not_correct_with_a_fault(root, fault):
    with cm.PREFILL_FAULTS[fault]():
        line = run_tiny(root, PREFILL, seed=6, seconds=0.3)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("seed", [6, 7])
def test_train_8k_cell_reads_correct_when_sound(root, seed):
    line = run_tiny(root, TRAIN, seed=seed, seconds=0.3, trace=seed == 7)
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == {"grad_median_gap", "change_norm_gap",
                                   "bias_gap"}
    if seed == 7:
        assert {"moe.load_imbalance", "train_mla.mfu"} <= \
            set(line["metrics"])
        assert line["metrics"]["moe.load_imbalance"]["value"] >= 1.0


@pytest.mark.parametrize("fault", sorted(cm.TRAIN_FAULTS))
def test_train_8k_cell_reads_not_correct_with_a_fault(root, fault):
    with cm.TRAIN_FAULTS[fault]():
        line = run_tiny(root, TRAIN, seed=6, seconds=0.3)
    assert line["correct"] is False, line["checks"]


def test_bias_gap_reads_a_bias_that_never_moves(root):
    """``bias_gap`` is compared: a bias that never moves reads 1 and one
    that moves against the loads about 2, both over the limit; a sound
    run reads under it, its signs off the reference's only where an
    expert's load lies within the loads' own gap of the mean."""
    c = load_cell(TRAIN, root)
    limit = c.traffic["bias_gap_limit"]
    got = cm.train_readings(Context(c, 6, 0.0, False, device="cpu",
                                    root=root), 6, "cpu",
                            faults={k: cm.TRAIN_FAULTS[k] for k in (
                                "stale_bias", "reversed_bias")})
    assert got["stale_bias"]["bias_gap"] == 1.0 > limit
    assert got["reversed_bias"]["bias_gap"] > 1.5
    assert got["program"]["bias_gap"] < limit
    look = got["bias_look"]
    assert look["signs"] == 3 * 2 * 8          # steps x MoE layers x experts
    assert max(look["flipped_distance"], default=0.0) <= \
        look["load_gap_quantiles"][1.0]


@pytest.mark.parametrize("cell", [PREFILL, TRAIN])
def test_controls_fail_the_limits(root, cell):
    """The reference in float8 against itself in float32, read by the
    cell's numbers: over at least one limit, on both seeds."""
    reader = {PREFILL: cm.prefill_readings, TRAIN: cm.train_readings}[cell]
    c = load_cell(cell, root)
    for seed in (6, 7):
        got = reader(Context(c, seed, 0.0, False, device="cpu", root=root),
                     seed, "cpu", faults={})
        t = c.traffic
        limited = {k: v for k, v in got["control"].items()
                   if f"{k}_limit" in t}
        assert limited and any(v > t[f"{k}_limit"]
                               for k, v in limited.items()), got
        assert all(v <= t[f"{k}_limit"] for k, v in got["program"].items()
                   if f"{k}_limit" in t), got


def test_the_mla_driver_refuses_what_the_port_cannot_run():
    from portbench.harness import HarnessError

    drv = load_module(HERE / "drivers" / "train_step_mla.py", "drv_refuse")
    c = dict(load_cell(TRAIN).config, scoring_func="softmax")
    with pytest.raises(HarnessError):
        drv.port_config(c)
