"""The port's dense LM stack (``repro_torch.models``) against the JAX
package's (``repro.models``), run on the CPU through its XLA path, on
inputs drawn with numpy from fixed seeds; the JAX weights come across
through ``models/convert.py:params_from_jax``.

Tolerances, as max |port - reference|:
- float32: 2e-5 x max |reference| (about 1e-5: summation order and
  XLA's own exp/tanh; the port's prefill runs the kernel's plain
  version on the CPU, which scales q in float32);
- bfloat16: 3e-2 x max |reference| (a few bf16 ulps of the logits:
  both round each activation to bf16, at places that differ by one op;
  the kernel route scales q after the float32 cast where the reference
  rounds ``q * scale`` to bf16 first).
"""
import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as R_ARCHS  # noqa: E402
from repro.configs import get_config as r_get_config  # noqa: E402
from repro.configs import get_reduced as r_get_reduced  # noqa: E402
from repro.models import attention as r_attn  # noqa: E402
from repro.models import blocks as r_blocks  # noqa: E402
from repro.models import layers as r_layers  # noqa: E402
from repro.models.model import LM as RLM  # noqa: E402
from repro_torch.configs import ARCHS, get_config, get_reduced  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_k  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import params as prm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402

DENSE = ["smollm-360m", "granite-3-8b", "qwen2.5-32b", "nemotron-4-15b"]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
B, S, N_PRE = 2, 12, 9           # decode steps N_PRE..S-1 after a prefill


def close(got, ref, dtype="float32"):
    """max |got - ref| within the dtype's tolerance of max |ref|."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err <= TOL[dtype] * max(float(np.abs(ref).max()), 1e-30), err


def arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def both(a, dtype):
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


# -- configs -----------------------------------------------------------------

def _port_only(mine: dict, theirs: dict) -> dict:
    """The fields of a port config's ``asdict`` that the JAX package's
    lacks (latent attention, leading dense layers, the sigmoid router's),
    nested configs included, each with its value."""
    out = {}
    for k, v in mine.items():
        if k not in theirs:
            out[k] = v
        elif isinstance(v, dict) and isinstance(theirs[k], dict):
            out.update({f"{k}.{n}": w for n, w in
                        _port_only(v, theirs[k]).items()})
    return out


def _shared(mine: dict, theirs: dict) -> dict:
    """``mine`` without the fields that the JAX package's lacks."""
    return {k: _shared(v, theirs[k]) if isinstance(v, dict) and
            isinstance(theirs[k], dict) else v
            for k, v in mine.items() if k in theirs}


# The port's own fields at their defaults: every config of the JAX
# package's list leaves them so.
PORT_DEFAULTS = {"mla": None, "first_k_dense": 0, "moe.scoring": "softmax",
                 "moe.routed_scale": 1.0, "moe.bias_rate": 0.0}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_references(arch):
    """Every field of the JAX package's config equal; the fields only the
    port has (PORT_DEFAULTS) at their defaults."""
    assert ARCHS == R_ARCHS
    for mine, ref in ((get_config(arch), r_get_config(arch)),
                      (get_reduced(arch), r_get_reduced(arch))):
        m, r = dataclasses.asdict(mine), dataclasses.asdict(ref)
        assert _shared(m, r) == r
        extra = _port_only(m, r)
        assert extra == {k: v for k, v in PORT_DEFAULTS.items()
                         if k in extra}
        assert set(extra) - {"mla", "first_k_dense"} == (
            {k for k in PORT_DEFAULTS if k.startswith("moe.")}
            if mine.moe is not None else set())
        assert mine.param_count() == ref.param_count()
        assert mine.head_layout() == ref.head_layout()


# -- layers -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    x, scale = arrays(0, (2, 5, 16), (16,))
    (jx, tx), (js, ts) = both(x, dtype), both(scale, "float32")
    got = layers.rmsnorm(tx, ts, 1e-5)
    assert got.dtype == TDT[dtype]
    close(got, r_layers.rmsnorm(jx, js, 1e-5), dtype)


@pytest.mark.parametrize("dtype,theta", [("float32", 10_000.0),
                                         ("float32", 1_000_000.0),
                                         ("bfloat16", 10_000.0)])
def test_rope(dtype, theta):
    (x,) = arrays(1, (2, 7, 3, 16))
    jx, tx = both(x, dtype)
    pos = np.arange(7) + 3
    got = layers.rope(tx, torch.from_numpy(pos), theta)
    close(got, r_layers.rope(jx, jnp.asarray(pos), theta), dtype)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "relu2", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp(kind, dtype):
    x, wi, wg, wo = arrays(2, (2, 5, 16), (16, 32), (16, 32), (32, 16))
    p = {"wi": wi / 4, "wo": wo / 6}
    if kind in ("swiglu", "geglu"):
        p["wg"] = wg / 4
    got = layers.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                     both(x, dtype)[1], kind)
    ref = r_layers.mlp({k: jnp.asarray(v) for k, v in p.items()},
                       both(x, dtype)[0], kind)
    close(got, ref, dtype)


def test_embed_gathers_then_casts():
    table, = arrays(3, (64, 8))
    tok = np.array([[1, 5, 63], [0, 0, 7]])
    got = layers.embed_tokens({"tokens": torch.from_numpy(table)},
                              torch.from_numpy(tok), torch.bfloat16)
    ref = r_layers.embed_tokens({"tokens": jnp.asarray(table)},
                                jnp.asarray(tok), jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("tie", [False, True])
def test_logits_out(tie):
    cfg = dataclasses.replace(r_get_reduced("smollm-360m"),
                              tie_embeddings=tie, vocab=64, d_model=8)
    x, table, head = arrays(4, (2, 3, 8), (64, 8), (8, 64))
    p = {"tokens": table} if tie else {"tokens": table, "lm_head": head}
    got = layers.logits_out({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), cfg)
    close(got, r_layers.logits_out({k: jnp.asarray(v)
                                    for k, v in p.items()},
                                   jnp.asarray(x), cfg))


# -- attention ----------------------------------------------------------------

# (name, Sq, T, causal, window, softcap, some keys invalid, block_k)
STREAMING = [("causal", 9, 9, True, None, None, False, 4),
             ("windowed", 9, 9, True, 3, None, False, 4),
             ("softcap", 9, 9, True, None, 5.0, False, 1024),
             ("cross", 6, 11, False, None, None, True, 4)]


@pytest.mark.parametrize("case", STREAMING, ids=[c[0] for c in STREAMING])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streaming_attention(case, dtype):
    _, sq, t, causal, window, softcap, masked, block_k = case
    q, k, v = arrays(5, (2, sq, 4, 8), (2, t, 2, 8), (2, t, 2, 8))
    qpos, kpos = np.arange(sq) + (t - sq if causal else 0), np.arange(t)
    valid = np.arange(t) % 4 != 1 if masked else np.ones(t, bool)
    kw = dict(causal=causal, window=window, softcap=softcap,
              block_k=block_k)
    got = attn.streaming_attention(
        *(both(a, dtype)[1] for a in (q, k, v)), torch.from_numpy(qpos),
        torch.from_numpy(kpos), torch.from_numpy(valid), **kw)
    ref = r_attn.streaming_attention(
        *(both(a, dtype)[0] for a in (q, k, v)), jnp.asarray(qpos),
        jnp.asarray(kpos), jnp.asarray(valid), **kw)
    assert got.dtype == TDT[dtype]
    close(got, ref, dtype)


def test_attn_forward_cross_attention():
    """``memory=`` takes the streaming route, unmasked, over the memory's
    keys, with masked memory slots."""
    cfg = dataclasses.replace(r_get_reduced("granite-3-8b"), dtype="float32")
    x, mem, wq, wk, wv, wo = arrays(
        12, (2, 5, 64), (2, 7, 64), (64, 4, 16), (64, 2, 16), (64, 2, 16),
        (4, 16, 64))
    p = {"wq": wq / 8, "wk": wk / 8, "wv": wv / 8, "wo": wo / 8}
    valid = np.arange(7) != 3
    got = attn.attn_forward({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), get_reduced("granite-3-8b"),
                            None, memory=torch.from_numpy(mem),
                            memory_valid=torch.from_numpy(valid))
    ref = r_attn.attn_forward({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), cfg, jnp.arange(5),
                              memory=jnp.asarray(mem),
                              memory_valid=jnp.asarray(valid))
    close(got, ref)


@pytest.mark.parametrize("window,softcap", [(None, None), (4, None),
                                            (None, 5.0)])
def test_decode_attention(window, softcap):
    q, k, v = arrays(6, (2, 1, 4, 8), (2, 10, 2, 8), (2, 10, 2, 8))
    kw = dict(window=window, softcap=softcap)
    got = attn._decode_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), 6, torch.arange(10),
        **kw)
    ref = r_attn._decode_attention(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(6),
        jnp.arange(10), **kw)
    close(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_route_equals_streaming_route(dtype):
    """The kernel's route (here its plain version behind ``mha``'s
    padding, q head h reading kv head h // g) computes what the
    streaming softmax does, and launches nothing on the CPU."""
    cfg = get_reduced("qwen2.5-32b")                  # 5 q heads, 1 kv
    q, k, v = arrays(7, (2, 12, 5, 16), (2, 12, 1, 16), (2, 12, 1, 16))
    t = [both(a, dtype)[1] for a in (q, k, v)]
    before = fa_k.flash_attention.launches
    flash = attn.self_attention(*t, cfg, None, causal=True)
    plain = attn.self_attention(*t, cfg, None, causal=True,
                                attention="plain")
    assert fa_k.flash_attention.launches == before
    assert flash.shape == plain.shape == (2, 12, 5, 16)
    close(flash, plain.float().numpy(), dtype)
    with pytest.raises(ValueError):
        attn.self_attention(*t, cfg, None, causal=True, attention="sdpa")


def test_flash_route_reads_kv_head_h_over_g():
    """q head h attends with stored kv head h // g: zeroing the values
    of kv head 1 zeroes exactly q heads g..2g-1."""
    cfg = get_reduced("granite-3-8b")                 # 4 q heads, 2 kv
    q, k, v = (torch.from_numpy(a) for a in arrays(
        8, (1, 6, 4, 16), (1, 6, 2, 16), (1, 6, 2, 16)))
    v[:, :, 1] = 0
    o = attn.flash_attention(q, k, v)
    assert o[:, :, 2:].abs().max() == 0 and o[:, :, :2].abs().min() > 0


# -- parameters ------------------------------------------------------------------

def test_init_draws_each_spec_at_its_std():
    cfg = dataclasses.replace(get_reduced("qwen2.5-32b"), d_ff=1024)
    m = LM(cfg, device="cpu", seed=3)
    # fan_in is shape[-2]: wq (d, hq, dh) is drawn at 1/sqrt(hq).
    assert prm.std(attn.attention_specs(m.cfg)["wq"]) == 1 / math.sqrt(5)
    assert prm.std(layers.embed_specs(m.cfg)["tokens"]) == 1.0
    for path, spec in prm.leaves(m.layer_specs()):
        w = m.get_parameter(path).double()
        if spec.init != "normal":
            assert float(w.min()) == float(w.max()) == \
                (0.0 if spec.init == "zeros" else 1.0), path
            continue
        n = w.numel()
        want = prm.std(spec)
        assert abs(float(w.std()) / want - 1) < 5 / math.sqrt(2 * n), path
        assert abs(float(w.mean())) < 5 * want / math.sqrt(n), path
    other = LM(cfg, device="cpu", seed=4)
    assert not torch.equal(m.embed.tokens, other.embed.tokens)
    again = LM(cfg, device="cpu", seed=3)
    assert torch.equal(m.decoder[1].mlp.wo, again.decoder[1].mlp.wo)


@pytest.mark.parametrize("arch", DENSE)
def test_param_counts_are_the_references(arch):
    cfg = get_reduced(arch)
    m = LM(cfg, device="cpu")
    assert m.n_params() == RLM(r_get_reduced(arch)).n_params() == \
        sum(p.numel() for p in m.parameters())


@functools.lru_cache(maxsize=None)
def jax_model(arch, dtype, head_pad_to=1):
    cfg = dataclasses.replace(r_get_reduced(arch), dtype=dtype,
                              head_pad_to=head_pad_to)
    m = RLM(cfg)
    return m, m.init(jax.random.PRNGKey(0))


def port_model(arch, dtype, head_pad_to=1):
    jm, jp = jax_model(arch, dtype, head_pad_to)
    cfg = dataclasses.replace(get_reduced(arch), dtype=dtype,
                              head_pad_to=head_pad_to)
    m = LM(cfg, device="cpu", seed=1)
    m.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), m))
    return m


def test_params_from_jax_fails_on_a_misshaped_or_unmatched_tree():
    _, jp = jax_model("qwen2.5-32b", "float32")
    tree = jax.tree.map(np.asarray, jp)
    m = port_model("qwen2.5-32b", "float32")
    assert torch.equal(m.decoder[1].mixer.wq,
                       torch.tensor(tree["decoder"]["0"]["mixer"]["wq"][1]))
    bad = jax.tree.map(lambda a: a, tree)
    bad["decoder"]["0"]["mixer"]["wq"] = tree["decoder"]["0"]["mixer"][
        "wq"][:, :, :4]
    with pytest.raises(ValueError, match="wq"):
        params_from_jax(bad, m)
    bad = jax.tree.map(lambda a: a, tree)
    bad["decoder"]["0"]["mlp"]["wi"] = tree["decoder"]["0"]["mlp"]["wi"][:1]
    with pytest.raises(ValueError, match="stacked periods"):
        params_from_jax(bad, m)
    bad = jax.tree.map(lambda a: a, tree)
    bad["embed"]["extra"] = tree["final_norm"]
    with pytest.raises(KeyError, match="extra"):
        params_from_jax(bad, m)
    bad = jax.tree.map(lambda a: a, tree)
    del bad["decoder"]["0"]["mixer"]["bq"]
    with pytest.raises(KeyError, match="bq"):
        params_from_jax(bad, m)


# -- blocks and the model ---------------------------------------------------------

@pytest.mark.parametrize("route", ["flash", "plain"])
def test_block_prefill_output_and_cache(route):
    jm, jp = jax_model("qwen2.5-32b", "float32")
    cfg = jm.cfg
    pj = jax.tree.map(lambda a: a[0], jp["decoder"]["0"])
    m = port_model("qwen2.5-32b", "float32")
    (x,) = arrays(9, (B, S, cfg.d_model))
    desc = blocks.LayerDesc(kind="attn")
    yr, _, cr = r_blocks.block_prefill(pj, jnp.asarray(x), cfg,
                                       r_blocks.LayerDesc(kind="attn"),
                                       jnp.arange(S), 16)
    with torch.inference_mode():
        yt, _, ct = blocks.block_prefill(
            m.decoder[0], torch.from_numpy(x), m.cfg, desc,
            None if route == "flash" else torch.arange(S), 16,
            attention=route)
    close(yt, yr)
    for name in ("k", "v"):
        assert ct[name].shape == (B, 16, 1, cfg.head_dim)
        close(ct[name], cr[name])


@functools.lru_cache(maxsize=None)
def lm_outputs(arch, dtype, head_pad_to=1):
    """Logits of forward, prefill and three decode steps, for the JAX
    model and the port on its weights."""
    jm, jp = jax_model(arch, dtype, head_pad_to)
    m = port_model(arch, dtype, head_pad_to)
    tok = np.random.default_rng(10).integers(0, jm.vocab_real, (B, S))
    ref = {"forward": jm.forward(jp, {"tokens": jnp.asarray(tok)})[0]}
    got = {"forward": m(torch.from_numpy(tok))}
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(tok[:, :N_PRE])}, S + 4)
    lt, ct = m.prefill(torch.from_numpy(tok[:, :N_PRE]), S + 4)
    ref["prefill"], got["prefill"] = lj, lt
    dj, dt = [], []
    for i in range(N_PRE, S):
        lj, cj = jm.decode_step(jp, jnp.asarray(tok[:, i:i + 1]),
                                jnp.asarray(i), cj)
        lt, ct = m.decode_step(torch.from_numpy(tok[:, i:i + 1]), i, ct)
        dj.append(lj)
        dt.append(lt)
    ref["decode_step"] = jnp.concatenate(dj, axis=1)
    got["decode_step"] = torch.cat(dt, dim=1)
    return ref, got


@pytest.mark.parametrize("what", ["forward", "prefill", "decode_step"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_lm_logits_match_reference(arch, dtype, what):
    ref, got = lm_outputs(arch, dtype)
    assert got[what].dtype == TDT[dtype]
    close(got[what], ref[what], dtype)
    assert bool(torch.isfinite(got[what]).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward(arch, dtype):
    """The port's decode (plain one-query attention) against its own
    forward (the kernel's route): within the dtype's tolerance, not
    bit for bit as in the reference (tests/test_models.py:53-75),
    since the two attention routes sum in different orders."""
    _, got = lm_outputs(arch, dtype)
    fwd = got["forward"].float().numpy()
    close(got["prefill"], fwd[:, N_PRE - 1:N_PRE], dtype)
    close(got["decode_step"], fwd[:, N_PRE:], dtype)


@pytest.mark.parametrize("what", ["forward", "prefill", "decode_step"])
def test_padded_head_layout_matches_reference(what):
    """qwen reduced with head_pad_to=2: 2 stored kv heads (duplicated),
    6 q-head slots of which one is a masked dummy."""
    assert dataclasses.replace(get_reduced("qwen2.5-32b"),
                               head_pad_to=2).head_layout() == (2, 3, 6)
    ref, got = lm_outputs("qwen2.5-32b", "float32", head_pad_to=2)
    close(got[what], ref[what])


def test_padded_layout_equals_unpadded_with_mapped_weights():
    """Padded and unpadded layouts agree when each slot carries its real
    head's weights (the reference's test_head_padding_layout_exact)."""
    m0 = port_model("qwen2.5-32b", "float32")
    cfg1 = dataclasses.replace(get_reduced("qwen2.5-32b"), dtype="float32",
                               head_pad_to=2)
    m1 = LM(cfg1, device="cpu", seed=5)
    s2r = attn.slot_to_real(m1.cfg)
    state = {}
    for name, w in m1.state_dict().items():
        src = m0.state_dict()[name]
        if w.shape == src.shape:
            state[name] = src
            continue
        new = torch.zeros_like(w)
        for slot, real in enumerate(s2r):
            if real is None:
                continue
            if name.endswith((".wq", ".bq")):
                new[..., slot, :] = src[..., real, :]
            else:                                             # wo
                new[slot] = src[real]
        state[name] = new
    m1.load_state_dict(state)
    tok = torch.from_numpy(np.random.default_rng(11).integers(0, 512, (B, S)))
    np.testing.assert_allclose(m1(tok).numpy(), m0(tok).numpy(), rtol=0,
                               atol=1e-5)
