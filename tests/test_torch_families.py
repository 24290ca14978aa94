"""The port's non-dense families against the JAX package's on the CPU:
the MoE MLP (``models/moe.py``), Mamba (``models/mamba.py``), RWKV-6
(``models/rwkv6.py``) and the whole ``LM`` of rwkv6-3b, deepseek-moe-16b,
moonshot-v1-16b-a3b, jamba-v0.1-52b, whisper-tiny and internvl2-2b at
their reduced configs (S <= 16, batch 2).

Weights are drawn with numpy from a seed over the reference's spec tree,
every leaf random (``tests/_numpy_weights.py``: no term of the mixers'
algebra is hidden by a zero init), and carried to the port with
``models/convert.py:params_from_jax``; frontends and activations are
numpy normals.

Tolerances, as max |port - reference|:
- float32: 2e-5 x max |reference| (the dense family's bound:
  summation order and XLA's own exp/tanh/softplus);
- bfloat16, one module on the same inputs: 3e-2 x max |reference| (a
  few bf16 ulps);
- bfloat16, the whole model: max(3e-2, the reference's own bf16
  distance from its float32 output) x max |reference float32|. Under
  the reference's init the attention scores of these configs have std
  ~16, so attention is near one-hot and a rounding in layer 1 can move a
  later layer's argmax: the reference's own bf16 logits lie 0.16-0.31
  of max |logit| from its float32 ones at whisper, jamba and internvl2
  (1.9e-2 to 6.3e-2 at rwkv6 and deepseek), and the port's bf16 is held
  to be no further from the reference's than that. The MoE configs'
  routing flips (a token whose expert set differs between the two bf16
  runs) are counted and reported; in float32 they must be none.
"""
import contextlib
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _numpy_weights  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.moe as r_moe  # noqa: E402
from repro.configs import get_reduced as r_get_reduced  # noqa: E402
from repro.models import mamba as r_mam  # noqa: E402
from repro.models import rwkv6 as r_rwk  # noqa: E402
from repro.models.blocks import init_cache as r_init_cache  # noqa: E402
from repro.models.model import LM as RLM  # noqa: E402
from repro.models.params import Spec as RSpec  # noqa: E402
import repro_torch.models.moe as moe  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import mamba, rwkv6  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402

FAMILIES = ["rwkv6-3b", "deepseek-moe-16b", "moonshot-v1-16b-a3b",
            "jamba-v0.1-52b", "whisper-tiny", "internvl2-2b"]
MOE = ["deepseek-moe-16b", "moonshot-v1-16b-a3b", "jamba-v0.1-52b"]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
B, S, N_PRE = 2, 12, 9           # decode steps N_PRE..S-1 after a prefill


def npf(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def rel(got, ref, scale=None) -> float:
    got, ref = npf(got), npf(ref)
    assert got.shape == ref.shape
    scale = float(np.abs(ref).max()) if scale is None else scale
    return float(np.abs(got - ref).max()) / max(scale, 1e-30)


def close(got, ref, dtype="float32"):
    err = rel(got, ref)
    assert err <= TOL[dtype], err


def numpy_tree(specs, seed: int):
    return _numpy_weights.numpy_tree(specs, seed, RSpec)


def to_torch(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: to_torch(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree)).to(dtype)


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def both(a, dtype):
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# -- MoE ------------------------------------------------------------------------

def moe_case(case: str):
    """(config, x, capacity override) of one MoE case, float32."""
    arch = "jamba-v0.1-52b" if case == "no_shared" else "deepseek-moe-16b"
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    if case in ("drops", "ties", "no_shared"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=1.0))
    s = 1 if case == "decode" else 16
    return cfg, normal(5, B, s, cfg.d_model), (B if case == "decode"
                                               else None)


def moe_params(cfg, case: str):
    tree = numpy_tree(r_moe.moe_specs(cfg), 6)
    if case == "ties":
        # Experts 1-3 share a router column, and so do 4-6: their
        # probabilities tie exactly, and top-2 must take the lowest of a
        # tied group, which decides the slots and the drops.
        tree["router"][:, 2:4] = tree["router"][:, 1:2]
        tree["router"][:, 5:7] = tree["router"][:, 4:5]
    return tree


MOE_CASES = ["no_drops", "drops", "ties", "no_shared", "decode"]


@pytest.mark.parametrize("case", MOE_CASES)
@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_moe_mlp_matches_reference(dispatch, case):
    cfg, x, cap = moe_case(case)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch=dispatch))
    tree = moe_params(cfg, case)
    yr, ar = r_moe.moe_mlp(to_jax(tree), jnp.asarray(x), cfg, capacity=cap)
    yt, at = moe.moe_mlp(to_torch(tree), torch.from_numpy(x), cfg,
                         capacity=cap)
    close(yt, yr)
    assert abs(float(at) - float(ar)) <= 1e-5 * abs(float(ar))


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_routing_and_drops_are_the_references(case):
    """The same experts in the same order, the same slots and the same
    drops; the drop cases drop, the others do not."""
    cfg, x, cap = moe_case(case)
    tree = moe_params(cfg, case)
    logits = x @ tree["router"]
    wr, er, _ = r_moe._routing(jnp.asarray(logits), cfg.moe)
    wt, et, _ = moe._routing(torch.from_numpy(logits), cfg.moe)
    np.testing.assert_array_equal(et.numpy(), np.asarray(er))
    close(wt, wr)
    c = r_moe._capacity(x.shape[1], cfg.moe, cap)
    assert moe._capacity(x.shape[1], cfg.moe, cap) == c
    pr, kr = r_moe._positions(er, cfg.moe.n_experts, c)
    pt, kt = moe._positions(et, cfg.moe.n_experts, c)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pr))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kr))
    assert bool((~kt).any()) == (case in ("drops", "ties", "no_shared"))
    if case == "ties":
        # The highest of a tied group is never taken, its middle one only
        # beside its lowest.
        chosen = [set(t) for t in et.reshape(-1, 2).tolist()]
        assert not any({3, 6} & c for c in chosen)
        assert all(c >= {1, 2} or 2 not in c for c in chosen)
        assert all(c >= {4, 5} or 5 not in c for c in chosen)
        assert any(len(c & {1, 2, 3}) == 1 for c in chosen)


def test_top_k_puts_the_lower_index_first_among_ties():
    p = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = moe.top_k(p, 3)
    assert idx.tolist() == [[1, 2, 3], [0, 1, 2]]
    _, jidx = jax.lax.top_k(jnp.asarray(p.numpy()), 3)
    assert idx.tolist() == np.asarray(jidx).tolist()


# -- Mamba and RWKV-6 -------------------------------------------------------------

def run_recurrent(forward, decode, p, x, cfg, n_pre, **kw):
    """forward over x[:, :n_pre] from zeros, then one decode step per
    remaining token: (y, decode outputs, final state)."""
    y, st = forward(p, x[:, :n_pre], cfg, **kw)
    outs = []
    for t in range(n_pre, x.shape[1]):
        o, st = decode(p, x[:, t:t + 1], cfg, st)
        outs.append(o)
    return y, outs, st


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_forward_and_decode_match_reference(dtype):
    cfg = dataclasses.replace(get_reduced("jamba-v0.1-52b"), dtype=dtype)
    tree = numpy_tree(r_mam.mamba_specs(cfg), 7)
    xj, xt = both(normal(8, B, S, cfg.d_model), dtype)
    ref = run_recurrent(r_mam.mamba_forward, r_mam.mamba_decode,
                        to_jax(tree), xj, cfg, N_PRE)
    with torch.inference_mode():
        got = run_recurrent(mamba.mamba_forward, mamba.mamba_decode,
                            to_torch(tree), xt, cfg, N_PRE)
    close(got[0], ref[0], dtype)
    for g, r in zip(got[1], ref[1]):
        close(g, r, dtype)
    assert got[2][0].dtype == TDT[dtype] and got[2][1].dtype == torch.float32
    for g, r in zip(got[2], ref[2]):
        close(g, r, dtype)


@pytest.mark.parametrize("chunk", [None, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_forward_and_decode_match_reference(dtype, chunk):
    cfg = dataclasses.replace(get_reduced("rwkv6-3b"), dtype=dtype)
    tree = numpy_tree(r_rwk.rwkv_specs(cfg), 9)
    xj, xt = both(normal(10, B, S, cfg.d_model), dtype)
    ref = run_recurrent(r_rwk.rwkv_forward, r_rwk.rwkv_decode,
                        to_jax(tree), xj, cfg, N_PRE, chunk=chunk)
    with torch.inference_mode():
        got = run_recurrent(rwkv6.rwkv_forward, rwkv6.rwkv_decode,
                            to_torch(tree), xt, cfg, N_PRE, chunk=chunk)
    close(got[0], ref[0], dtype)
    for g, r in zip(got[1], ref[1]):
        close(g, r, dtype)
    assert got[2][0].dtype == TDT[dtype] and got[2][1].dtype == torch.float32
    for g, r in zip(got[2], ref[2]):
        close(g, r, dtype)


def test_rwkv_readout_divides_by_n():
    """The per-head norm uses the population variance (jnp.var)."""
    cfg = dataclasses.replace(get_reduced("rwkv6-3b"), dtype="float32")
    tree = numpy_tree(r_rwk.rwkv_specs(cfg), 11)
    h, n = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    y, g = normal(12, B, 3, h, n), normal(13, B, 3, cfg.d_model)
    close(rwkv6._readout(to_torch(tree), torch.from_numpy(y),
                         torch.from_numpy(g), cfg),
          r_rwk._readout(to_jax(tree), jnp.asarray(y), jnp.asarray(g), cfg))


# -- the whole model ----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def weights(arch):
    """The reference's spec tree of the reduced config, drawn in numpy."""
    return numpy_tree(RLM(r_get_reduced(arch)).specs(), 0)


def models(arch, dtype, **moe_kw):
    rcfg = dataclasses.replace(r_get_reduced(arch), dtype=dtype)
    cfg = dataclasses.replace(get_reduced(arch), dtype=dtype)
    if moe_kw:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, **moe_kw))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **moe_kw))
    m = LM(cfg, device="cpu", seed=1)
    m.load_state_dict(params_from_jax(weights(arch), m))
    return RLM(rcfg), to_jax(weights(arch)), m


def inputs(arch):
    """(tokens, labels, frontend or None), numpy, batch B x S."""
    rng = np.random.default_rng(14)
    tok = rng.integers(0, 512, (B, S))
    lab = rng.integers(-1, 512, (B, S))
    fe = get_reduced(arch).frontend
    front = None if fe is None else rng.standard_normal(
        (B, fe.n_positions, fe.d_frontend)).astype(np.float32)
    return tok, lab, front


@contextlib.contextmanager
def routing_recorded():
    """Record every MoE layer's experts (B, S, k), in call order, of the
    reference (through a debug callback: its layers run inside a scan)
    and of the port."""
    rec = {"ref": [], "port": []}
    r_orig, t_orig = r_moe._routing, moe._routing

    def r_wrapped(logits, mc):
        out = r_orig(logits, mc)
        jax.debug.callback(lambda e: rec["ref"].append(np.asarray(e)),
                           out[1], ordered=True)
        return out

    def t_wrapped(logits, mc):
        out = t_orig(logits, mc)
        rec["port"].append(out[1].numpy())
        return out

    r_moe._routing, moe._routing = r_wrapped, t_wrapped
    try:
        yield rec
    finally:
        r_moe._routing, moe._routing = r_orig, t_orig
        jax.effects_barrier()


def flipped(rec) -> np.ndarray:
    """(B, S) bool: the positions where some MoE layer's expert set
    differs between the reference and the port."""
    assert len(rec["ref"]) == len(rec["port"])
    out = np.zeros((B, S), bool)
    for r, t in zip(rec["ref"], rec["port"]):
        out |= (np.sort(r, -1) != np.sort(t, -1)).any(-1)
    return out


def twin(arch: str) -> str:
    """The first of FAMILIES whose reduced config equals ``arch``'s but
    for its name (moonshot-v1-16b-a3b's is deepseek-moe-16b's): its
    outputs serve both."""
    def key(a):
        return dataclasses.replace(get_reduced(a), name="")
    return next(a for a in FAMILIES if key(a) == key(arch))


def test_moonshot_reduced_is_deepseeks_layer():
    assert twin("moonshot-v1-16b-a3b") == "deepseek-moe-16b"
    assert dataclasses.replace(r_get_reduced("moonshot-v1-16b-a3b"),
                               name="") == \
        dataclasses.replace(r_get_reduced("deepseek-moe-16b"), name="")


def lm_outputs(arch, dtype):
    return _lm_outputs(twin(arch), dtype)


@functools.lru_cache(maxsize=None)
def _lm_outputs(arch, dtype):
    """The reference's and the port's forward logits, prefill logits,
    three decode steps' logits and loss terms; where the forward's
    routing flipped."""
    jm, jp, m = models(arch, dtype)
    tok, lab, front = inputs(arch)
    batch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    fe = None
    if front is not None:
        batch["frontend"] = jnp.asarray(front)
        fe = torch.from_numpy(front)
    with routing_recorded() as rec, torch.inference_mode():
        ref = {"forward": jm.forward(jp, batch)[0]}
        got = {"forward": m(torch.from_numpy(tok), frontend=fe)}
    flips = flipped(rec)
    t_max = m.n_front + S + 4
    pre = dict(batch, tokens=jnp.asarray(tok[:, :N_PRE]))
    lj, cj = jm.prefill(jp, pre, t_max)
    lt, ct = m.prefill(torch.from_numpy(tok[:, :N_PRE]), t_max, frontend=fe)
    ref["prefill"], got["prefill"] = lj, lt
    step = jax.jit(jm.decode_step)
    dj, dt = [], []
    for i in range(N_PRE, S):
        pos = m.n_front + i
        lj, cj = step(jp, jnp.asarray(tok[:, i:i + 1]), jnp.asarray(pos), cj)
        lt, ct = m.decode_step(torch.from_numpy(tok[:, i:i + 1]), pos, ct)
        dj.append(lj)
        dt.append(lt)
    ref["decode_step"] = jnp.concatenate(dj, axis=1)
    got["decode_step"] = torch.cat(dt, dim=1)
    total, terms = jm.loss(jp, batch)
    ref["loss"] = np.array([float(total)] + [float(terms[k]) for k in
                                             ("ce", "z_loss", "aux")])
    tb = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}
    if fe is not None:
        tb["frontend"] = fe
    with torch.inference_mode():
        total, terms = m.loss(tb)
    got["loss"] = torch.tensor([float(total)] + [float(terms[k]) for k in
                                                 ("ce", "z_loss", "aux")])
    return ref, got, flips


WHAT = ["forward", "prefill", "decode_step", "loss"]
# whisper-tiny's end-to-end float32 bound. Each of its layers agrees
# within 1.3e-6 of max |y| on the same inputs, and its encoder's memory
# within 2.5e-6; every decoder layer cross-attends to that memory with
# scores of std ~16 (near one-hot), which carries the memory's rounding
# into the logits at up to 4.7e-5 of max |logit| (2 of the 24 text
# positions above 2e-5).
TOL_F32 = {"whisper-tiny": 1e-4}


def positions_in(what: str) -> np.ndarray:
    """The sequence position of each of ``what``'s logits rows."""
    return {"forward": np.arange(S), "prefill": np.array([N_PRE - 1]),
            "decode_step": np.arange(N_PRE, S)}[what]


@pytest.mark.parametrize("what", WHAT)
@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_matches_reference_in_float32(arch, what):
    ref, got, flips = lm_outputs(arch, "float32")
    assert not flips.any()
    tol = TOL_F32.get(arch, TOL["float32"])
    if what == "loss":
        # total, ce, z_loss, aux: each within the bound of its own size.
        r = ref["loss"]
        assert np.all(np.abs(got["loss"].numpy() - r) <=
                      tol * np.abs(r)), (got["loss"], r)
        return
    assert got[what].dtype == torch.float32
    err = rel(got[what], ref[what])
    assert err <= tol, err


@pytest.mark.parametrize("what", WHAT)
@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_bfloat16_within_the_references_own_rounding(arch, what,
                                                        record_property):
    """Compared where no routing flip reaches: a flip at position t of a
    sequence moves that sequence's logits from t on (causal), so those
    positions are left out and the flips reported."""
    ref, got, flips = lm_outputs(arch, "bfloat16")
    ref32, _, _ = lm_outputs(arch, "float32")
    record_property("routing_flips", int(flips.sum()))
    if what == "loss":
        r, r32 = ref["loss"], ref32["loss"]
        scale = np.maximum(np.abs(r32), 1e-30)
        noise = np.abs(r - r32) / scale
        err = np.abs(got["loss"].numpy() - r) / scale
        assert np.all(err <= np.maximum(TOL["bfloat16"], noise)), (err, noise)
        return
    assert got[what].dtype == torch.bfloat16
    assert bool(torch.isfinite(got[what]).all())
    reached = np.maximum.accumulate(flips, axis=1)[:, positions_in(what)]
    keep = ~reached                                   # (B, rows)
    record_property("rows_compared", int(keep.sum()))
    g, r, r32 = (npf(a)[keep] for a in (got[what], ref[what], ref32[what]))
    if not keep.any():
        return
    scale = float(np.abs(npf(ref32[what])).max())
    noise = rel(r, r32, scale)
    err = rel(g, r, scale)
    assert err <= max(TOL["bfloat16"], noise), (err, noise, int(flips.sum()))


@pytest.mark.parametrize("arch", MOE)
def test_bfloat16_routing_flips_are_few(arch, record_property):
    """The count of (token, layer) routing flips between the two bf16
    forwards is reported. A routing that differed in kind (ties broken
    the other way, another softmax) would flip most positions; bf16
    rounding of near-equal router logits flips a few, so at most a
    quarter, none among the first N_PRE // 2 of a sequence (which the
    comparison above then reaches)."""
    _, _, flips = lm_outputs(arch, "bfloat16")
    cfg = get_reduced(arch)
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    record_property("routing_flips", int(flips.sum()))
    print(f"{arch}: routing flipped at {int(flips.sum())} of {B * S} "
          f"positions ({n_moe} MoE layers, bf16)")
    assert flips.sum() <= 0.25 * B * S
    assert not flips[:, :N_PRE // 2].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_forward(arch, dtype):
    """The port's prefill and decode against its own forward, within
    the dtype's tolerance (the reference's is bit for bit there)."""
    _, got, _ = lm_outputs(arch, dtype)
    fwd = got["forward"].float().numpy()
    close(got["prefill"], fwd[:, N_PRE - 1:N_PRE], dtype)
    close(got["decode_step"], fwd[:, N_PRE:], dtype)


def test_rwkv_chunked_equals_sequential():
    """The reference's test (tests/test_models.py): the whole model's
    logits with rwkv_chunk against the sequential form, atol 2e-5."""
    _, _, m = models("rwkv6-3b", "float32")
    tok = torch.from_numpy(np.random.default_rng(15).integers(0, 512,
                                                              (B, 16)))
    with torch.inference_mode():
        seq, chk = m(tok), m(tok, rwkv_chunk=4)
    np.testing.assert_allclose(chk.numpy(), seq.numpy(), atol=2e-5)


def test_moe_gather_equals_einsum_dispatch():
    """The reference's test: the two dispatches give the same logits
    (atol 2e-5), here with drops (capacity_factor 1.0) as well."""
    tok = torch.from_numpy(np.random.default_rng(16).integers(0, 512,
                                                              (B, 16)))
    for cf in (8.0, 1.0):
        _, _, m1 = models("deepseek-moe-16b", "float32", capacity_factor=cf)
        _, _, m2 = models("deepseek-moe-16b", "float32", capacity_factor=cf,
                          dispatch="gather")
        with torch.inference_mode():
            np.testing.assert_allclose(m2(tok).numpy(), m1(tok).numpy(),
                                       atol=2e-5)


@pytest.mark.parametrize("arch", FAMILIES)
def test_param_counts_and_caches_are_the_references(arch):
    jm, _, m = models(arch, "bfloat16")
    assert m.n_params() == jm.n_params() == \
        sum(p.numel() for p in m.parameters())
    caches = m.init_caches(B, 20, n_memory=7)
    period = len(jm.stages[0].descs)
    for i, (c, desc) in enumerate(zip(caches, m.descs)):
        want = r_init_cache(jm.cfg, jm.stages[0].descs[i % period], B, 20,
                            7, jnp.bfloat16)
        assert sorted(c) == sorted(want)
        for k, v in want.items():
            assert tuple(c[k].shape) == v.shape
            assert str(c[k].dtype).split(".")[-1] == str(v.dtype)


def test_params_from_jax_unstacks_the_encoder_and_keeps_experts_stacked():
    _, _, m = models("whisper-tiny", "float32")
    tree = weights("whisper-tiny")
    assert torch.equal(m.encoder[1].mixer.wq, torch.from_numpy(
        tree["encoder"]["0"]["mixer"]["wq"][1]))
    assert torch.equal(m.decoder[1].cross.wk, torch.from_numpy(
        tree["decoder"]["0"]["cross"]["wk"][1]))
    assert torch.equal(m.enc_norm, torch.from_numpy(tree["enc_norm"]))
    _, _, m = models("jamba-v0.1-52b", "float32")
    tree = weights("jamba-v0.1-52b")
    wi = m.decoder[3].mlp.experts.wi                  # slot 3: Mamba + MoE
    assert wi.shape == (4, 64, 128)
    assert torch.equal(wi, torch.from_numpy(
        tree["decoder"]["3"]["mlp"]["experts"]["wi"][0]))
    assert torch.equal(m.decoder[4].mixer.wq, torch.from_numpy(
        tree["decoder"]["4"]["mixer"]["wq"][0]))      # slot 4: attention


@pytest.mark.parametrize("arch", ["whisper-tiny", "internvl2-2b"])
def test_a_frontend_family_needs_its_frontend(arch):
    m = LM(get_reduced(arch), device="cpu")
    with pytest.raises(ValueError, match="frontend"):
        m(torch.zeros((1, 4), dtype=torch.long))
