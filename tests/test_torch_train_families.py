"""Training the non-dense families: the port's ``LM.loss`` gradients and
``make_train_step`` against the JAX package's ``value_and_grad`` and
``make_train_step`` on the CPU, at the reduced configs of
moonshot-v1-16b-a3b, deepseek-moe-16b, jamba-v0.1-52b, rwkv6-3b,
whisper-tiny and internvl2-2b.

Inputs: weights drawn with numpy over the reference's spec tree, every
leaf random (``tests/_numpy_weights.py``), carried across with
``models/convert.py``; batches from the reference's ``batch_for``
(packed documents, whisper's frames and internvl2's patches), which the
port's ``batch_for`` gives bit for bit. Batch 4 x 96 tokens, so that
Mamba runs its reference chunks (3 of 32) and RWKV its chunked form
(``rwkv_chunk=32``: 3 blocks). moonshot-v1-16b-a3b's reduced config is
deepseek-moe-16b's but for its name, so the two share one computation.

Tolerances (``tests/test_torch_train.py``'s where they apply):
- loss and its terms (ce, z_loss, aux), float32: 1e-5 relative.
- gradients, float32: max |port - reference| within 1e-3 of the
  reference's max |g| per parameter (measured up to 5.6e-4, whisper-tiny;
  1.9e-5 to 1.0e-4 at the others).
- bfloat16: MoE routing flips between the two bf16 forwards are counted
  (as ``tests/test_torch_families.py`` counts them) and every label
  from a sequence's first flip on is set to -1 before the loss, so that
  no compared term is reached by a flip (a flip moves that sequence's
  later positions). The loss terms within max(2e-2, the reference's own
  bf16 distance from its float32 value); each gradient within max(0.3,
  the reference's own bf16 distance from its float32 gradient) of
  ||reference float32 gradient||: at these configs the reference's bf16
  gradients lie up to 4.6x their norm from its float32 ones (rwkv ``u``)
  and 1.1-1.7x at whisper's encoder and jamba's Mamba layers; the port's
  reach at most 0.75 of that bound (rwkv ``ln_scale``, 0.27 against
  0.3). Flips: 7 of 384 positions at deepseek, 38 at jamba.
- one train step (float32, no clip, so AdamW's moments carry the
  gradient's scale): parameters within 3e-3 absolute, ||update -
  reference's|| within 5e-2 of ||reference's||, mu and nu within 2e-3
  of their norm; the metrics as the reference's (at 2 microbatches
  ``ce`` is the mean total loss, ``z_loss`` and ``aux`` 0).
"""
import contextlib
import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _numpy_weights  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.moe as r_moe  # noqa: E402
from repro.configs import ARCHS as R_ARCHS  # noqa: E402
from repro.configs import get_reduced as r_get_reduced  # noqa: E402
from repro.data.pipeline import DataConfig as RDataConfig  # noqa: E402
from repro.data.pipeline import batch_for as r_batch_for  # noqa: E402
from repro.models.model import LM as RLM  # noqa: E402
from repro.models.params import Spec as RSpec  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro.train.step import make_train_step as r_make_train_step  # noqa: E402,E501
import repro_torch.models.moe as moe  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_for  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import mamba, rwkv6  # noqa: E402
from repro_torch.models.convert import params_from_jax, tree_from_jax  # noqa: E402,E501
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

ARCHS = ["moonshot-v1-16b-a3b", "deepseek-moe-16b", "jamba-v0.1-52b",
         "rwkv6-3b", "whisper-tiny", "internvl2-2b"]
B, S, CHUNK = 4, 96, 32
TERMS = ("ce", "z_loss", "aux")


def twin(arch: str) -> str:
    """moonshot-v1-16b-a3b's reduced config is deepseek-moe-16b's."""
    return "deepseek-moe-16b" if arch == "moonshot-v1-16b-a3b" else arch


def test_moonshot_reduced_is_deepseeks():
    def key(get, a):
        return dataclasses.replace(get(a), name="")
    assert key(r_get_reduced, "moonshot-v1-16b-a3b") == \
        key(r_get_reduced, "deepseek-moe-16b")
    assert key(get_reduced, "moonshot-v1-16b-a3b") == \
        key(get_reduced, "deepseek-moe-16b")


@functools.lru_cache(maxsize=None)
def weights(arch):
    return _numpy_weights.numpy_tree(RLM(r_get_reduced(arch)).specs(), 0,
                                     RSpec)


def models(arch, dtype):
    jm = RLM(dataclasses.replace(r_get_reduced(arch), dtype=dtype))
    m = LM(dataclasses.replace(get_reduced(arch), dtype=dtype), device="cpu")
    m.load_state_dict(params_from_jax(weights(arch), m))
    return jm, jax.tree.map(jnp.asarray, weights(arch)), m


def data_kw(arch) -> dict:
    return dict(seq_len=S, global_batch=B, vocab=get_reduced(arch).vocab,
                packed=True, mean_doc_len=16)


@functools.lru_cache(maxsize=None)
def ref_batch(arch) -> dict:
    return {k: np.asarray(v) for k, v in r_batch_for(
        RDataConfig(**data_kw(arch)), 0, r_get_reduced(arch)).items()}


def torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_port_batches_are_the_references(arch):
    got = batch_for(DataConfig(**data_kw(arch)), 0, get_reduced(arch))
    ref = ref_batch(arch)
    assert set(got) == set(ref)
    assert ("frontend" in got) == (get_reduced(arch).frontend is not None)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v)


@contextlib.contextmanager
def routing_recorded():
    """Every MoE layer's experts (B, S, k), in call order, of the
    reference (a debug callback: its layers run in a scan) and of the
    port."""
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


def flips(arch, dtype) -> np.ndarray:
    """(B, S) bool: the positions where some MoE layer's experts differ
    between the two packages' forwards (none for a config without MoE)."""
    if get_reduced(arch).moe is None:
        return np.zeros((B, S), bool)
    jm, jp, m = models(arch, dtype)
    rb = ref_batch(arch)
    with routing_recorded() as rec, torch.inference_mode():
        jm.forward(jp, {k: jnp.asarray(v) for k, v in rb.items()},
                   rwkv_chunk=CHUNK)
        m.logits_and_aux(torch.from_numpy(rb["tokens"]),
                         attention="plain", rwkv_chunk=CHUNK)
    assert len(rec["ref"]) == len(rec["port"]) > 0
    out = np.zeros((B, S), bool)
    for r, t in zip(rec["ref"], rec["port"]):
        out |= (np.sort(r, -1) != np.sort(t, -1)).any(-1)
    return out


def to_f32(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


@functools.lru_cache(maxsize=None)
def gradients(arch, dtype):
    """Both packages' (loss, {ce, z_loss, aux}, gradients by the port's
    names) on the batch whose labels no routing flip reaches, and the
    flips' count."""
    arch = twin(arch)
    flipped = flips(arch, dtype)
    rb = dict(ref_batch(arch))
    reached = np.maximum.accumulate(flipped, axis=1)
    rb["labels"] = np.where(reached, -1, rb["labels"]).astype(np.int32)
    jm, jp, m = models(arch, dtype)
    (rl, rmet), rg = jax.jit(jax.value_and_grad(
        functools.partial(jm.loss, rwkv_chunk=CHUNK), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in rb.items()})
    ref = (float(rl), {k: float(rmet[k]) for k in TERMS},
           tree_from_jax(to_f32(rg), m))
    m.requires_grad_(True)
    loss, met = m.loss(torch_batch(rb), attention="plain", rwkv_chunk=CHUNK)
    own = dict(m.named_parameters())
    grads = torch.autograd.grad(loss, list(own.values()))
    got = (float(loss), {k: float(met[k]) for k in TERMS},
           {k: g.float().numpy() for k, g in zip(own, grads)})
    return ref, got, int(flipped.sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_its_terms_match_reference(arch, dtype, record_property):
    (rl, rmet, _), (tl, tmet, _), n_flips = gradients(arch, dtype)
    record_property("routing_flips", n_flips)
    if dtype == "float32":
        assert n_flips == 0
    ref32 = gradients(arch, "float32")[0]
    for name, got, ref, r32 in (("loss", tl, rl, ref32[0]),
                                *((k, tmet[k], rmet[k], ref32[1][k])
                                  for k in TERMS)):
        if get_reduced(arch).moe is None and name == "aux":
            assert got == ref == 0.0
            continue
        tol = 1e-5 if dtype == "float32" else \
            max(2e-2, abs(ref - r32) / abs(r32))
        assert abs(got - ref) <= tol * abs(ref), (name, got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_every_gradient_matches_reference(arch, dtype):
    (_, _, ref), (_, _, got), _ = gradients(arch, dtype)
    ref32 = gradients(arch, "float32")[0][2]
    assert set(got) == set(ref) and len(got) > 0
    for name, g in got.items():
        assert np.isfinite(g).all(), name
        if dtype == "float32":
            err = np.abs(g - ref[name]).max()
            assert err <= 1e-3 * np.abs(ref[name]).max(), (name, err)
        else:
            norm = np.linalg.norm(ref32[name])
            noise = np.linalg.norm(ref[name] - ref32[name]) / norm
            err = np.linalg.norm(g - ref[name]) / norm
            assert err <= max(0.3, noise), (name, err, noise)


def rel_norm(got, ref) -> float:
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@functools.lru_cache(maxsize=None)
def ref_step(arch, microbatches):
    jm, jp, _ = models(arch, "float32")
    ropt = radamw.AdamW(learning_rate=1e-3, grad_clip_norm=None)
    rp, ro, rmet = jax.jit(r_make_train_step(
        jm, ropt, microbatches, rwkv_chunk=CHUNK))(
        jp, ropt.init(jp), {k: jnp.asarray(v)
                            for k, v in ref_batch(arch).items()})
    return to_f32(rp), to_f32(ro["mu"]), to_f32(ro["nu"]), \
        {k: float(v) for k, v in rmet.items()}


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, microbatches):
    arch = twin(arch)
    rp, rmu, rnu, rmet = ref_step(arch, microbatches)
    _, jp, m = models(arch, "float32")
    before = {k: v.detach().clone().numpy()
              for k, v in m.named_parameters()}
    opt = adamw.AdamW(learning_rate=1e-3, grad_clip_norm=None)
    params = dict(m.named_parameters())
    tp, to, tmet = make_train_step(m, opt, microbatches, rwkv_chunk=CHUNK)(
        params, opt.init(params), torch_batch(ref_batch(arch)))
    assert set(tmet) == set(rmet) == {*TERMS, "loss", "step"}
    for k, r in rmet.items():
        assert abs(float(tmet[k]) - r) <= 1e-5 * abs(r), (k, tmet[k], r)
    if microbatches > 1:
        assert float(tmet["z_loss"]) == float(tmet["aux"]) == 0.0
        assert float(tmet["ce"]) == float(tmet["loss"])
    ref, ref0 = tree_from_jax(rp, m), tree_from_jax(to_f32(jp), m)
    for name, p in tp.items():
        got = p.detach().numpy()
        np.testing.assert_allclose(got, ref[name], rtol=0, atol=3e-3,
                                   err_msg=name)
        assert rel_norm(got - before[name], ref[name] - ref0[name]) <= \
            5e-2, name
    for moment, r_tree in (("mu", rmu), ("nu", rnu)):
        for name, r in tree_from_jax(r_tree, m).items():
            assert rel_norm(to[moment][name].numpy(), r) <= 2e-3, \
                (moment, name)


def loss_gradients(arch, **loss_kw) -> list:
    _, _, m = models(arch, "float32")
    m.requires_grad_(True)
    loss, _ = m.loss(torch_batch(ref_batch(arch)), attention="plain",
                     **loss_kw)
    return [loss.detach()] + list(torch.autograd.grad(
        loss, list(m.parameters())))


def test_chunked_mamba_gradients_equal_the_flat_loop(monkeypatch):
    """Three checkpointed chunks of 32 steps, nested in the layer's
    checkpoint, recompute the flat loop's forward: jamba's loss and
    every gradient equal the unchunked loop's bit for bit."""
    assert mamba.chunk_len(S) == 32 and mamba.chunk_len(7) == 1
    assert get_reduced("jamba-v0.1-52b").remat
    chunked = loss_gradients("jamba-v0.1-52b")
    monkeypatch.setattr(mamba, "chunk_len", lambda s: 1)
    flat = loss_gradients("jamba-v0.1-52b")
    for a, b in zip(chunked, flat):
        assert torch.equal(a, b)


def test_checkpointed_rwkv_blocks_equal_unchecked_ones(monkeypatch):
    """RWKV's chunked form checkpoints each block: the loss and every
    gradient equal those of the same blocks run without checkpoints,
    bit for bit."""
    checked = loss_gradients("rwkv6-3b", rwkv_chunk=CHUNK)
    calls = []

    def direct(fn, *args, use_reentrant):
        calls.append(fn)
        return fn(*args)

    monkeypatch.setattr(rwkv6, "checkpoint", direct)
    plain = loss_gradients("rwkv6-3b", rwkv_chunk=CHUNK)
    # Each block twice: the forward and the layer checkpoint's recompute.
    n_rwkv = get_reduced("rwkv6-3b").n_layers
    assert len(calls) == 2 * n_rwkv * S // CHUNK
    for a, b in zip(checked, plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", R_ARCHS)
def test_launch_train_runs_every_arch(arch, tmp_path, capsys):
    hist = launch_train.main(["--arch", arch, "--device", "cpu",
                              "--steps", "2", "--batch", "2", "--seq",
                              "32", "--ckpt-dir", str(tmp_path)])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step")]
    assert [h["step"] for h in hist] == [1, 2] and len(lines) == 2
    assert all(math.isfinite(h["loss"]) for h in hist)


def test_train_lm_example_trains_a_family(capsys):
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "torch_train_lm.py")
    spec = importlib.util.spec_from_file_location("torch_train_lm", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    hist = example.main(["--arch", "internvl2-2b", "--steps", "2",
                         "--batch", "2", "--seq", "16", "--device", "cpu"])
    # The loop logs every tenth step and the last.
    assert [h["step"] for h in hist] == [2]
    assert math.isfinite(hist[0]["loss"]) and math.isfinite(hist[0]["ce"])
    assert "internvl2-2b-reduced" in capsys.readouterr().out
