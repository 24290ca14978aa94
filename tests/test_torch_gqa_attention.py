"""Grouped-query attention inside the flash kernel's function, on the CPU.

The kernel (csrc/flash_attention.cu) takes q (B, Sq, Hq, D) and k, v
(B, Skv, Hkv, D) at the strides they have, q head h reading kv head
h // g. Here its plain version (``attention_plain``, what a CPU tensor
runs and the card's oracle) and ``mha`` are held to the JAX package's
``mha`` (its Pallas kernel in interpret mode) on kv widened with numpy,
and the model's flash route to the JAX model at granite-3-8b reduced
(g = 2). Float32, within 2e-5: summation order only.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as r_get_reduced  # noqa: E402
from repro.kernels.flash_attention import ops as r_fa  # noqa: E402
from repro.models.model import LM as RLM  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_k  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402

TOL = 2e-5


def _reference(q, k, v, causal):
    """The JAX ``mha`` on (B, H, S, D) numpy arrays, kv widened to one
    head per q head (q head h reads kv head h // g)."""
    g = q.shape[1] // k.shape[1]
    kw, vw = (np.repeat(x, g, axis=1) for x in (k, v))
    out = r_fa.mha(*(jnp.asarray(x) for x in (q, kw, vw)), causal=causal)
    return np.asarray(out)


def _draw(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32))


def _projection_views(q, k, v):
    """q, k and v as (B, S, H, D) slices of one fused (B, S, Hq + 2 Hkv,
    D) projection output: none of them contiguous."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    fused = torch.from_numpy(np.concatenate(
        [x.transpose(0, 2, 1, 3) for x in (q, k, v)], axis=2).copy())
    return (fused[:, :, :hq], fused[:, :, hq:hq + hkv],
            fused[:, :, hq + hkv:])


@pytest.mark.parametrize("g", [1, 2, 5])
@pytest.mark.parametrize("layout", ["bshd", "strided"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_with_grouped_heads_matches_reference(g, layout,
                                                            causal):
    q, k, v = _draw(g, 2, 2 * g, 2, 128, 128 if causal else 256, 64)
    if layout == "bshd":
        qs, ks, vs = (torch.from_numpy(x.transpose(0, 2, 1, 3).copy())
                      for x in (q, k, v))
    else:
        qs, ks, vs = _projection_views(q, k, v) if causal else (
            torch.from_numpy(x).transpose(1, 2) for x in (q, k, v))
        assert not any(x.is_contiguous() for x in (qs, ks, vs))
    got = ops.attention_plain(qs, ks, vs, causal=causal, scale=64 ** -0.5)
    assert got.shape == qs.shape
    ref = _reference(q, k, v, causal).transpose(0, 2, 1, 3)
    assert np.abs(got.numpy() - ref).max() <= TOL


@pytest.mark.parametrize("g,sq,d", [(1, 300, 64), (2, 256, 48),
                                    (5, 100, 128)])
def test_mha_with_fewer_kv_heads_matches_reference(g, sq, d):
    """Ragged Sq (padded to the block), D padded to the kernel's, and
    g q heads on each kv head, against the reference on widened kv."""
    q, k, v = _draw(sq + d, 1, 2 * g, 2, sq, sq, d)
    got = ops.mha(*(torch.from_numpy(x) for x in (q, k, v)), causal=True)
    assert got.shape == q.shape
    assert np.abs(got.numpy() - _reference(q, k, v, True)).max() <= TOL


def test_mha_refuses_heads_that_do_not_group():
    q, k, v = (torch.zeros(1, h, 128, 64) for h in (3, 2, 2))
    with pytest.raises(ValueError, match="H / g"):
        ops.mha(q, k, v)


def test_model_flash_route_matches_jax_model_at_granite_reduced():
    """granite-3-8b reduced (4 q heads on 2 kv heads): the port's forward
    through its flash route (the plain version on the CPU) against the
    JAX model's on the JAX model's weights at S = 12, the size of
    tests/test_torch_models.py (at S = 128 the two float32 programs part
    by 3.8e-5 of max |logit| on either of the port's routes: the
    reduced configs' ill-conditioning, ROADMAP Queue 3 item 7), and
    against the port's streaming route at S = 128, a multiple of the
    blocks."""
    cfg_r = dataclasses.replace(r_get_reduced("granite-3-8b"),
                                dtype="float32")
    jm = RLM(cfg_r)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_reduced("granite-3-8b"), dtype="float32")
    assert cfg.n_heads // cfg.n_kv_heads == 2
    m = LM(cfg, device="cpu", seed=1)
    m.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), m))
    rng = np.random.default_rng(11)
    tok = rng.integers(0, jm.vocab_real, (2, 12))
    ref = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(tok)})[0])
    with torch.inference_mode():
        got = m(torch.from_numpy(tok)).numpy()
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()
    tok = torch.from_numpy(rng.integers(0, jm.vocab_real, (2, 128)))
    with torch.inference_mode():
        flash, plain = m(tok).numpy(), m(tok, attention="plain").numpy()
    assert np.abs(flash - plain).max() <= TOL * np.abs(plain).max()


def test_flash_route_hands_the_projections_over_uncopied(monkeypatch):
    """On block-aligned inputs at a kernel head dim the model's route
    neither widens (``repeat_interleave``) nor pads (``F.pad``) nor
    copies: the kernel's function gets views of the projections, and its
    (B, S, Hq, D) output comes back as it was written."""
    def refuse(*a, **k):
        raise AssertionError("a copy on the flash route")

    seen = {}
    plain = ops.attention_plain

    def spy(q, k, v, **kw):
        seen["in"] = (q, k, v)
        seen["out"] = plain(q, k, v, **kw)
        return seen["out"]

    monkeypatch.setattr(torch.Tensor, "repeat_interleave", refuse)
    monkeypatch.setattr(torch, "repeat_interleave", refuse)
    monkeypatch.setattr(torch.nn.functional, "pad", refuse)
    monkeypatch.setattr(ops.F, "pad", refuse)
    monkeypatch.setattr(ops, "attention_plain", spy)
    q, k, v = _projection_views(*_draw(3, 2, 4, 2, 128, 128, 64))
    o = attn.flash_attention(q, k, v)
    for got, want in zip(seen["in"], (q, k, v)):
        assert got.data_ptr() == want.data_ptr()
        assert got.stride() == want.stride()
    assert o.data_ptr() == seen["out"].data_ptr() and o.is_contiguous()
    assert o.shape == (2, 128, 4, 64)


def test_kernel_reads_aligned_views_where_they_lie():
    """``mha`` copies an operand for the kernel only when the kernel
    cannot read it: D not contiguous or a row off 16 bytes."""
    fused = torch.zeros(2, 128, 8, 64)
    view = fused[:, :, 2:4]
    assert ops._kernel_ready(view) is view
    odd = torch.zeros(2, 128, 8, 66)[..., 1:65]
    assert ops._kernel_ready(odd) is not odd
    assert ops._kernel_ready(odd).is_contiguous()
    cols = torch.zeros(2, 128, 64, 4).transpose(2, 3)
    assert ops._kernel_ready(cols).stride(-1) == 1


def test_kernel_wrapper_takes_grouped_heads_only_on_a_card():
    """The 4-D entry checks shapes and heads before the device: a CPU
    tensor of the right layout is refused for its device."""
    q = torch.zeros(1, 128, 4, 64)
    kv = torch.zeros(1, 128, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fa_k.flash_attention(q, kv, kv, torch.empty_like(q), causal=True,
                             block_q=128, block_k=128, scale=0.125)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        fa_k.flash_attention(q, torch.zeros(1, 128, 3, 64),
                             torch.zeros(1, 128, 3, 64),
                             torch.empty_like(q), causal=True, block_q=128,
                             block_k=128, scale=0.125)


def test_bf16_kernel_takes_its_block_pairs_and_names_them():
    """The bf16 kernel (csrc/flash_attention_bf16.cu) is built for four
    (block_q, block_k) pairs: check_blocks, and ``mha`` on bf16 tensors
    wherever they lie, refuse any other with an error that names them;
    float32 keeps its own 16 pairs. Every bf16 pair's tiles fit a CTA at
    D = 128."""
    from repro_torch.kernels._launch import MAX_SMEM_BYTES
    for bq, bk in fa_k.BF16_BLOCKS:
        fa_k.check_blocks(128, bq, bk, torch.bfloat16)
        assert fa_k.bf16_smem_bytes(128, bq, bk) <= MAX_SMEM_BYTES
    x = torch.zeros(1, 2, 128, 64, dtype=torch.bfloat16)
    for bq, bk in ((16, 16), (32, 64), (128, 32), (64, 16)):
        fa_k.check_blocks(128, bq, bk, torch.float32)
        with pytest.raises(ValueError, match=r"\(128, 128\)"):
            fa_k.check_blocks(128, bq, bk, torch.bfloat16)
        with pytest.raises(ValueError, match="bfloat16 kernel takes"):
            ops.mha(x, x, x, block_q=bq, block_k=bk)
