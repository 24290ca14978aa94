"""The port's flash attention (CPU path: the plain version behind the
same padding wrapper) against the JAX package's Pallas kernel in
interpret mode, on the reference sweep's cases
(tests/test_kernels.py:118-156). Tolerances: float32 1e-5 (summation
order only), bfloat16 3e-2 (outputs rounded to bf16 in both)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as r_fa  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_k  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    attention_plain, attention_ref, mha, padded_head_dim)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(seed, q_shape, kv_shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(q_shape).astype(np.float32),
            rng.standard_normal(kv_shape).astype(np.float32),
            rng.standard_normal(kv_shape).astype(np.float32))


def _both(arrays, dtype, **kw):
    jdt, tdt, _ = DTYPES[dtype]
    ref = r_fa.mha(*(jnp.asarray(a, jdt) for a in arrays), **kw)
    got = mha(*(torch.from_numpy(a).to(tdt) for a in arrays), **kw)
    return np.asarray(ref.astype(jnp.float32)), got.float().numpy(), got


@pytest.mark.parametrize("b,h,s,d,dtype", [
    (2, 3, 256, 64, "float32"),
    (1, 2, 300, 64, "float32"),        # non-block-aligned seq
    (2, 2, 256, 128, "bfloat16"),
    (1, 2, 64, 48, "float32"),         # head dim padded (to 64 here)
])
def test_mha_causal_matches_reference(b, h, s, d, dtype):
    arrays = _inputs(s + d, (b, h, s, d), (b, h, s, d))
    ref, got, out = _both(arrays, dtype, causal=True)
    assert out.dtype == DTYPES[dtype][1] and out.shape == (b, h, s, d)
    assert np.abs(got - ref).max() < DTYPES[dtype][2]
    # And the port's own oracle, in float32.
    oracle = attention_ref(*(torch.from_numpy(a) for a in arrays))
    assert np.abs(got - oracle.numpy()).max() < DTYPES[dtype][2]


def test_mha_cross_noncausal_matches_reference():
    arrays = _inputs(0, (1, 2, 128, 64), (1, 2, 256, 64))
    ref, got, _ = _both(arrays, "float32", causal=False)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


def test_mha_decode_alignment_matches_reference():
    """Right-aligned causal: queries are the last Sq of the kv seq."""
    arrays = _inputs(1, (1, 1, 128, 64), (1, 1, 384, 64))
    ref, got, _ = _both(arrays, "float32", causal=True)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


@pytest.mark.parametrize("block_q,block_k", [(16, 16), (32, 64), (64, 16)])
def test_mha_blocks_do_not_change_the_result(block_q, block_k):
    arrays = _inputs(7, (1, 2, 128, 64), (1, 2, 128, 64))
    ref, got, _ = _both(arrays, "float32", causal=True, block_q=block_q,
                        block_k=block_k)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("q_len,kv_len,causal,blocks", [
    (100, 128, False, (128, 128)),    # non-causal needs aligned shapes
    (128, 100, False, (128, 128)),
    (100, 200, True, (128, 128)),     # causal needs pq == pk
    (100, 100, True, (16, 128)),      # unequal blocks pad unequally
])
def test_both_wrappers_refuse_the_same_shapes(q_len, kv_len, causal,
                                              blocks):
    arrays = _inputs(2, (1, 1, q_len, 64), (1, 1, kv_len, 64))
    bq, bk = blocks
    with pytest.raises(AssertionError):
        r_fa.mha(*(jnp.asarray(a) for a in arrays), causal=causal,
                 block_q=bq, block_k=bk)
    with pytest.raises(ValueError):
        mha(*(torch.from_numpy(a) for a in arrays), causal=causal,
            block_q=bq, block_k=bk)


def test_plain_version_is_the_kernels_function():
    """attention_plain on flattened operands equals the oracle, masks
    with -1e30 (a fully masked row gives 0, not NaN) and scales by the
    scale it is given."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(
        3, (1, 2, 64, 64), (1, 2, 64, 64)))
    flat = [t.reshape(2, 64, 64) for t in (q, k, v)]
    got = attention_plain(*flat, causal=True, scale=64 ** -0.5)
    ref = attention_ref(q, k, v).reshape(2, 64, 64)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)
    # More queries than keys: the first rows see no key at all.
    qq = torch.randn(1, 8, 64, generator=torch.Generator().manual_seed(0))
    out = attention_plain(qq, flat[1][:1, :4], flat[2][:1, :4],
                          causal=True, scale=0.125)
    assert torch.isfinite(out).all() and out[0, :4].abs().max() == 0


def test_head_dims_and_kernel_argument_checks():
    assert [padded_head_dim(d) for d in (16, 48, 64, 65, 128)] == \
        [64, 64, 64, 128, 128]
    with pytest.raises(ValueError, match="head dim"):
        padded_head_dim(129)
    # Every (block_q, block_k) of the autotune grid launches at D = 128:
    # its tiles fit a CTA's shared memory.
    for bq in (16, 32, 64, 128):
        for bk in (16, 32, 64, 128):
            fa_k.check_blocks(128, bq, bk)
            assert fa_k.smem_bytes(128, bq, bk) <= 232448
    for bad in ((128, 12, 16), (128, 256, 16), (128, 16, 24),
                (128, 128, 256), (96, 16, 16)):
        with pytest.raises(ValueError):
            fa_k.check_blocks(*bad)
    # A CPU tensor never reaches the kernel's launch.
    x = torch.zeros(1, 128, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fa_k.flash_attention(x, x, x, torch.empty_like(x), causal=True,
                             block_q=128, block_k=128, scale=0.125)
