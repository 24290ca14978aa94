"""The port's synthetic data (``repro_torch.data``) against the JAX
package's (``repro.data.pipeline``): its numpy threefry2x32 and the
draws on top of it give ``jax.random``'s key words, bits and values, and
``lm_batch``/``packed_batch`` the reference's token ids and labels, bit
for bit (exact equality, no tolerance). ``normal`` and ``frontend_batch``
are bit-equal to ``jax.random.normal`` too: XLA's erf_inv, log1p and log
in float32 with its fused multiply-adds (numpy's own log1p alone would
leave up to 3 ulp)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_reduced as r_get_reduced  # noqa: E402
from repro.data import pipeline as rdata  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.data import prng  # noqa: E402

SHAPES = [(4, 32, 100), (2, 300, 153_600)]   # batch, seq, vocab


def words(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
def test_key_fold_in_and_split_give_jax_words(seed):
    k, mine = jax.random.PRNGKey(seed), prng.key(seed)
    np.testing.assert_array_equal(mine, words(k))
    for d in (1, 2, 123, 2 ** 32 - 1):
        np.testing.assert_array_equal(prng.fold_in(mine, d),
                                      words(jax.random.fold_in(k, d)))
    for n in (2, 3, 7):
        np.testing.assert_array_equal(prng.split(mine, n),
                                      words(jax.random.split(k, n)))


def test_seed_outside_the_ported_range_raises():
    with pytest.raises(ValueError, match="seed"):
        prng.key(-1)


@pytest.mark.parametrize("shape", [(1,), (5,), (3, 7), (2, 3, 5)])
def test_draws_give_jax_values(shape):
    k, mine = jax.random.PRNGKey(3), prng.key(3)
    np.testing.assert_array_equal(prng.uniform(mine, shape),
                                  np.asarray(jax.random.uniform(k, shape)))
    np.testing.assert_array_equal(
        prng.bernoulli(mine, 0.5, shape),
        np.asarray(jax.random.bernoulli(k, 0.5, shape)))
    # Spans below and above 2**16 (the multiplier wraps to 0 above),
    # a negative minval, and an empty span (minval returned).
    for lo, hi in ((0, 100), (1, 153_600), (-5, 2 ** 31 - 1), (3, 3)):
        np.testing.assert_array_equal(
            prng.randint(mine, shape, lo, hi),
            np.asarray(jax.random.randint(k, shape, lo, hi)))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("b,s,vocab", SHAPES)
@pytest.mark.parametrize("step", [0, 5, 123])
@pytest.mark.parametrize("seed", [0, 7])
def test_batches_equal_the_reference_bit_for_bit(seed, step, b, s, vocab,
                                                 packed):
    kw = dict(seed=seed, seq_len=s, global_batch=b, vocab=vocab,
              packed=packed, mean_doc_len=16)
    ref = (rdata.packed_batch if packed else rdata.lm_batch)(
        rdata.DataConfig(**kw), step)
    got = (data.packed_batch if packed else data.lm_batch)(
        data.DataConfig(**kw), step)
    assert set(got) == {"tokens", "labels"}
    for name in ("tokens", "labels"):
        assert got[name].dtype == torch.int32
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(ref[name]))
    if packed:
        assert (got["labels"] == -1).any() and (got["labels"] != -1).any()


def test_batch_for_follows_packed():
    cfg = get_reduced("smollm-360m")
    for packed in (False, True):
        kw = dict(seq_len=16, global_batch=2, vocab=cfg.vocab,
                  packed=packed)
        got = data.batch_for(data.DataConfig(**kw), 4, cfg)
        ref = rdata.batch_for(rdata.DataConfig(**kw), 4,
                              r_get_reduced("smollm-360m"))
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      np.asarray(ref["tokens"]))


def test_data_deterministic_and_stateless():
    cfg = data.DataConfig(seed=7, seq_len=32, global_batch=4, vocab=100)
    assert torch.equal(data.lm_batch(cfg, 5)["tokens"],
                       data.lm_batch(cfg, 5)["tokens"])
    assert not torch.equal(data.lm_batch(cfg, 5)["tokens"],
                           data.lm_batch(cfg, 6)["tokens"])


def test_frontend_batches_wait_for_item_7():
    """Item 7's frontends: batch_for adds internvl2's patches and
    whisper's frames, the reference's bit for bit."""
    for arch in ("internvl2-2b", "whisper-tiny"):
        cfg = get_reduced(arch)
        kw = dict(seq_len=16, global_batch=2, vocab=cfg.vocab, packed=True)
        got = data.batch_for(data.DataConfig(**kw), 3, cfg)
        ref = rdata.batch_for(rdata.DataConfig(**kw), 3,
                              r_get_reduced(arch))
        assert set(got) == set(ref) == {"tokens", "labels", "frontend"}
        fe = cfg.frontend
        assert got["frontend"].dtype == torch.float32
        assert got["frontend"].shape == (2, fe.n_positions, fe.d_frontend)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


@pytest.mark.parametrize("shape", [(1,), (3, 7), (2, 1500, 384),
                                   (1000, 999)])
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
def test_normal_gives_jax_values_bit_for_bit(seed, shape):
    """Whisper-tiny's full frontend (2 x 1,500 x 384) among the shapes:
    about a million draws, every float32 bit equal."""
    k = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    got = prng.normal(prng.fold_in(prng.key(seed), 3), shape)
    ref = np.asarray(jax.random.normal(k, shape))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_erf_inv_edges_and_log1p_branches():
    """erf_inv(+-1) is +-inf, erf_inv(0) is 0, and near 1 (w >= 5, the
    second polynomial) and across log1p's switch at sqrt(2) - 1 the
    values are XLA's."""
    import jax.numpy as jnp

    x = np.array([-1.0, 0.0, 1.0, 0.5, 0.64359, 0.6436, 0.99, 0.99999,
                  -0.999999, 1e-30], np.float32)
    got = prng.erf_inv(x)
    ref = np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(x)))
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    assert np.isinf(got[[0, 2]]).all() and got[1] == 0.0

