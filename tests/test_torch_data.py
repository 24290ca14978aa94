"""The port's synthetic data (``repro_torch.data``) against the JAX
package's (``repro.data.pipeline``): its numpy threefry2x32 and the
draws on top of it give ``jax.random``'s key words, bits and values, and
``lm_batch``/``packed_batch`` the reference's token ids and labels, bit
for bit (exact equality, no tolerance)."""
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
    cfg = get_reduced("internvl2-2b")
    dcfg = data.DataConfig(seq_len=16, global_batch=2, vocab=cfg.vocab)
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        data.batch_for(dcfg, 0, cfg)

