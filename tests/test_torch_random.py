"""The port's threefry2x32 (``repro_torch.random``) against ``jax.random``:
keys, splits, folds and uniform draws must be equal bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import random as trandom

SEEDS = [0, 1, 2**31 - 1]


def _key(seed):
    return trandom.PRNGKey(seed, device="cpu")


def _eq_key(jkey, tkey):
    np.testing.assert_array_equal(np.asarray(jkey).astype(np.int64),
                                  tkey.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_and_split(seed):
    jk, tk = jax.random.PRNGKey(seed), _key(seed)
    _eq_key(jk, tk)
    assert tk.dtype == torch.int64 and tk.shape == (2,)
    for num in (2, 3, 64):
        _eq_key(jax.random.split(jk, num), trandom.split(tk, num))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (1000,), (8, 257)])
def test_uniform_bit_equal(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), _key(seed)
    want = np.asarray(jax.random.uniform(jk, shape))
    got = trandom.uniform(tk, shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_fold_in_chain(seed):
    """The partitioner's use: split per round, fold_in per partition id,
    a batch of keys drawing (N,) each (JAX's vmap)."""
    jk, tk = jax.random.PRNGKey(seed), _key(seed)
    for step in range(4):
        jk, jsub = jax.random.split(jk)
        tk, tsub = trandom.split(tk)
        _eq_key(jk, tk)
        _eq_key(jsub, tsub)
        jkeys = jax.vmap(lambda i: jax.random.fold_in(jsub, i))(
            jnp.arange(10, dtype=jnp.int32))
        tkeys = trandom.fold_in(tsub, torch.arange(10))
        _eq_key(jkeys, tkeys)
        _eq_key(jax.random.fold_in(jsub, 2**31 - 1 - step),
                trandom.fold_in(tsub, 2**31 - 1 - step))
        want = jax.vmap(lambda k: jax.random.uniform(k, (123,)))(jkeys)
        np.testing.assert_array_equal(
            trandom.uniform(tkeys, (123,)).numpy(), np.asarray(want))


def test_card_is_the_default_device():
    """``device=None`` means the card; without one it raises."""
    if torch.cuda.is_available():
        assert trandom.PRNGKey(0).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            trandom.PRNGKey(0)


def test_bad_key_raises():
    with pytest.raises(TypeError):
        trandom.split(torch.zeros(2, dtype=torch.int32))
