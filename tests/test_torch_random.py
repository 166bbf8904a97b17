"""The port's threefry stream against jax.random's legacy stream, bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch import random as prng  # noqa: E402

SEEDS = [0, 7, 12345, 2**31 - 1]
SHAPES = [(), (1,), (2,), (7,), (16,), (3, 5)]


def tkey(k):
    return torch.as_tensor(np.asarray(k).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in(seed):
    with jax.threefry_partitionable(False):
        k = jax.random.PRNGKey(seed)
        assert np.array_equal(np.asarray(k), prng.PRNGKey(seed).numpy())
        for num in (1, 2, 3, 8):
            assert np.array_equal(np.asarray(jax.random.split(k, num)),
                                  prng.split(tkey(k), num).numpy())
        for data in (0, 1, 99, 2**31, 2**32 - 1):
            assert np.array_equal(np.asarray(jax.random.fold_in(k, data)),
                                  prng.fold_in(tkey(k), data).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_uniform_and_randint(seed, shape):
    with jax.threefry_partitionable(False):
        k = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
        want = np.asarray(jax.random.uniform(k, shape))
        got = prng.uniform(tkey(k), shape).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want)
        for lo, hi in ((0, 1), (0, 4), (0, 16), (3, 10), (0, 1024)):
            want = np.asarray(jax.random.randint(k, shape, lo, hi, jnp.int32))
            got = prng.randint(tkey(k), shape, lo, hi).numpy()
            assert got.dtype == want.dtype and np.array_equal(got, want)


def test_batched_keys_match_vmap():
    """Leading key axes give what vmap over the keys gives (the sender draws
    a chunk of ticks, or one key per flow, in one call)."""
    with jax.threefry_partitionable(False):
        k = jax.random.PRNGKey(11)
        ticks = jax.jit(jax.vmap(lambda t: jax.random.split(jax.random.fold_in(k, t))))(
            jnp.arange(37))
        got = prng.split(prng.fold_in(tkey(k), torch.arange(37)), 2)
        assert np.array_equal(np.asarray(ticks), got.numpy())
        flows = jax.jit(jax.vmap(lambda kk: jax.random.split(kk, 6)))(ticks[:, 0])
        assert np.array_equal(np.asarray(flows), prng.split(got[:, 0], 6).numpy())
        u = jax.jit(jax.vmap(lambda kk: jax.random.uniform(kk, (9,))))(ticks[:, 1])
        assert np.array_equal(np.asarray(u), prng.uniform(got[:, 1], (9,)).numpy())
        r = jax.jit(jax.vmap(jax.vmap(
            lambda kk: jax.random.randint(kk, (5,), 0, 16, jnp.int32))))(flows)
        assert np.array_equal(np.asarray(r), prng.randint(prng.split(got[:, 0], 6), (5,), 0, 16).numpy())
