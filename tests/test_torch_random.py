"""repro_torch.random against jax.random (threefry2x32, partitionable).

split, fold_in, bits and randint must be bit-equal over many keys and
shapes; uniform on [0, 1) is bit-equal too; normal goes through erfinv,
whose two implementations differ by a few ulps, so it is held with
rtol 1e-5 / atol 1e-5 (the largest observed differences are ~1e-5 absolute
at |x| ~ 4, in the tails).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import random as rnd

SEEDS = [0, 1, 7, 42, 12345, 2**31 - 1, -1, -123456]


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _tkey(seed):
    return rnd.PRNGKey(seed, device="cpu")


def _np(t):
    return t.numpy().astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_split_fold_in_bit_equal(seed):
    jk, tk = _jkey(seed), _tkey(seed)
    np.testing.assert_array_equal(np.asarray(jk).astype(np.int64), _np(tk))
    for num in (1, 2, 5, 33):
        np.testing.assert_array_equal(
            np.asarray(jax.random.split(jk, num)).astype(np.int64),
            _np(rnd.split(tk, num)))
    for data in (0, 1, 0x5CA, 0xC0DEC, 2**32 - 1):
        np.testing.assert_array_equal(
            np.asarray(jax.random.fold_in(jk, data)).astype(np.int64),
            _np(rnd.fold_in(tk, data)))


@pytest.mark.parametrize("seed", SEEDS[:5])
def test_batched_keys_match_vmap(seed):
    """A (n, 2) stack of keys behaves like jax.vmap over the keys."""
    jk, tk = _jkey(seed), _tkey(seed)
    ids = np.arange(11)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(jk, i))(jnp.asarray(ids))
    tkeys = rnd.fold_in(tk, torch.as_tensor(ids))
    np.testing.assert_array_equal(np.asarray(jkeys).astype(np.int64), _np(tkeys))
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(jkeys)).astype(np.int64),
        _np(rnd.split(tkeys, 3)))
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.bits(k, (4, 8), jnp.uint32))(jkeys)).astype(np.int64),
        _np(rnd.bits(tkeys, (4, 8))))
    counts = np.arange(1, 12) * 37
    jr = jax.vmap(lambda k, c: jax.random.randint(k, (9,), 0, c))(
        jkeys, jnp.asarray(counts))
    tr = rnd.randint(tkeys, (9,), 0, torch.as_tensor(counts)[:, None])
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 3, 256), (4097,)])
def test_bits_bit_equal(seed, shape):
    got = rnd.bits(_tkey(seed), shape)
    want = np.asarray(jax.random.bits(_jkey(seed), shape, jnp.uint32))
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(want.astype(np.int64), _np(got))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", [(0, 37), (0, 100), (0, 6000), (-5, 100003),
                                   (3, 3), (5, 2), (0, 2**31 - 1),
                                   (-2**31, 2**31 - 1)])
def test_randint_bit_equal(seed, lo, hi):
    want = np.asarray(jax.random.randint(_jkey(seed), (257,), lo, hi))
    got = rnd.randint(_tkey(seed), (257,), lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_uniform_bit_equal_and_normal_close(seed):
    shape = (3, 1000)
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(_jkey(seed), shape)),
        rnd.uniform(_tkey(seed), shape).numpy())
    np.testing.assert_allclose(
        rnd.uniform(_tkey(seed), shape, -2.0, 3.0).numpy(),
        np.asarray(jax.random.uniform(_jkey(seed), shape, minval=-2.0,
                                      maxval=3.0)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        rnd.normal(_tkey(seed), shape).numpy(),
        np.asarray(jax.random.normal(_jkey(seed), shape)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chunk", [1000, 4103])
def test_chunked_normal_matches_one_draw_and_jax(monkeypatch, chunk):
    """A draw larger than NORMAL_CHUNK is made a chunk of counters at a time:
    the same uniforms (bit-equal), so the same normals up to erfinv's
    vectorised and scalar paths on the CPU (1e-6), and jax's within 1e-5."""
    shape = (7, 1500)
    whole = rnd.normal(_tkey(5), shape)
    monkeypatch.setattr(rnd, "NORMAL_CHUNK", chunk)
    chunked = rnd.normal(_tkey(5), shape)
    assert chunked.shape == shape and chunked.dtype == torch.float32
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(chunked.numpy(),
                               np.asarray(jax.random.normal(_jkey(5), shape)),
                               rtol=1e-5, atol=1e-5)


def test_default_device_raises_without_a_card(monkeypatch):
    """Entry points default to the card; with none present they refuse
    rather than run on the CPU."""
    from repro_torch.data.synthetic import classification_dataset
    from repro_torch.models import mlp
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rnd.PRNGKey(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mlp.init(_tkey(1), 8, 4, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        classification_dataset(_tkey(0), n=10, num_features=4, test_n=5)
