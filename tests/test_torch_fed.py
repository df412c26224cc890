"""The port's federated round, codecs, error feedback and byte accounting
against the JAX reference on the same numpy data, params and keys.

Batch indices, masks, weights, codec keys and the int8 wire format are
bit-equal; gradients and values agree to 1e-6 (fp32 sums in another
order); with int8+EF a 1-ulp gradient difference may move one stochastic-
rounding decision by one level (one quantization step of its chunk), so the
int8 round's aggregate is held to that step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import accounting as jacc
from repro.comm import codecs as jcodecs
from repro.comm import error_feedback as jef
from repro.core import fed as jfed
from repro.core import topology as jtopo
from repro.models import mlp as jmlp
from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.comm import accounting as tacc
from repro_torch.comm import codecs as tcodecs
from repro_torch.comm import error_feedback as tef
from repro_torch.core import fed as tfed
from repro_torch.core import topology as ttopo
from repro_torch.kernels import quantize
from repro_torch.models import mlp as tmlp

P, J, L, I, B = 32, 16, 10, 4, 20


def _data(ragged=False, seed=0):
    rng = np.random.default_rng(seed)
    sizes = [30, 7, 55, 20] if ragged else [60] * I
    feats = [rng.standard_normal((n, P)).astype(np.float32) for n in sizes]
    labs = [np.eye(L, dtype=np.float32)[rng.integers(0, L, n)] for n in sizes]
    jd = jfed.partition_ragged(feats, labs)
    td = convert.sample_fed_data_from_numpy(*(np.asarray(a) for a in jd),
                                            device="cpu")
    return jd, td


def _params(seed=1):
    rng = np.random.default_rng(seed)
    return {"w0": (rng.standard_normal((L, J)) / 4).astype(np.float32),
            "w1": (rng.standard_normal((J, P)) / 6).astype(np.float32)}


def _keys(seed):
    jk = jax.random.PRNGKey(seed)
    return jk, convert.key_from_numpy(np.asarray(jk), device="cpu")


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_sample_batches_masks_weights_bit_equal(ragged, seed):
    jd, td = _data(ragged)
    jk, tk = _keys(seed)
    np.testing.assert_array_equal(tfed.sample_batches(td, tk, B).numpy(),
                                  np.asarray(jfed.sample_batches(jd, jk, B)))
    np.testing.assert_array_equal(tfed.batch_mask(td.counts, B).numpy(),
                                  np.asarray(jfed.batch_mask(jd.counts, B)))
    np.testing.assert_array_equal(
        tfed.aggregation_weights(td.counts, B).numpy(),
        np.asarray(jfed.aggregation_weights(jd.counts, B)))
    ids = np.arange(I)
    np.testing.assert_array_equal(
        convert.key_to_numpy(tfed.client_keys(tk, torch.from_numpy(ids))),
        np.asarray(jfed.client_keys(jk, jnp.asarray(ids))))


def test_partition_samples_matches():
    rng = np.random.default_rng(2)
    z = rng.standard_normal((103, P)).astype(np.float32)
    y = np.eye(L, dtype=np.float32)[rng.integers(0, L, 103)]
    jd = jfed.partition_samples(jnp.asarray(z), jnp.asarray(y), I)
    td = tfed.partition_samples(torch.from_numpy(z), torch.from_numpy(y), I)
    for a, b in zip(td, jd):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert td.num_clients == I and int(td.total) == int(jd.total)
    # the key-shuffled split is ported: the same permutation as jax's
    jk, tk = _keys(4)
    jd = jfed.partition_samples(jnp.asarray(z), jnp.asarray(y), I, key=jk)
    td = tfed.partition_samples(torch.from_numpy(z), torch.from_numpy(y), I,
                                key=tk)
    for a, b in zip(td, jd):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("ragged", [False, True])
def test_sample_round_dense_matches(ragged):
    jd, td = _data(ragged)
    p = _params()
    jk, tk = _keys(5)
    jg, jv, ju = jfed.sample_round(jmlp.per_sample_loss,
                                   {k: jnp.asarray(v) for k, v in p.items()},
                                   jd, jk, B, with_value=True)
    tg, tv, tu = tfed.sample_round(tmlp.per_sample_loss,
                                   convert.params_from_numpy(p, "cpu"), td,
                                   tk, B, with_value=True)
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-6, atol=1e-6)
    for k in p:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(tu["q_grad_sums"][k].numpy(),
                                   np.asarray(ju["q_grad_sums"][k]),
                                   atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tu["q_value_sums"].numpy(),
                               np.asarray(ju["q_value_sums"]), rtol=1e-5)
    assert tu["encoded"] is None and tu["ef"] is None
    assert tu["upload_nbytes"] is None


def test_sample_round_int8_ef_matches():
    jd, td = _data()
    p = _params(3)
    jk, tk = _keys(6)
    rng = np.random.default_rng(4)
    dim = L * J + J * P
    ef = (rng.standard_normal((I, dim)) * 0.01).astype(np.float32)
    jc = jcodecs.StochasticQuantizer(bits=8, impl="pallas", interpret=True)
    jg, jv, ju = jfed.sample_round(jmlp.per_sample_loss,
                                   {k: jnp.asarray(v) for k, v in p.items()},
                                   jd, jk, B, codec=jc, ef=jnp.asarray(ef))
    tg, tv, tu = tfed.sample_round(tmlp.per_sample_loss,
                                   convert.params_from_numpy(p, "cpu"), td,
                                   tk, B, codec=tcodecs.make_codec("int8"),
                                   ef=torch.from_numpy(ef))
    assert tu["upload_nbytes"] == ju["upload_nbytes"]
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-6)
    # one rounding level of the coarsest chunk bounds any flipped decision
    step = float(np.max(np.asarray(ju["encoded"].scales)))
    for k in p:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   atol=step + 1e-6)
    np.testing.assert_allclose(tu["ef"].numpy(), np.asarray(ju["ef"]),
                               atol=step + 1e-6)
    assert tuple(tu["encoded"].values.shape) == ju["encoded"].values.shape
    assert tu["encoded"].values.dtype == torch.int8


@pytest.mark.parametrize("name", ["int8", "int4", "identity"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_stacked_wire_bit_equal(name, seed):
    """Identical pre-codec uploads and residuals through both codecs with
    the same per-client keys give bit-equal wire values, decoded uploads
    and residuals. The reference runs its Pallas kernel in interpret mode;
    the port compresses the whole (I, P) stack in one quantize call."""
    rng = np.random.default_rng(seed)
    up = {"w0": (rng.standard_normal((I, L, J)) * 2).astype(np.float32),
          "w1": rng.standard_normal((I, J, P)).astype(np.float32)}
    ef = (rng.standard_normal((I, L * J + J * P)) * 0.1).astype(np.float32)
    jk, tk = _keys(100 + seed)
    jkeys = jfed.client_keys(jax.random.fold_in(jk, 0xC0DEC), jnp.arange(I))
    tkeys = tfed.client_keys(rnd.fold_in(tk, 0xC0DEC), torch.arange(I))
    jc = jcodecs.make_codec(name, impl="pallas")
    if name != "identity":
        object.__setattr__(jc, "interpret", True)
    jenc, jup, jr = jtopo._compress_stacked(
        jc, {k: jnp.asarray(v) for k, v in up.items()}, jnp.asarray(ef),
        jkeys, None)
    before = quantize.stochastic_quantize.launches
    tenc, tup, tr = ttopo._compress_stacked(
        tcodecs.make_codec(name), convert.params_from_numpy(up, "cpu"),
        torch.from_numpy(ef), tkeys)
    assert quantize.stochastic_quantize.launches == before   # CPU: plain
    for a, b in zip(tenc, jenc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for k in up:
        np.testing.assert_array_equal(tup[k].numpy(), np.asarray(jup[k]))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_codec_decode_flatten_and_ef_invariants():
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((3, 700)).astype(np.float32))
    keys = tfed.client_keys(convert.key_from_numpy(np.asarray(
        jax.random.PRNGKey(3)), "cpu"), torch.arange(3))
    q = tcodecs.make_codec("int8")
    enc, xhat = q.roundtrip(x, keys)
    assert torch.equal(q.decode(enc, 700), xhat)
    enc1, xhat1 = q.roundtrip(x[1], keys[1])              # one client alone
    assert torch.equal(enc1.values, enc.values[1]) and torch.equal(xhat1, xhat[1])
    r = torch.from_numpy(rng.standard_normal((3, 700)).astype(np.float32))
    _, x_hat, new_r = tef.ef_roundtrip(q, x, r, keys)
    torch.testing.assert_close(x_hat + new_r, x + r)      # conservation
    with pytest.raises(ValueError, match="PRNG key"):
        q.roundtrip(x, None)
    with pytest.raises(ValueError, match="unknown codec"):
        tcodecs.make_codec("topk16")
    assert isinstance(tcodecs.make_codec("topk"), tcodecs.TopK)
    assert tcodecs.make_codec("none") is None and tcodecs.make_codec(None) is None
    tree = {"w1": torch.arange(6.).reshape(2, 3), "w0": torch.ones(2, 2)}
    jtree = {k: jnp.asarray(v.numpy()) for k, v in tree.items()}
    flat, unflat = tcodecs.flatten_tree(tree)
    np.testing.assert_array_equal(flat.numpy(),
                                  np.asarray(jcodecs.flatten_tree(jtree)[0]))
    assert all(torch.equal(unflat(flat)[k], tree[k]) for k in tree)
    stacked = {k: torch.stack([v, -v]) for k, v in tree.items()}
    sf, sun = tcodecs.flatten_stacked(stacked)
    np.testing.assert_array_equal(sf.numpy(), np.asarray(jcodecs.flatten_stacked(
        {k: jnp.asarray(v.numpy()) for k, v in stacked.items()})[0]))
    assert all(torch.equal(sun(sf)[k], stacked[k]) for k in tree)
    assert tcodecs.tree_flat_dim(tree) == 10
    assert tuple(tef.ef_init_stacked(3, 10, device="cpu").shape) == (3, 10)


@pytest.mark.parametrize("name", [None, "identity", "int8", "int4"])
@pytest.mark.parametrize("p", [17, 256, 101_632])
def test_accounting_matches(name, p):
    tc = tcodecs.make_codec(name)
    jc = jcodecs.make_codec(name)
    assert tacc.vector_nbytes(p, tc) == jacc.vector_nbytes(p, jc)
    if tc is not None:
        assert tacc.compression_ratio(tc, p) == jacc.compression_ratio(jc, p)
    for kw in ({}, {"with_value": True}):
        assert tacc.sample_round_bytes(p, 10, tc, **kw) == \
            jacc.sample_round_bytes(p, 10, jc, **kw)


def test_paper_width_upload_bytes():
    """The main path's per-round uplink at P=101,632, I=10: 4,065,280 B
    dense, 1,032,200 B int8 (3.94x fewer)."""
    assert tacc.sample_round_bytes(101_632, 10)["up"] == 4_065_280
    assert tacc.sample_round_bytes(101_632, 10, tcodecs.make_codec("int8"))[
        "up"] == 1_032_200


def test_sample_round_rejects_unported_options():
    _, td = _data()
    _, tk = _keys(1)
    p = convert.params_from_numpy(_params(), "cpu")
    # partial participation is ported: S = 2 of 4 runs and draws the
    # reference's clients and aggregate
    jd, _ = _data()
    jk, _ = _keys(1)
    jg, jv, ju = jfed.sample_round(jmlp.per_sample_loss,
                                   jax.tree.map(jnp.asarray, _params()), jd, jk,
                                   B, participation=2)
    tg, tv, tu = tfed.sample_round(tmlp.per_sample_loss, p, td, tk, B,
                                   participation=2)
    np.testing.assert_array_equal(tu["participants"].numpy(),
                                  np.asarray(ju["participants"]))
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), atol=1e-6)
    # DP is ported since: dp= clips and noises each client's upload with the
    # reference's keys (a 0.01 noise multiplier keeps erfinv's ulps small)
    from repro.core import privacy as jpriv
    from repro_torch.core import privacy as tpriv
    dp = dict(clip_norm=0.5, noise_multiplier=0.01)
    jg, _, ju = jfed.sample_round(jmlp.per_sample_loss,
                                  jax.tree.map(jnp.asarray, _params()), jd, jk,
                                  B, dp=jpriv.DPConfig(**dp))
    tg, _, tu = tfed.sample_round(tmlp.per_sample_loss, p, td, tk, B,
                                  dp=tpriv.DPConfig(**dp))
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), atol=1e-5)
    np.testing.assert_array_equal(tu["dp"]["clipped"].numpy(),
                                  np.asarray(ju["dp"]["clipped"]))
    with pytest.raises(ValueError, match="without codec"):
        tfed.sample_round(tmlp.per_sample_loss, p, td, tk, B,
                          ef=torch.zeros(I, 10))
    with pytest.raises(ValueError, match="shape"):
        tfed.sample_round(tmlp.per_sample_loss, p, td, tk, B,
                          codec=tcodecs.make_codec("int8"),
                          ef=torch.zeros(I, 10))
    # the port's weighted_sum matches the reference's helper on plain data
    w = torch.tensor([0.1, 0.2, 0.3, 0.4])
    s = ttopo.LOCAL.weighted_sum(
        lambda u: ({"a": u}, u.sum(-1)), (torch.ones(4, 3),), w)
    torch.testing.assert_close(s.weighted["a"], torch.full((3,), 1.0))
    torch.testing.assert_close(s.value, torch.tensor(3.0))
    jw = jtopo._weighted(jnp.asarray(w.numpy()), {"a": jnp.ones((4, 3))},
                         jnp.full((4,), 3.0))
    np.testing.assert_allclose(s.weighted["a"].numpy(), np.asarray(jw[0]["a"]))
    assert isinstance(jef.CommCarry(opt=None, ef=None), tuple)
