"""The port's TopK and Chain codecs, their error feedback, the keyed EFStore
and the participation-aware byte accounting against the JAX reference on
the CPU.

Every comparison here is bit-equal: the codecs get identical inputs and
keys, so the kept indices (the lower index first among equal magnitudes,
as ``lax.top_k`` orders them), the kept values, the int8 levels and scales
of Chain's inner quantizer, the decoded uploads and the residuals agree
exactly. Every failure message says how many entries differ.
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
from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.comm import accounting as tacc
from repro_torch.comm import codecs as tcodecs
from repro_torch.comm import error_feedback as tef
from repro_torch.core import fed as tfed
from repro_torch.core import topology as ttopo
from repro_torch.kernels import quantize


def _eq(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bad = np.flatnonzero(got.ravel() != want.ravel())
    assert bad.size == 0, f"{what}: {bad.size} entries differ, first at {bad[:5]}"


def _tied(rows, p, seed):
    """Uploads with planted magnitude ties: repeated values, ± pairs, zeros
    and -0.0, so that top-k must break ties by index."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal((rows, p)) * 4) / 4        # few levels
    x[:, ::7] = 2.5
    x[:, 3::7] = -2.5
    x[:, 5::11] = 0.0
    x[:, 6::11] = -0.0
    return x.astype(np.float32)


def _keys(rows, seed=3):
    jk = jax.random.PRNGKey(seed)
    jkeys = jfed.client_keys(jk, jnp.arange(rows))
    return jkeys, convert.key_from_numpy(np.asarray(jkeys), "cpu")


@pytest.mark.parametrize("frac", [0.01, 0.05, 0.3, 1.0])
@pytest.mark.parametrize("p", [7, 576, 1000])
def test_topk_encode_decode_bit_equal_on_ties(frac, p):
    x = _tied(3, p, seed=p)
    jc, tc = jcodecs.TopK(frac=frac), tcodecs.TopK(frac=frac)
    assert tc.k(p) == jc.k(p) and tc.nbytes(p) == jc.nbytes(p)
    for r in range(3):
        je = jc.encode(jnp.asarray(x[r]))
        te = tc.encode(torch.from_numpy(x[r]))
        _eq(te.indices.numpy(), je.indices, "indices")
        assert te.indices.dtype == torch.int32
        _eq(te.values.numpy(), je.values, "values")
        _eq(tc.decode(te, p).numpy(), jc.decode(je, p), "decode")
    te = tc.encode(torch.from_numpy(x))                          # stacked
    for r in range(3):
        _eq(te.indices[r].numpy(), jc.encode(jnp.asarray(x[r])).indices,
            "stacked indices")


def test_topk_keeps_the_lower_index_on_ties():
    x = torch.tensor([1.0, 3.0, -3.0, 3.0, 2.0, 0.0, -0.0])
    enc = tcodecs.TopK(frac=3 / 7).encode(x)
    assert enc.indices.tolist() == [1, 2, 3]
    _eq(jax.lax.top_k(jnp.abs(jnp.asarray(x.numpy())), 3)[1], [1, 2, 3],
        "lax.top_k")


@pytest.mark.parametrize("frac", [0.01, 0.05, 0.5])
@pytest.mark.parametrize("p", [576, 50_816])
def test_chain_wire_bit_equal(frac, p):
    """Chain (top-k, then int8 of the kept values): one quantize call on the
    stacked (rows, k) values, a padded 256-wide chunk a row when k <= 256."""
    rows = 4
    x = _tied(rows, p, seed=1) * np.float32(0.37)
    jkeys, tkeys = _keys(rows)
    jc = jcodecs.make_codec("topk8", topk_frac=frac)
    tc = tcodecs.make_codec("topk8", topk_frac=frac)
    assert tc.nbytes(p) == jc.nbytes(p)
    tenc, txhat = tc.roundtrip(torch.from_numpy(x), tkeys)
    for r in range(rows):
        jenc, jxhat = jc.roundtrip(jnp.asarray(x[r]), jkeys[r])
        _eq(tenc.indices[r].numpy(), jenc.indices, "indices")
        _eq(tenc.inner.values[r].numpy(), jenc.inner.values, "int8 levels")
        _eq(tenc.inner.scales[r].numpy(), jenc.inner.scales, "scales")
        _eq(txhat[r].numpy(), jxhat, "decoded")
    _eq(tc.decode(tenc, p).numpy(), txhat.numpy(), "decode == roundtrip")


@pytest.mark.parametrize("name", ["topk", "topk8"])
def test_compress_stacked_with_active_bit_equal(name):
    """The client-boundary EF roundtrip on identical pre-codec uploads, with
    a participation mask: wire, decoded uploads and residuals bit-equal;
    non-participants' residuals untouched."""
    rng = np.random.default_rng(9)
    rows = 6
    up = {"w0": rng.standard_normal((rows, 4, 8)).astype(np.float32),
          "w1": (rng.standard_normal((rows, 8, 12)) * 0.3).astype(np.float32)}
    ef = (rng.standard_normal((rows, 128)) * 0.05).astype(np.float32)
    active = np.array([1, 0, 1, 1, 0, 1], np.float32)
    jkeys, tkeys = _keys(rows, seed=4)
    jc = jcodecs.make_codec(name, topk_frac=0.1)
    jenc, jup, jr = jtopo._compress_stacked(
        jc, jax.tree.map(jnp.asarray, up), jnp.asarray(ef), jkeys,
        jnp.asarray(active))
    before = quantize.stochastic_quantize.launches
    tenc, tup, tr = ttopo._compress_stacked(
        tcodecs.make_codec(name, topk_frac=0.1),
        convert.params_from_numpy(up, "cpu"), torch.from_numpy(ef), tkeys,
        torch.from_numpy(active))
    assert quantize.stochastic_quantize.launches == before   # CPU: plain
    for a, b in zip(jax.tree.leaves(tuple(tenc)), jax.tree.leaves(tuple(jenc))):
        _eq(np.asarray(a), b, "wire")
    for k in up:
        _eq(tup[k].numpy(), jup[k], k)
    _eq(tr.numpy(), jr, "residuals")
    _eq(tr.numpy()[active == 0], ef[active == 0], "frozen")


@pytest.mark.parametrize("name", ["topk", "topk8"])
def test_ef_conservation_and_frac_one(name):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((3, 700)).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal((3, 700)).astype(np.float32))
    _, tkeys = _keys(3)
    codec = tcodecs.make_codec(name, topk_frac=0.05)
    _, xhat, new = tef.ef_roundtrip(codec, x, r, tkeys)
    torch.testing.assert_close(xhat + new, x + r)
    assert int((xhat != 0).sum(dim=1).max()) <= codec.nbytes(700)
    dense = tcodecs.TopK(frac=1.0)
    _, xhat, new = tef.ef_roundtrip(dense, x, r)
    assert torch.equal(xhat, x + r) and not new.any()


def test_make_codec_names_and_errors():
    for name in ("topk", "topk8"):
        for frac in (0.01, 0.05):
            tc = tcodecs.make_codec(name, topk_frac=frac)
            jc = jcodecs.make_codec(name, topk_frac=frac)
            assert tc.name == name
            for p in (6, 576, 50_816, 101_632):
                assert tc.nbytes(p) == jc.nbytes(p)
    assert tcodecs.make_codec("int8", chunk=128).chunk == 128
    with pytest.raises(ValueError, match="unknown codec"):
        tcodecs.make_codec("topk16")


@pytest.mark.parametrize("name", [None, "identity", "int8", "int4", "topk",
                                  "topk8"])
@pytest.mark.parametrize("participation", [None, 3, 256, 20])
def test_sample_round_bytes_match(name, participation):
    tc = tcodecs.make_codec(name, topk_frac=0.05)
    jc = jcodecs.make_codec(name, topk_frac=0.05)
    for kw in ({}, {"with_value": True}, {"num_constraints": 2},
               {"with_value": True, "num_constraints": 1}):
        assert tacc.sample_round_bytes(576, 20, tc, participation=participation,
                                       **kw) == jacc.sample_round_bytes(
            576, 20, jc, participation=participation, **kw)


def test_the_slices_upload_bytes():
    """The cohort run's bytes a round at I = 1e6, S = 256, P = 576, and the
    heterogeneous grid's per client at P = 50,816."""
    def up(codec, s=256, **kw):
        return tacc.sample_round_bytes(576, 1_000_000, codec, participation=s,
                                       **kw)["up"]
    assert up(None) == 589_824
    assert up(tcodecs.make_codec("int8")) == 150_528
    assert up(tcodecs.make_codec("topk8")) == 8_704
    assert tcodecs.make_codec("topk8").sparse.k(576) == 6
    assert up(tcodecs.make_codec("int8"), with_value=True) == 150_528 + 4 * 256
    per = {c: tacc.vector_nbytes(50_816, tcodecs.make_codec(c, topk_frac=0.05))
           for c in ("int8", "topk")}
    assert tacc.vector_nbytes(50_816) == 203_264
    assert per == {"int8": 51_612, "topk": 20_328}


# ---------------------------------------------------------------------------
# the keyed EF store
# ---------------------------------------------------------------------------


def test_ef_store_gather_scatter_in_place():
    store = tef.ef_store_init(20, 4, device="cpu")
    data = store.data
    ids = torch.tensor([3, 7, 11], dtype=torch.int32)
    rows = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    new = store.scatter(ids, rows)
    assert new is store and new.data is data          # written in place
    assert torch.equal(new.gather(ids), rows)
    others = torch.tensor([i for i in range(20) if i not in (3, 7, 11)])
    assert not new.gather(others).any()
    assert store.num_clients == 20 and store.dim == 4


def test_ef_store_matches_dense_layout_and_reference():
    """One round of int8 EF: the store's gather/roundtrip/scatter equals the
    dense masked layout, and the reference's store, bit for bit."""
    key = jax.random.PRNGKey(9)
    num_clients, dim, cohort = 16, 8, 5
    tk = convert.key_from_numpy(np.asarray(key), "cpu")
    ids = tfed.cohort_sample(rnd.fold_in(tk, 1), num_clients, cohort)
    uploads = rnd.normal(rnd.fold_in(tk, 2), (num_clients, dim))
    ckeys = tfed.client_keys(rnd.fold_in(tk, 3), torch.arange(num_clients))
    mask = tfed.participation_mask(rnd.fold_in(tk, 1), num_clients, cohort)
    codec = tcodecs.make_codec("int8")
    dense = tef.ef_init_stacked(num_clients, dim, device="cpu")
    _, _, dense1 = tef.ef_roundtrip(codec, uploads, dense, ckeys, mask)
    store = tef.ef_store_init(num_clients, dim, device="cpu")
    sel = ids.long()
    _, _, rows = tef.ef_roundtrip(codec, uploads[sel], store.gather(ids),
                                  ckeys[sel])
    assert torch.equal(store.scatter(ids, rows).data, dense1)

    jstore = jef.ef_store_init(num_clients, dim)
    jids = jnp.asarray(ids.numpy())
    ju = jnp.asarray(uploads.numpy())
    jck = jnp.asarray(convert.key_to_numpy(ckeys))
    _, _, jrows = jax.vmap(
        lambda x, r, k: jef.ef_roundtrip(jcodecs.make_codec("int8"), x, r, k)
    )(ju[jids], jstore.gather(jids), jck[jids])
    _eq(store.data.numpy(), jstore.scatter(jids, jrows).data, "store")


def test_ef_store_host_offload_on_the_cpu():
    a = tef.ef_store_init(8, 3, device="cpu")
    b = tef.ef_store_init(8, 3, host_offload=True, device="cpu")
    assert b.data.device.type == "cpu"
    ids = torch.tensor([1, 6])
    rows = torch.ones((2, 3))
    assert torch.equal(a.scatter(ids, rows).data, b.scatter(ids, rows).data)
