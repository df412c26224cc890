"""Partial participation in the port against the JAX reference on the CPU:
the new random draws (``permutation``, ``loggamma``/``dirichlet``,
``categorical``), the keyed Feistel cohort draw, the partitions, the
participation mask and Horvitz-Thompson weights, and one
``sample_round(participation=)``.

Tolerances: keys, permutations, cohort ids, masks, batch indices, labels
and partition counts are bit-equal. ``dirichlet`` goes through ``normal``'s
erfinv and ``log`` (a few ulps from XLA's), so it is held at rtol 1e-5
(reads up to 4e-6). Weights 1e-7 (the cohort's reweighting rounds in
another order); gradients and values 1e-5 (fp32 sums in another order).
Every failure message carries the largest difference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import codecs as jcodecs
from repro.core import fed as jfed
from repro.models import mlp as jmlp
from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.comm import codecs as tcodecs
from repro_torch.comm import error_feedback as tef
from repro_torch.core import fed as tfed
from repro_torch.kernels import cohort_sample as kcohort
from repro_torch.kernels import ref
from repro_torch.models import mlp as tmlp

P, J, L, I, B = 12, 8, 4, 10, 6


def _keys(seed):
    jk = jax.random.PRNGKey(seed)
    return jk, convert.key_from_numpy(np.asarray(jk), "cpu")


def _tk(jkey):
    return convert.key_from_numpy(np.asarray(jkey), "cpu")


def _eq(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bad = np.flatnonzero(got.ravel() != want.ravel())
    assert bad.size == 0, f"{what}: {bad.size} entries differ, first at {bad[:5]}"


def _close(got, want, atol=0.0, rtol=0.0, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    ok = err <= atol + rtol * np.abs(want)
    assert ok.all(), f"{what}: max abs diff {err.max():.3e}, max rel " \
        f"{(err / np.maximum(np.abs(want), 1e-30)).max():.3e}"


# ---------------------------------------------------------------------------
# random draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 17, 1000, 60_000, 131_072])
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_permutation_bit_equal(n, seed):
    jk, tk = _keys(seed)
    _eq(rnd.permutation(tk, n).numpy(), jax.random.permutation(jk, n),
        f"permutation({n})")


def test_permutation_keeps_xla_order_on_colliding_sort_keys():
    """32-bit sort keys collide (at n = 131,072 about 2 pairs a round): XLA's
    CPU sort_key_val is stable, so colliding elements keep the previous
    round's order, and the stable torch.sort does the same. Seeds are
    searched until each of the two rounds' keys has a tie."""
    n, found = 131_072, 0
    for seed in range(40):
        jk, tk = _keys(seed)
        key, ties = tk, 0
        for _ in range(2):
            key, sub = rnd.split(key).unbind(-2)
            b = rnd.bits(sub, (n,)).numpy()
            ties += b.size - np.unique(b).size > 0
        if ties == 2:
            found += 1
            _eq(rnd.permutation(tk, n).numpy(), jax.random.permutation(jk, n),
                f"permutation with ties, seed {seed}")
        if found == 3:
            break
    assert found == 3, "no seeds with a tie in both rounds"
    # and XLA's sort is stable on a planted tie
    _, vals = jax.lax.sort_key_val(jnp.array([5, 1, 5, 1], jnp.uint32),
                                   jnp.arange(4))
    _eq(vals, [1, 3, 0, 2], "stable sort_key_val")


@pytest.mark.parametrize("alpha", [0.1, 0.5, 1.0, 100.0])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_dirichlet_matches(alpha, seed):
    jk, tk = _keys(seed)
    for n in (4, 10):
        want = jax.random.dirichlet(jk, alpha * jnp.ones((n,)))
        got = rnd.dirichlet(tk, torch.full((n,), alpha))
        _close(got.numpy(), want, rtol=1e-5, what=f"dirichlet({alpha}, {n})")
        _close(got.sum().item(), 1.0, atol=1e-6, what="sum")
    # a batch of keys is jax.vmap over them
    keys = jax.random.split(jk, 7)
    want = jax.vmap(lambda k: jax.random.loggamma(k, alpha * jnp.ones(3)))(keys)
    got = rnd.loggamma(_tk(keys), torch.full((3,), alpha))
    _close(got.numpy(), want, rtol=1e-5, atol=1e-6, what="loggamma batch")


def test_categorical_labels_equal():
    """1,000 rows of 4 classes a seed, 3 seeds: every label equal."""
    for seed in range(3):
        jk, _ = _keys(seed)
        logits = jnp.log(jax.random.dirichlet(jax.random.fold_in(jk, 9),
                                              0.5 * jnp.ones((4,))))
        keys = jax.random.split(jk, 1000)
        want = jax.vmap(lambda k: jax.random.categorical(k, logits))(keys)
        got = rnd.categorical(_tk(keys), torch.from_numpy(np.array(logits)))
        _eq(got.numpy(), want, "categorical")


def test_loggamma_raises_when_a_lane_accepts_nothing(monkeypatch):
    """With one proposal a lane, some of 20,000 lanes reject it (about 5%
    do at alpha = 1): the draw must raise, not return a rejected sample."""
    monkeypatch.setattr(rnd, "GAMMA_STEPS", 1)
    with pytest.raises(RuntimeError, match="accepted no proposal"):
        rnd.loggamma(rnd.PRNGKey(0, device="cpu"), torch.ones(20_000))


def test_loggamma_raises_when_a_proposal_runs_out_of_normal_draws(monkeypatch):
    """With one normal draw a proposal, about 0.4% of proposals at alpha =
    0.1 find no v = 1 + c·x > 0, where jax would draw again: a lane that
    meets one before its accepted proposal must raise, not skip it."""
    monkeypatch.setattr(rnd, "GAMMA_NORMAL_STEPS", 1)
    with pytest.raises(RuntimeError, match="normal draws"):
        rnd.loggamma(rnd.PRNGKey(0, device="cpu"), torch.full((20_000,), 0.1))


# ---------------------------------------------------------------------------
# the keyed Feistel draw
# ---------------------------------------------------------------------------

_EDGES = [0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF, 0x12345678,
          0xDEADBEEF]


def test_feistel_bit_equal_on_edge_values():
    x = np.array(_EDGES, np.uint32)
    keys = np.array([0, 0xFFFFFFFF, 0x9E3779B9, 1, 0x80000000, 7], np.uint32)
    _eq(ref.feistel_mix(torch.from_numpy(x.astype(np.int64))).numpy(),
        np.asarray(jfed._feistel_mix(jnp.asarray(x))).astype(np.int64), "mix")
    for hi, lo in ((4, 4), (10, 10), (16, 16), (11, 10)):
        dom = np.array(_EDGES, np.uint64) % (1 << (hi + lo))
        want = jfed._feistel(jnp.asarray(dom.astype(np.uint32)),
                             jnp.asarray(keys), hi, lo)
        got = ref.feistel(torch.from_numpy(dom.astype(np.int64)),
                          [int(k) for k in keys], hi, lo)
        _eq(got.numpy(), np.asarray(want).astype(np.int64), f"feistel {hi}/{lo}")


GRID = [(n, s) for n in (10, 48, 1000, 1_000_000)
        for s in sorted({1, max(1, n // 4), min(256, n)})]


@pytest.mark.parametrize("num_clients,cohort", GRID)
def test_cohort_sample_and_mask_bit_equal(num_clients, cohort):
    for seed in (0, 5):
        jk, tk = _keys(seed + num_clients)
        ids = tfed.cohort_sample(tk, num_clients, cohort)
        assert ids.dtype == torch.int32
        _eq(ids.numpy(), jfed.cohort_sample(jk, num_clients, cohort), "ids")
        assert len(np.unique(ids.numpy())) == cohort
        if num_clients <= 1000:
            _eq(tfed.participation_mask(tk, num_clients, cohort).numpy(),
                jfed.participation_mask(jk, num_clients, cohort), "mask")


def test_cohort_sample_refuses_a_bad_cohort_as_the_reference():
    _, tk = _keys(0)
    for bad in (0, 11):
        with pytest.raises(ValueError) as want:
            jfed.cohort_sample(jax.random.PRNGKey(0), 10, bad)
        with pytest.raises(ValueError) as got:
            tfed.cohort_sample(tk, 10, bad)
        assert str(got.value) == str(want.value)


def test_cohort_sample_wrapper_takes_the_plain_walk_on_the_cpu():
    _, tk = _keys(4)
    before = kcohort.cohort_sample.launches
    tfed.cohort_sample(tk, 48, 12)
    assert kcohort.cohort_sample.launches == before
    assert kcohort.domain_bits(10) == (4, 4)
    assert kcohort.domain_bits(1_000_000) == (10, 10)
    assert kcohort.domain_bits(2**21 + 1) == (11, 11)
    with pytest.raises(ValueError, match="cohort"):
        kcohort.cohort_sample(torch.zeros(6, dtype=torch.int64), 10, 11)


# ---------------------------------------------------------------------------
# partitions
# ---------------------------------------------------------------------------


def _xy(n, seed=2):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, P)).astype(np.float32)
    y = np.eye(L, dtype=np.float32)[rng.integers(0, L, n)]
    return z, y


@pytest.mark.parametrize("seed", [0, 7])
def test_partition_samples_keyed_matches(seed):
    z, y = _xy(103)
    jk, tk = _keys(seed)
    jd = jfed.partition_samples(jnp.asarray(z), jnp.asarray(y), I, key=jk)
    td = tfed.partition_samples(torch.from_numpy(z), torch.from_numpy(y), I,
                                key=tk)
    for a, b in zip(td, jd):
        _eq(a.numpy(), b)


def test_partition_ragged_matches():
    rng = np.random.default_rng(4)
    sizes = [3, 9, 1, 6]
    feats = [rng.standard_normal((n, P)).astype(np.float32) for n in sizes]
    labs = [np.eye(L, dtype=np.float32)[rng.integers(0, L, n)] for n in sizes]
    jd = jfed.partition_ragged(feats, labs)
    td = tfed.partition_ragged([torch.from_numpy(f) for f in feats],
                               [torch.from_numpy(y) for y in labs])
    for a, b in zip(td, jd):
        _eq(a.numpy(), b)
    td2 = tfed.partition_ragged(feats, labs, device="cpu")   # arrays too
    for a, b in zip(td2, jd):
        _eq(a.numpy(), b)
    with pytest.raises(ValueError, match=">= 1 sample"):
        tfed.partition_ragged([feats[0][:0]], [labs[0][:0]], device="cpu")


@pytest.mark.parametrize("alpha", [100.0, 0.5, 0.1])
def test_partition_dirichlet_counts_equal(alpha):
    """The seed examples/heterogeneous_fl.py partitions with (fold_in(key 0,
    3)) and two more, at its I = 10 and L = 10 on 4,000 samples: counts,
    rows and labels equal."""
    rng = np.random.default_rng(5)
    n, classes = 4000, 10
    z = rng.standard_normal((n, P)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    for jk in (jax.random.fold_in(jax.random.PRNGKey(0), 3),
               jax.random.PRNGKey(1), jax.random.PRNGKey(9)):
        jd = jfed.partition_dirichlet(jnp.asarray(z), jnp.asarray(y), I, jk,
                                      alpha=alpha)
        td = tfed.partition_dirichlet(torch.from_numpy(z), torch.from_numpy(y),
                                      I, _tk(jk), alpha=alpha)
        _eq(td.counts.numpy(), jd.counts, f"counts alpha={alpha}")
        _eq(td.features.numpy(), jd.features, "rows")
        _eq(td.labels.numpy(), jd.labels, "labels")
        assert int(td.counts.sum()) == n


# ---------------------------------------------------------------------------
# weights and one round
# ---------------------------------------------------------------------------


def _data(seed=0):
    rng = np.random.default_rng(seed)
    sizes = [30, 7, 55, 20, 12, 9, 41, 3, 16, 25]
    feats = [rng.standard_normal((n, P)).astype(np.float32) for n in sizes]
    labs = [np.eye(L, dtype=np.float32)[rng.integers(0, L, n)] for n in sizes]
    jd = jfed.partition_ragged(feats, labs)
    return jd, convert.sample_fed_data_from_numpy(
        *(np.asarray(a) for a in jd), device="cpu")


def _params(seed=1):
    rng = np.random.default_rng(seed)
    return {"w0": (rng.standard_normal((L, J)) / 3).astype(np.float32),
            "w1": (rng.standard_normal((J, P)) / 4).astype(np.float32)}


@pytest.mark.parametrize("s", [1, 3, 9])
def test_aggregation_and_cohort_weights_match(s):
    jd, td = _data()
    jk, tk = _keys(s)
    jm = jfed.participation_mask(jk, I, s)
    tm = tfed.participation_mask(tk, I, s)
    _close(tfed.aggregation_weights(td.counts, B, tm).numpy(),
           jfed.aggregation_weights(jd.counts, B, jm), atol=1e-7, what="w")
    ids = tfed.cohort_sample(tk, I, s)
    want = jfed.cohort_weights(jd.counts_for(jnp.asarray(ids.numpy())), B, I,
                               jd.total)
    got = tfed.cohort_weights(td.counts_for(ids), B, I, td.total)
    _close(got.numpy(), want, atol=1e-7, what="cohort w")
    # the cohort's weights are the mask's non-zero entries
    _close(got.numpy(), tfed.aggregation_weights(td.counts, B, tm)[
        ids.long()].numpy(), atol=1e-7, what="cohort vs dense")


@pytest.mark.parametrize("codec", [None, "int8"])
@pytest.mark.parametrize("s", [3, 10, 12])
def test_sample_round_participation_matches(codec, s):
    """S = 3 of 10, and S >= I (full participation, no mask)."""
    jd, td = _data()
    p = _params()
    jk, tk = _keys(5)
    ef = np.random.default_rng(3).standard_normal(
        (I, L * J + J * P)).astype(np.float32) * 0.01
    kw_j, kw_t = {}, {}
    if codec:
        kw_j = dict(codec=jcodecs.make_codec(codec), ef=jnp.asarray(ef))
        kw_t = dict(codec=tcodecs.make_codec(codec), ef=torch.from_numpy(ef))
    gj, vj, uj = jfed.sample_round(jmlp.per_sample_loss,
                                   jax.tree.map(jnp.asarray, p), jd, jk, B,
                                   with_value=True, participation=s, **kw_j)
    gt, vt, ut = tfed.sample_round(tmlp.per_sample_loss,
                                   convert.params_from_numpy(p, "cpu"), td, tk,
                                   B, with_value=True, participation=s, **kw_t)
    for k in gj:
        _close(gt[k].numpy(), gj[k], atol=1e-5, what=k)
    _close(vt.item(), float(vj), atol=1e-5, what="value")
    if s >= I:
        assert ut["participants"] is None and uj["participants"] is None
    else:
        _eq(ut["participants"].numpy(), uj["participants"], "participants")
    if codec:
        assert ut["upload_nbytes"] == uj["upload_nbytes"]
        mask = (ut["participants"].numpy() if s < I else np.ones(I)) > 0
        # non-participants' residuals are bit-frozen
        _eq(ut["ef"].numpy()[~mask], ef[~mask], "frozen residuals")
        _close(ut["ef"].numpy()[mask], np.asarray(uj["ef"])[mask], atol=0.05,
               what="participants' residuals (within a quantization step)")


def test_sample_round_participation_key_defaults_and_override():
    jd, td = _data()
    p = convert.params_from_numpy(_params(), "cpu")
    jk, tk = _keys(8)
    pk_j = jax.random.fold_in(jk, 0x5CA)
    _, _, u = tfed.sample_round(tmlp.per_sample_loss, p, td, tk, B,
                                participation=4)
    _eq(u["participants"].numpy(), jfed.participation_mask(pk_j, I, 4), "mask")
    other = jax.random.PRNGKey(77)
    _, _, u = tfed.sample_round(tmlp.per_sample_loss, p, td, tk, B,
                                participation=4, participation_key=_tk(other))
    _eq(u["participants"].numpy(), jfed.participation_mask(other, I, 4), "key")
    with pytest.raises(ValueError, match="participation must be >= 1"):
        tfed.sample_round(tmlp.per_sample_loss, p, td, tk, B, participation=0)


def test_ef_roundtrip_active_freezes_and_conserves():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((4, 300)).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal((4, 300)).astype(np.float32))
    keys = tfed.client_keys(rnd.PRNGKey(3, device="cpu"), torch.arange(4))
    active = torch.tensor([1.0, 0.0, 1.0, 0.0])
    q = tcodecs.make_codec("int8")
    _, xhat, new = tef.ef_roundtrip(q, x, r, keys, active)
    assert torch.equal(new[1], r[1]) and torch.equal(new[3], r[3])
    torch.testing.assert_close(xhat[0] + new[0], x[0] + r[0])
    _, _, full = tef.ef_roundtrip(q, x, r, keys)
    assert torch.equal(new[0], full[0])


def test_helpers_default_to_the_card(monkeypatch):
    """No entry point or state helper falls back to the CPU by default."""
    from repro_torch.core import rounds
    from repro_torch.configs.base import FLConfig
    from repro_torch.models import layers
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tef.ef_init(3), lambda: tef.ef_init_stacked(2, 3),
                 lambda: tef.ef_store_init(2, 3),
                 lambda: rounds.schedule_arrays(FLConfig(), 1, 2),
                 lambda: layers.rmsnorm_init(4, torch.float32),
                 lambda: tfed.partition_ragged([np.zeros((1, 2))],
                                               [np.zeros((1, 2))])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_explicit_devices_keep_the_callers_matmul_precision(monkeypatch):
    """The helpers a path calls after its entry point (schedule arrays, EF
    state, norm init) take an explicit device as given: a caller that turned
    TF32 on (chip_smoke's control run) keeps it."""
    from repro_torch import device as device_lib
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert device_lib.given_or_card("cuda") == torch.device("cuda")
    assert torch.backends.cuda.matmul.allow_tf32
