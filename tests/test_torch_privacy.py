"""The port's differential privacy (``core/privacy.py`` and the ``dp=`` stage
of the round functions and drivers) against ``repro.core.privacy`` and the
reference's drivers on the CPU.

Tolerances: the calibration and the accountant are Python floats, held at
rtol 1e-12; ``make_eps_fn``'s fp32 ε at rtol 1e-6. The noise is
``random.normal``'s, whose erfinv differs from XLA's by a few ulps: the
normals of a key agree within NORMAL_GAP (2.1e-5 measured at |n| = 3.76 over
1.3 M draws), so a privatized upload agrees within σ·NORMAL_GAP/s (s the
clip scale) plus 1e-6 relative, and its noise norm within rtol 1e-5. The
driver trajectories (10-24 rounds, from the reference's data and params
carried across as numpy) run a small noise multiplier (0.01), so the erfinv
gap stays under the trajectory standard: params and per-round series atol
1e-5; with int8 + error feedback, losses rtol 1e-3 and params within the
largest EF residual entry (a rounding decision may move by one level),
the roundtrip's wire format being bit-equal on equal inputs.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import codecs as jcodecs
from repro.configs.base import FLConfig as JFLConfig
from repro.core import algorithms as jalg
from repro.core import fed as jfed
from repro.core import privacy as jpriv
from repro.data.synthetic import VirtualFedData as JVirtual
from repro.data.synthetic import classification_dataset as jdataset
from repro.models import mlp as jmlp
from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.comm import codecs as tcodecs
from repro_torch.comm import error_feedback as tef
from repro_torch.configs.base import FLConfig
from repro_torch.core import algorithms as talg
from repro_torch.core import fed as tfed
from repro_torch.core import privacy as tpriv
from repro_torch.data.synthetic import VirtualFedData
from repro_torch.kernels import dp_noise as kdp
from repro_torch.kernels import quantize as kq
from repro_torch.kernels import ref as kref
from repro_torch.models import mlp as tmlp

NORMAL_GAP = 3e-5
P, J, L = 10, 8, 3
I_TRAJ, S_TRAJ, K_TRAJ = 48, 12, 10
FL_KW = dict(batch_size=6, a1=0.9, a2=0.5, alpha_rho=0.1, alpha_gamma=0.6,
             tau=0.2, l2_lambda=1e-5)
FL_C = dict(FL_KW, constrained=True, cost_limit=1.2, penalty_c=1e4)
DP_TRAJ = dict(clip_norm=0.5, noise_multiplier=0.01)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several processes at once: two PyTorch threads a
    process keep them from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)

def _tk(jkey):
    return convert.key_from_numpy(np.asarray(jkey), "cpu")


def _dp(pkg, **kw):
    return (jpriv if pkg == "jax" else tpriv).DPConfig(**kw)


def _close(got, want, atol=0.0, rtol=0.0, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    ok = err <= atol + rtol * np.abs(want)
    assert ok.all(), f"{what}: max abs diff {err.max():.3e}"


# ---------------------------------------------------------------------------
# calibration and accounting (host floats)
# ---------------------------------------------------------------------------

CALIB = [(0.5, 1e-5), (1.0, 1e-6), (4.0, 1e-5), (8.0, 1e-5), (16.0, 1e-3)]


@pytest.mark.parametrize("eps,delta", CALIB)
def test_calibration_matches(eps, delta):
    for fn in ("classical_noise_multiplier", "analytic_gaussian_sigma"):
        got, want = getattr(tpriv, fn)(eps, delta), getattr(jpriv, fn)(eps, delta)
        assert got == pytest.approx(want, rel=1e-12), fn
    for sigma in (0.3, 1.0, 2.5):
        assert tpriv.gaussian_mechanism_delta(eps, sigma) == pytest.approx(
            jpriv.gaussian_mechanism_delta(eps, sigma), rel=1e-12, abs=1e-300)
    for nm in (None, 0.7):
        kw = dict(epsilon=eps, delta=delta, noise_multiplier=nm)
        assert tpriv.noise_multiplier(_dp("torch", **kw)) == pytest.approx(
            jpriv.noise_multiplier(_dp("jax", **kw)), rel=1e-12)


def test_calibration_refuses_bad_arguments():
    for bad in ((0.0, 1e-5), (1.0, 0.0), (1.0, 1.0)):
        with pytest.raises(ValueError):
            tpriv.analytic_gaussian_sigma(*bad)
    with pytest.raises(ValueError):
        tpriv.rdp_per_round(0.0, 1.0)
    with pytest.raises(ValueError):
        tpriv.rdp_per_round(0.5, 0.0)
    with pytest.raises(ValueError):
        tpriv.rdp_per_round(0.5, 1.0, orders=(1,))


@pytest.mark.parametrize("q", [1.0, 0.25, 256 / 1_000_000])
@pytest.mark.parametrize("nm", [0.6, 1.1, 4.0])
def test_accountant_matches(q, nm):
    np.testing.assert_allclose(tpriv.rdp_per_round(q, nm),
                               jpriv.rdp_per_round(q, nm), rtol=1e-12)
    rdp = jpriv.rdp_per_round(q, nm) * 37
    got, want = tpriv.eps_from_rdp(rdp, 1e-5), jpriv.eps_from_rdp(rdp, 1e-5)
    assert got[1] == want[1] and got[0] == pytest.approx(want[0], rel=1e-12)
    assert tpriv.accountant_epsilon(nm, q, 200, 1e-5) == pytest.approx(
        jpriv.accountant_epsilon(nm, q, 200, 1e-5), rel=1e-12)
    for releases in (1, 2):
        kw = dict(epsilon=8.0, delta=1e-5, noise_multiplier=nm)
        np.testing.assert_allclose(
            tpriv.epsilon_schedule(_dp("torch", **kw), q, 30, releases),
            jpriv.epsilon_schedule(_dp("jax", **kw), q, 30, releases),
            rtol=1e-12)
        assert tpriv.manifest_info(_dp("torch", **kw), q, 30, releases) == \
            pytest.approx(jpriv.manifest_info(_dp("jax", **kw), q, 30,
                                              releases), rel=1e-12)


@pytest.mark.parametrize("q,releases", [(1.0, 1), (0.25, 2), (0.01, 1)])
def test_eps_fn_reads_the_round_from_a_tensor(q, releases):
    """ε through round t from the round's own (device) t, as the reference's
    in-graph closure computes it, and its schedule entry for entry."""
    tdp, jdp = _dp("torch", epsilon=4.0), _dp("jax", epsilon=4.0)
    tf = tpriv.make_eps_fn(tdp, q, releases, device="cpu")
    jf = jpriv.make_eps_fn(jdp, q, releases)
    ts = torch.arange(1, 41, dtype=torch.int32)
    got = torch.stack([tf(t) for t in ts])
    assert got.dtype == torch.float32 and got.shape == (40,)
    want = np.array([float(jf(jnp.int32(t))) for t in range(1, 41)])
    _close(got.numpy(), want, rtol=1e-6, what="eps")
    _close(got.numpy(), tpriv.epsilon_schedule(tdp, q, 40, releases),
           rtol=1e-6, what="schedule")


# ---------------------------------------------------------------------------
# the clip->noise stage
# ---------------------------------------------------------------------------


def test_normals_within_the_erfinv_gap():
    k = jax.random.PRNGKey(5)
    jn = np.asarray(jax.random.normal(k, (1 << 20,)))
    tn = rnd.normal(_tk(k), (1 << 20,)).numpy()
    assert np.abs(jn - tn).max() <= NORMAL_GAP


@pytest.mark.parametrize("binding", [True, False])
@pytest.mark.parametrize("with_scale", [True, False])
def test_clip_and_noise_matches(binding, with_scale):
    """Rows scaled so that the clip binds (norm > C) or not, with and
    without the 1/B_i scale; the calibrated σ at ε = 8."""
    rng = np.random.default_rng(7 + binding + 2 * with_scale)
    n, p = 5, 3000
    x = rng.standard_normal((n, p)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x *= (np.array([3.0, 1.5, 8.0, 1.2, 40.0]) if binding
          else np.array([0.3, 0.9, 0.05, 0.5, 0.999]))[:, None]
    scale = (np.array([1 / 4, 1 / 2, 1 / 8, 1.0, 1 / 40], np.float32)
             if with_scale else None)
    if with_scale:
        x /= scale[:, None]
    keys = jax.random.split(jax.random.PRNGKey(11), n)
    jdp, tdp = _dp("jax", clip_norm=1.0, epsilon=8.0), _dp("torch", clip_norm=1.0,
                                                          epsilon=8.0)
    jp, js = jpriv.clip_and_noise(jnp.asarray(x), keys, jdp,
                                  None if scale is None else jnp.asarray(scale))
    tp, ts = tpriv.clip_and_noise(torch.from_numpy(x), _tk(keys), tdp,
                                  None if scale is None
                                  else torch.from_numpy(scale))
    sigma = tpriv.noise_multiplier(tdp) * tdp.clip_norm
    s_min = 1.0 if scale is None else float(scale.min())
    _close(tp.numpy(), jp, atol=sigma * NORMAL_GAP / s_min, rtol=1e-6,
           what="privatized")
    _close(ts["clipped"].numpy(), js["clipped"], what="clipped")
    assert bool(ts["clipped"].all()) == binding
    assert bool(ts["clipped"].any()) == binding
    _close(ts["noise_sq"].numpy(), js["noise_sq"], rtol=1e-5, what="noise_sq")


def test_privatize_flat_and_upload_match():
    rng = np.random.default_rng(3)
    x = rng.standard_normal(5000).astype(np.float32) * 0.05
    k = jax.random.PRNGKey(4)
    jdp, tdp = _dp("jax", clip_norm=2.0, epsilon=2.0), _dp("torch", clip_norm=2.0,
                                                          epsilon=2.0)
    jp, js = jpriv.privatize_flat(jnp.asarray(x), k, jdp)
    tp, ts = tpriv.privatize_flat(torch.from_numpy(x), _tk(k), tdp)
    sigma = tpriv.noise_multiplier(tdp) * 2.0
    _close(tp.numpy(), jp, atol=sigma * NORMAL_GAP, rtol=1e-6, what="flat")
    assert ts["clipped"].shape == () and float(ts["clipped"]) == float(js["clipped"])
    _close(ts["noise_sq"].numpy(), js["noise_sq"], rtol=1e-5, what="noise_sq")
    tree = {"b": rng.standard_normal((3, 4)).astype(np.float32),
            "a": rng.standard_normal(7).astype(np.float32)}
    jt = jpriv.privatize_upload(jax.tree.map(jnp.asarray, tree), k, jdp)
    tt = tpriv.privatize_upload(convert.params_from_numpy(tree, "cpu"), _tk(k),
                                tdp)
    for name in tree:
        _close(tt[name].numpy(), jt[name], atol=sigma * NORMAL_GAP, rtol=1e-6,
               what=name)


def test_dp_noise_plain_version_in_pieces():
    """The kernel's plain version: a long row privatized in pieces at their
    counter offsets equals the whole row, bit for bit, and equals
    clip_and_noise's math."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    key = rnd.PRNGKey(3, device="cpu")
    f, s = torch.tensor(0.25), torch.tensor(0.5)
    whole, sq = kdp.dp_noise(x, key, f, s, 0.7)
    parts = [kdp.dp_noise(x[a:a + 1024], key, f, s, 0.7, offset=a)
             for a in range(0, 4096, 1024)]
    assert torch.equal(torch.cat([p[0] for p in parts]), whole)
    torch.testing.assert_close(sum(p[1] for p in parts), sq, rtol=1e-6, atol=0)
    noise = 0.7 * rnd.normal(key, (4096,))
    assert torch.equal(whole, (x * s * f + noise) / s)
    out = torch.empty_like(x)
    res, _ = kdp.dp_noise(x, key, f, s, 0.7, out=out)
    assert res is out and torch.equal(out, whole)


@pytest.mark.parametrize("rows,p,offset", [(1, 1000, 0), (3, 70_000, 0),
                                           (2, 512, 1024), (1, 300, 256 * 9)])
def test_keyed_quantize_plain_is_the_bits_operand_path(rows, p, offset):
    """stochastic_quantize_keyed's plain version on the CPU equals the
    bits-operand path fed random.bits of the same keys at the same counters,
    bit for bit (the kernel is held to the same on the card)."""
    rng = np.random.default_rng(p)
    x = torch.from_numpy(rng.standard_normal((rows, p)).astype(np.float32))
    keys = rnd.split(rnd.PRNGKey(p, device="cpu"), rows)
    chunks = -(-p // 256)
    bits = rnd.bits(keys, (offset // 256 + chunks, 256))[:, offset // 256:]
    want = kq.stochastic_quantize(x, bits.reshape(rows, -1), 127)
    got = kq.stochastic_quantize_keyed(x, keys, 127, 256, offset)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_codec_keyed_roundtrip_is_unchanged():
    """dp=None and the codecs are what they were: the quantizer's roundtrip
    (now on the keyed path) equals the bits-operand quantize on
    random.bits(key, (C, 256)), and a round without dp carries no stats."""
    x = torch.randn(4, 1000, generator=torch.Generator().manual_seed(0))
    keys = rnd.split(rnd.PRNGKey(8, device="cpu"), 4)
    enc, xhat = tcodecs.make_codec("int8").roundtrip(x, keys)
    want = kref.stochastic_quantize_ref(x, rnd.bits(keys, (4, 256)), 127)
    assert torch.equal(enc.values, want[0]) and torch.equal(xhat, want[2])


# ---------------------------------------------------------------------------
# the round functions
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    key = jax.random.PRNGKey(41)
    kw = dict(n_min=6, n_max=14, num_features=P, num_classes=L)
    jv = JVirtual(jax.random.fold_in(key, 1), I_TRAJ, **kw)
    tv = VirtualFedData(_tk(jax.random.fold_in(key, 1)), I_TRAJ, **kw)
    jd = jv.materialize()
    p0 = {k: np.asarray(v) for k, v in
          jmlp.init(jax.random.fold_in(key, 2), P, J, L).items()}
    rk = jax.random.fold_in(key, 3)
    (z, y, _), _ = jdataset(jax.random.PRNGKey(0), n=300, num_features=12,
                            num_classes=L, test_n=10, noise=4.0)
    fd = jfed.partition_features(z, y, 3)
    fp0 = {k: np.asarray(v) for k, v in
           jmlp.init(jax.random.PRNGKey(1), 12, J, L).items()}
    tfp = convert.feature_params_from_numpy(fp0["w0"], fp0["w1"], 3, "cpu")
    return {"jv": jv, "tv": tv, "jd": jd, "p0": p0, "jkey": rk, "tkey": _tk(rk),
            "td": convert.sample_fed_data_from_numpy(
                *(np.asarray(a) for a in jd), device="cpu"),
            "fd": fd, "tfd": convert.feature_fed_data_from_numpy(
                np.asarray(fd.feature_blocks), np.asarray(fd.labels), "cpu"),
            "tfp": tfp, "jfp": {k: jnp.asarray(v.numpy())
                                for k, v in tfp.items()}}


def _params(setup, pkg, feature=False):
    if feature:
        return setup["jfp"] if pkg == "jax" else setup["tfp"]
    return (jax.tree.map(jnp.asarray, setup["p0"]) if pkg == "jax"
            else convert.params_from_numpy(setup["p0"], "cpu"))


def _grad_tol(dp, batch):
    return tpriv.noise_multiplier(dp) * dp.clip_norm * NORMAL_GAP * batch + 1e-6


@pytest.mark.parametrize("engine", ["dense", "partial", "cohort"])
@pytest.mark.parametrize("codec", [None, "int8"])
def test_sample_and_cohort_round_with_dp(setup, engine, codec):
    """One round with dp= (ε = 8, clip binding): the grad estimate, the
    value and the per-client stats against the reference's; with int8 the
    wire values of the privatized uploads are bit-equal where the
    privatized inputs are."""
    kw = dict(epsilon=8.0, clip_norm=0.05)
    jdp, tdp = _dp("jax", **kw), _dp("torch", **kw)
    extra_j, extra_t = {}, {}
    if codec:
        extra_j["codec"] = jcodecs.make_codec(codec)
        extra_t["codec"] = tcodecs.make_codec(codec)
    if engine == "cohort":
        gj, vj, uj = jfed.cohort_round(jmlp.per_sample_loss, _params(setup, "jax"),
                                       setup["jv"], setup["jkey"], 6, S_TRAJ,
                                       with_value=True, dp=jdp, **extra_j)
        gt, vt, ut = tfed.cohort_round(tmlp.per_sample_loss,
                                       _params(setup, "torch"), setup["tv"],
                                       setup["tkey"], 6, S_TRAJ,
                                       with_value=True, dp=tdp, **extra_t)
    else:
        part = S_TRAJ if engine == "partial" else None
        gj, vj, uj = jfed.sample_round(jmlp.per_sample_loss, _params(setup, "jax"),
                                       setup["jd"], setup["jkey"], 6,
                                       with_value=True, participation=part,
                                       dp=jdp, **extra_j)
        gt, vt, ut = tfed.sample_round(tmlp.per_sample_loss,
                                       _params(setup, "torch"), setup["td"],
                                       setup["tkey"], 6, with_value=True,
                                       participation=part, dp=tdp, **extra_t)
    _close(ut["dp"]["clipped"].numpy(), uj["dp"]["clipped"], what="clipped")
    assert float(ut["dp"]["clipped"].sum()) > 0
    _close(ut["dp"]["noise_sq"].numpy(), uj["dp"]["noise_sq"], rtol=1e-5,
           what="noise_sq")
    _close(vt.item(), float(vj), atol=1e-5, what="value")
    tol = _grad_tol(tdp, 6)
    if codec:   # one level of the quantizer's chunk scale may flip
        tol += float(np.abs(np.asarray(uj["encoded"].scales)).max()) * 6
    for k in gj:
        _close(gt[k].numpy(), gj[k], atol=tol, what=k)


@pytest.mark.parametrize("codec", [None, "int8"])
def test_feature_round_with_dp(setup, codec):
    kw = dict(epsilon=4.0, clip_norm=0.5)
    jdp, tdp = _dp("jax", **kw), _dp("torch", **kw)
    jk = jax.random.PRNGKey(6)
    cj = jcodecs.make_codec(codec) if codec else None
    gj, vj, uj = jfed.feature_round(setup["jfp"], setup["fd"], jk, 16,
                                    jmlp.per_sample_loss_from_h, jmlp.client_h,
                                    codec=cj, dp=jdp)
    gt, vt, ut = tfed.feature_round(setup["tfp"], setup["tfd"], _tk(jk), 16,
                                    tmlp.per_sample_loss_from_h, tmlp.client_h,
                                    codec=tcodecs.make_codec(codec), dp=tdp)
    for k in ("head_clipped", "blocks_clipped"):
        _close(ut["dp"][k].numpy(), uj["dp"][k], what=k)
    for k in ("head_noise_sq", "blocks_noise_sq"):
        _close(ut["dp"][k].numpy(), uj["dp"][k], rtol=1e-5, what=k)
    _close(vt.item(), float(vj), atol=1e-5, what="value")
    tol = _grad_tol(tdp, 1) + (2e-2 if codec else 0.0)
    for k in gj:
        _close(gt[k].numpy(), gj[k], atol=tol, what=k)


def test_dp_sample_round_shim_warns_and_delegates(setup):
    tdp = _dp("torch", epsilon=8.0)
    with pytest.warns(DeprecationWarning, match="FLT004"):
        g, q = tpriv.dp_sample_round(tmlp.per_sample_loss, _params(setup, "torch"),
                                     setup["td"], setup["tkey"], 6, tdp)
    want, _, up = tfed.sample_round(tmlp.per_sample_loss, _params(setup, "torch"),
                                    setup["td"], setup["tkey"], 6, dp=tdp)
    for k in want:
        assert torch.equal(g[k], want[k]) and torch.equal(q[k],
                                                          up["q_grad_sums"][k])


def test_no_dp_rounds_carry_no_stats(setup):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, _, up = tfed.sample_round(tmlp.per_sample_loss, _params(setup, "torch"),
                                     setup["td"], setup["tkey"], 6)
    assert up["dp"] is None


def test_new_helpers_default_to_the_card(monkeypatch):
    """The accountant's device closure and the run manifest do not fall back
    to the CPU by default."""
    from repro_torch.obs import sinks
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tpriv.make_eps_fn(tpriv.DPConfig()),
                 lambda: sinks.run_manifest({})):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def _threefry_np(k0, k1, counters):
    """Threefry-2x32 bits of uint64 counters in numpy uint32 arithmetic."""
    m = np.uint32
    x0, x1 = (counters >> 32).astype(m), counters.astype(m)
    ks = (m(k0), m(k1), m(k0) ^ m(k1) ^ m(0x1BD11BDA))
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    with np.errstate(over="ignore"):
        x0, x1 = x0 + ks[0], x1 + ks[1]
        for i in range(5):
            for r in rot[i % 2]:
                x0 = x0 + x1
                x1 = ((x1 << m(r)) | (x1 >> m(32 - r))) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + m(i + 1)
    return x0 ^ x1


@pytest.mark.parametrize("start", [0, (1 << 31) - 5, (1 << 32) - 3, 5 << 32])
def test_bits_at_any_counter(start):
    """random's threefry (int32 patterns) at counters on both sides of 2^31
    and 2^32, against numpy's uint32 arithmetic: the offsets the keyed
    kernels and the pieces of a long draw take."""
    key = rnd.PRNGKey(77, device="cpu")
    got = rnd._bits_range(key, start, 9).numpy()
    k0, k1 = (int(v) for v in key)
    want = _threefry_np(k0, k1, np.arange(start, start + 9, dtype=np.uint64))
    np.testing.assert_array_equal(got, want.astype(np.int64))
