"""The port's feature-based (vertical FL) stack against the JAX reference on
the CPU: the partitions and MLP helpers, ``feature_round``, its codec
streams and byte accounting, Algorithms 3 and 4, and
``feature_train_loop``, at a small width (P=32, J=16, L=10, I=4, B=20), with
data, weights and keys carried across as numpy.

Tolerances: partitions, batch indices and the int8 wire format bit-equal;
the round's h-exchange and uploads at 1e-5 (fp32 sums in another order);
trajectories over 24 rounds at atol 1e-5 (plus rtol 1e-5), Algorithm 4's
interior ν at rtol 2e-4 for the reason ``test_torch_constrained.py``
gives; int8 + EF: the loss at rtol 1e-3 over 12 rounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import accounting as jacc
from repro.comm import codecs as jcodecs
from repro.configs.base import FLConfig as JFLConfig
from repro.core import algorithms as jalg
from repro.core import fed as jfed
from repro.core import topology as jtopo
from repro.data.synthetic import classification_dataset as jdataset
from repro.launch import train as jtrain
from repro.models import mlp as jmlp
from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.comm import accounting as tacc
from repro_torch.comm import codecs as tcodecs
from repro_torch.configs.base import FLConfig
from repro_torch.core import algorithms as talg
from repro_torch.core import fed as tfed
from repro_torch.core import topology as ttopo
from repro_torch.launch import train as ttrain
from repro_torch.models import mlp as tmlp
from repro_torch.core import privacy as tpriv
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import sinks as tsinks

P, J, L, I, B, N = 32, 16, 10, 4, 20, 400
U_KW = dict(num_clients=I, batch_size=B, a1=0.3, a2=0.3, alpha_rho=0.1,
            alpha_gamma=0.6, tau=0.05, l2_lambda=1e-5)
C_KW = dict(num_clients=I, batch_size=B, a1=0.9, a2=0.5, alpha_rho=0.1,
            alpha_gamma=0.6, tau=0.2, constrained=True, penalty_c=1e5)


def _int8():
    jc = jcodecs.StochasticQuantizer(bits=8, impl="pallas", interpret=True)
    object.__setattr__(jc, "name", "int8")
    return jc, tcodecs.make_codec("int8")


@pytest.fixture(scope="module")
def setup():
    (z, y, _), _ = jdataset(jax.random.PRNGKey(0), n=N, num_features=P,
                            num_classes=L, test_n=50, noise=4.0)
    fd = jfed.partition_features(z, y, I)
    p0 = {k: np.asarray(v) for k, v in jmlp.init(jax.random.PRNGKey(1), P, J,
                                                 L).items()}
    tp = convert.feature_params_from_numpy(p0["w0"], p0["w1"], I, "cpu")
    return {"fd": fd, "z": np.array(z), "y": np.array(y),
            "jp": {k: jnp.asarray(v.numpy()) for k, v in tp.items()},
            "tp": tp, "td": convert.feature_fed_data_from_numpy(
                np.asarray(fd.feature_blocks), np.asarray(fd.labels), "cpu")}


def _close(got, want, atol=1e-5, rtol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=msg)


@pytest.mark.parametrize("p,i", [(784, 10), (32, 4), (30, 4), (7, 3)])
def test_partitions_match(p, i):
    for a, b in zip(tmlp.feature_partition(p, i), jmlp.feature_partition(p, i)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rng = np.random.default_rng(p)
    z = rng.standard_normal((50, p)).astype(np.float32)
    y = np.eye(L, dtype=np.float32)[rng.integers(0, L, 50)]
    jd = jfed.partition_features(jnp.asarray(z), jnp.asarray(y), i)
    td = tfed.partition_features(torch.from_numpy(z), torch.from_numpy(y), i)
    assert td.num_clients == i and td.total == 50
    np.testing.assert_array_equal(td.feature_blocks.numpy(),
                                  np.asarray(jd.feature_blocks))
    np.testing.assert_array_equal(td.labels.numpy(), np.asarray(jd.labels))


def test_feature_params_build_as_paper_experiments():
    """convert.feature_params_from_numpy pads w1 to I·P_i columns and splits
    it as examples/paper_experiments.py does: the blocks' h sums to the
    full network's pre-activation on the padded features."""
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((L, J)).astype(np.float32)
    w1 = rng.standard_normal((J, 30)).astype(np.float32)
    tp = convert.feature_params_from_numpy(w0, w1, 4, "cpu")
    pi = 8
    w1p = jnp.pad(jnp.asarray(w1), ((0, 0), (0, 4 * pi - 30)))
    want = w1p.reshape(J, 4, pi).transpose(1, 0, 2)
    np.testing.assert_array_equal(tp["blocks"].numpy(), np.asarray(want))
    np.testing.assert_array_equal(tp["w0"].numpy(), w0)
    z = rng.standard_normal((5, 30)).astype(np.float32)
    blocks = tfed.partition_features(torch.from_numpy(z),
                                     torch.zeros(5, L), 4).feature_blocks
    h = tmlp.client_h(tp["blocks"], blocks).sum(0)
    _close(h.numpy(), z @ w1.T)


def test_mlp_feature_helpers_match(setup):
    rng = np.random.default_rng(1)
    zb = rng.standard_normal((I, B, 8)).astype(np.float32)
    blocks = setup["tp"]["blocks"]
    th = tmlp.client_h(blocks, torch.from_numpy(zb))
    for i in range(I):
        _close(th[i].numpy(), jmlp.client_h(setup["jp"]["blocks"][i], zb[i]))
    hs = th.sum(0)
    y = np.eye(L, dtype=np.float32)[rng.integers(0, L, B)]
    _close(tmlp.logits_from_h(setup["tp"]["w0"], hs).numpy(),
           jmlp.logits_from_h(setup["jp"]["w0"], jnp.asarray(hs.numpy())))
    _close(tmlp.per_sample_loss_from_h(setup["tp"]["w0"], hs,
                                       torch.from_numpy(y)).numpy(),
           jmlp.per_sample_loss_from_h(setup["jp"]["w0"],
                                       jnp.asarray(hs.numpy()), y))


@pytest.mark.parametrize("seed", [2, 5, 9])
def test_feature_round_dense_matches(setup, seed):
    jkey = jax.random.PRNGKey(seed)
    tkey = convert.key_from_numpy(np.asarray(jkey), "cpu")
    jg, jv, ju = jfed.feature_round(setup["jp"], setup["fd"], jkey, B,
                                    jmlp.per_sample_loss_from_h, jmlp.client_h)
    tg, tv, tu = tfed.feature_round(setup["tp"], setup["td"], tkey, B,
                                    tmlp.per_sample_loss_from_h, tmlp.client_h)
    assert tu["h_exchange"].shape == (I, B, J)
    for k in ("h_exchange", "q_head", "q_blocks"):
        _close(tu[k].numpy(), ju[k], msg=k)
    for k in jg:
        _close(tg[k].numpy(), jg[k], msg=k)
    _close(tv.numpy(), jv)
    assert tu["encoded"] is None and tu["ef"] is None
    assert tu["upload_nbytes"] is None


@pytest.mark.parametrize("seed", [0, 4])
def test_feature_codec_streams_wire_bit_equal(seed):
    """The head stream (a 1-D vector, one key) and the stacked block stream
    (ragged: 24·11 = 264 values a client, not a multiple of the 256-wide
    chunk), identical pre-codec uploads and residuals: equal wire values,
    scales, decoded uploads and residuals."""
    rng = np.random.default_rng(seed)
    q_head = rng.standard_normal((L, 24)).astype(np.float32)
    q_blocks = rng.standard_normal((I, 24, 11)).astype(np.float32)
    ef = {"w0": (rng.standard_normal(L * 24) * 0.1).astype(np.float32),
          "blocks": (rng.standard_normal((I, 264)) * 0.1).astype(np.float32)}
    jc, tc = _int8()
    jkey = jax.random.PRNGKey(seed)
    tkey = convert.key_from_numpy(np.asarray(jkey), "cpu")
    jenc, jh, jb, jr = jtopo._compress_feature(
        jc, jnp.asarray(q_head), jnp.asarray(q_blocks),
        jax.tree.map(jnp.asarray, ef), jax.random.fold_in(jkey, 0),
        jfed.client_keys(jax.random.fold_in(jkey, 1), jnp.arange(I)))
    tenc, th, tb, tr = ttopo._compress_feature(
        tc, torch.from_numpy(q_head), torch.from_numpy(q_blocks),
        {k: torch.from_numpy(v) for k, v in ef.items()}, rnd.fold_in(tkey, 0),
        tfed.client_keys(rnd.fold_in(tkey, 1), torch.arange(I)))
    for stream in ("q_head", "q_blocks"):
        np.testing.assert_array_equal(tenc[stream].values.numpy(),
                                      np.asarray(jenc[stream].values))
        np.testing.assert_array_equal(tenc[stream].scales.numpy(),
                                      np.asarray(jenc[stream].scales))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    for k in ("w0", "blocks"):
        np.testing.assert_array_equal(tr[k].numpy(), np.asarray(jr[k]))
    assert tenc["q_head"].values.shape == (256,)
    assert tenc["q_blocks"].values.shape == (I, 2 * 256)


def test_feature_round_int8_keys_and_bytes(setup):
    """With a codec: the head key fold_in(fold_in(key, 0xC0DEC), 0) and the
    block keys client_keys(fold_in(codec_key, 1), arange(I)), the residual
    shapes, and the exact wire bytes."""
    jc, tc = _int8()
    jkey = jax.random.PRNGKey(7)
    tkey = convert.key_from_numpy(np.asarray(jkey), "cpu")
    ju = jfed.feature_round(setup["jp"], setup["fd"], jkey, B,
                            jmlp.per_sample_loss_from_h, jmlp.client_h,
                            codec=jc)[2]
    tg, _, tu = tfed.feature_round(setup["tp"], setup["td"], tkey, B,
                                   tmlp.per_sample_loss_from_h, tmlp.client_h,
                                   codec=tc)
    assert tu["upload_nbytes"] == ju["upload_nbytes"]
    assert tu["ef"]["w0"].shape == (L * J,) and tu["ef"]["blocks"].shape == (I, J * 8)
    # one decoded upload level apart at most (a 1-ulp gradient difference can
    # move one stochastic rounding decision)
    step = float(np.max(np.asarray(ju["encoded"]["q_head"].scales)))
    _close(tu["q_head"].numpy(), ju["q_head"], atol=step * 1.01, rtol=0)
    with pytest.raises(ValueError, match="without codec"):
        tfed.feature_round(setup["tp"], setup["td"], tkey, B,
                           tmlp.per_sample_loss_from_h, tmlp.client_h,
                           ef=tu["ef"])
    with pytest.raises(ValueError, match="stream 'blocks' have shape"):
        tfed.feature_round(setup["tp"], setup["td"], tkey, B,
                           tmlp.per_sample_loss_from_h, tmlp.client_h,
                           codec=tc, ef={"w0": tu["ef"]["w0"],
                                         "blocks": torch.zeros(I, 3)})


@pytest.mark.parametrize("name", [None, "int8", "int4"])
@pytest.mark.parametrize("dims", [(1280, 10_112, 100, 128, 10), (160, 128, 20, 16, 4)])
def test_feature_round_bytes_match(name, dims):
    d_head, d_block, b, h, i = dims
    jc = None if name is None else jcodecs.make_codec(name)
    tc = tcodecs.make_codec(name)
    assert tacc.feature_round_bytes(d_head, [d_block] * i, b, h, i, tc) == \
        jacc.feature_round_bytes(d_head, [d_block] * i, b, h, i, jc)


def test_paper_width_feature_bytes():
    """Algorithms 3/4 at the paper's width: a head of 1,280 and ten blocks of
    128·79 = 10,112 floats."""
    dense = tacc.feature_round_bytes(1280, [10_112] * 10, 100, 128, 10)
    int8 = tacc.feature_round_bytes(1280, [10_112] * 10, 100, 128, 10,
                                    tcodecs.make_codec("int8"))
    assert dense["up"] == 409_600 and int8["up"] == 104_020


def _run(s, alg, rounds, kw, jcodec=None, tcodec=None):
    jkey = jax.random.PRNGKey(4)
    tkey = convert.key_from_numpy(np.asarray(jkey), "cpu")
    rj = getattr(jalg, alg)(jmlp.per_sample_loss_from_h, jmlp.client_h,
                            s["jp"], s["fd"], JFLConfig(**kw), rounds, jkey,
                            codec=jcodec)
    rt = getattr(talg, alg)(tmlp.per_sample_loss_from_h, tmlp.client_h,
                            s["tp"], s["td"], FLConfig(**kw), rounds, tkey,
                            codec=tcodec, device="cpu")
    return rj, rt


@pytest.mark.parametrize("alg,kw,nu_rtol", [
    ("algorithm3", U_KW, None),
    ("algorithm4", dict(C_KW, cost_limit=1.0), 1e-5),
    ("algorithm4", dict(C_KW, cost_limit=2.2), 2e-4)],
    ids=["alg3", "alg4_nu_clipped", "alg4_nu_interior"])
def test_feature_algorithm_trajectory_matches(setup, alg, kw, nu_rtol):
    rj, rt = _run(setup, alg, 24, kw)
    assert set(rt.history) == set(rj.history)
    for k, v in rj.history.items():
        _close(rt.history[k].numpy(), v,
               rtol=nu_rtol if k == "round_nu" else 1e-5, msg=k)
    for k in rj.params:
        _close(rt.params[k].numpy(), rj.params[k], msg=k)
    assert float(rt.history["round_upload_bytes"][0]) == 4 * (L * J + I * J * 8)
    assert rt.final_state.t == 25
    if nu_rtol is not None:
        nus = rt.history["round_nu"].numpy()
        assert (nus == 1e5).all() if nu_rtol == 1e-5 else (nus < 1e5).any()


@pytest.mark.parametrize("alg,kw", [("algorithm3", U_KW),
                                    ("algorithm4", dict(C_KW, cost_limit=2.2))],
                         ids=["alg3", "alg4"])
def test_feature_algorithm_int8_ef_loss_matches(setup, alg, kw):
    jc, tc = _int8()
    rj, rt = _run(setup, alg, 12, kw, jc, tc)
    _close(rt.history["round_loss_est"].numpy(), rj.history["round_loss_est"],
           atol=0, rtol=1e-3)
    np.testing.assert_array_equal(rt.history["round_upload_bytes"].numpy(),
                                  np.asarray(rj.history["round_upload_bytes"]))
    assert set(rt.final_state.ef) == {"w0", "blocks"}
    assert torch.isfinite(rt.history["round_ef_norm"]).all()


def test_feature_train_loop_matches_reference(capsys):
    """feature_train_loop with the reference's params carried across as
    numpy (its random.normal draw differs from the port's by ulps), Algorithm
    4 for 8 rounds: the eval loss, ν and slack every 4 rounds. The port draws
    the data itself, to a few ulps of the reference's (erfinv)."""
    kw = dict(clients=4, rounds=8, batch=16, features=24, classes=5,
              hidden=8, n=300, constrained=True, cost_limit=1.2, log_every=4)
    key = jax.random.PRNGKey(0)
    w0 = np.asarray(jax.random.normal(key, (5, 8)) * 0.2)
    blocks = np.asarray(jax.random.normal(jax.random.fold_in(key, 1),
                                          (4, 8, 6)) * 0.2)
    rj = jtrain.feature_train_loop(**kw)
    rt = ttrain.feature_train_loop(**kw, device="cpu", params0=convert.params_from_numpy(
        {"w0": w0, "blocks": blocks}, "cpu"))
    for k in ("loss", "nu", "round_loss_est"):
        _close(rt.history[k].numpy(), rj.history[k], atol=1e-4, rtol=1e-4, msg=k)
    out = capsys.readouterr().out
    assert "nu=" in out and "done: 8 rounds" in out


@pytest.mark.parametrize("extra", [[], ["--constrained", "--codec", "int8"]])
def test_feature_cli_smoke(monkeypatch, capsys, extra):
    monkeypatch.setattr("sys.argv", ["train", "--mode", "feature", "--device",
                                     "cpu", "--steps", "4", "--n", "400",
                                     "--features", "24", "--batch", "16",
                                     *extra])
    ttrain.main()
    out = capsys.readouterr().out
    assert "loss=" in out and "done: 4 rounds" in out


@pytest.mark.parametrize("option,item", [("topology", "item 8"), ("dp", "item 7"),
                                         ("obs", "item 9")])
@pytest.mark.parametrize("alg", ["algorithm3", "algorithm4"])
def test_feature_algorithms_refuse_unported_options(setup, alg, option, item):
    """``topology=`` raises; ``dp=`` and ``obs=`` (ported since) run."""
    value = {"topology": object(), "dp": tpriv.DPConfig(epsilon=4.0),
             "obs": tmetrics.MetricStream([tsinks.MemorySink()])}[option]

    def call():
        return getattr(talg, alg)(tmlp.per_sample_loss_from_h, tmlp.client_h,
                                  setup["tp"], setup["td"],
                                  FLConfig(**dict(C_KW, cost_limit=2.0)), 2,
                                  rnd.PRNGKey(0, device="cpu"), device="cpu",
                                  **{option: value})
    if option == "topology":
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP queue 1, {item}"):
            call()
        return
    res = call()
    assert np.isfinite(res.history["round_loss_est"].numpy()).all()
    if option == "obs":
        value.close()
        assert [r["t"] for r in value.rows] == [1, 2]


def test_feature_train_loop_refuses_the_sharded_topology():
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 8"):
        ttrain.feature_train_loop(rounds=1, n=100, topology="sharded",
                                  device="cpu")
