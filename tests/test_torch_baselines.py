"""The port's baselines (``core/baselines.py``) against the JAX reference on
the CPU at a small width (P=32, J=16, L=10, I=4, B=20): sample-based SGD
(FedSGD) and SGD-m with E=5 local steps, with and without int8 delta
uploads, feature-based SGD and SGD-m, federated Frank-Wolfe and dual
decomposition, from the same data, weights and keys (numpy), 24 rounds.
Also every entry point's refusal of the options the port has not ported,
and that the sample-based ones now run ``participation=`` and ``cohort=``
as the reference does.

Tolerances: params and every per-round series at atol 1e-5 (plus rtol
1e-5; fp32 sums in another order). With int8 + EF over 12 rounds a 1-ulp
difference in a local step can move a stochastic rounding decision of the
delta upload by one step of its chunk (they read 7.3e-4 apart), so those
params are held to the residuals' largest entry, which is under one step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.comm import codecs as jcodecs
from repro.configs.base import FLConfig as JFLConfig
from repro.core import algorithms as jalg
from repro.core import baselines as jbl
from repro.core import fed as jfed
from repro.data.synthetic import classification_dataset as jdataset
from repro.models import mlp as jmlp
from repro.core import privacy as jpriv
from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.comm import codecs as tcodecs
from repro_torch.configs.base import FLConfig
from repro_torch.core import algorithms as talg
from repro_torch.core import baselines as tbl
from repro_torch.models import mlp as tmlp
from repro_torch.core import privacy as tpriv
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import sinks as tsinks

P, J, L, I, B, N = 32, 16, 10, 4, 20, 400
C_KW = dict(num_clients=I, batch_size=B, a1=0.9, a2=0.5, alpha_rho=0.1,
            alpha_gamma=0.6, tau=0.2, constrained=True, cost_limit=2.2,
            penalty_c=1e5)
FEDSGD = dict(lr_a=0.3, lr_alpha=0.3, local_batch=B)
SGDM = dict(lr_a=0.3, lr_alpha=0.0, momentum=0.1, local_steps=5, local_batch=4)


@pytest.fixture(scope="module")
def setup():
    (z, y, _), (zt, _, lt) = jdataset(jax.random.PRNGKey(0), n=N,
                                      num_features=P, num_classes=L,
                                      test_n=50, noise=4.0)
    jd = jfed.partition_samples(z, y, I)
    fd = jfed.partition_features(z, y, I)
    p0 = {k: np.asarray(v) for k, v in jmlp.init(jax.random.PRNGKey(1), P, J,
                                                 L).items()}
    fp = convert.feature_params_from_numpy(p0["w0"], p0["w1"], I, "cpu")
    return {"jd": jd, "fd": fd, "p0": p0, "z": np.array(z), "y": np.array(y),
            "td": convert.sample_fed_data_from_numpy(
                *(np.asarray(a) for a in jd), device="cpu"),
            "tfd": convert.feature_fed_data_from_numpy(
                np.asarray(fd.feature_blocks), np.asarray(fd.labels), "cpu"),
            "jfp": {k: jnp.asarray(v.numpy()) for k, v in fp.items()},
            "tfp": fp}


def _keys():
    jkey = jax.random.PRNGKey(5)
    return jkey, convert.key_from_numpy(np.asarray(jkey), "cpu")


def _close(got, want, atol=1e-5, rtol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=msg)


def _same(rj, rt, atol=1e-5):
    assert set(rt.history) == set(rj.history)
    for k, v in rj.history.items():
        _close(rt.history[k].numpy(), v, msg=k)
    for k in rj.params:
        _close(rt.params[k].numpy(), rj.params[k], atol=atol, msg=k)


@pytest.mark.parametrize("cfg,momentum", [(FEDSGD, False), (SGDM, True)],
                         ids=["fedsgd", "sgdm_E5"])
def test_sample_sgd_trajectory_matches(setup, cfg, momentum):
    jkey, tkey = _keys()

    def jeval(params, state):
        return {"cost": jmlp.mean_loss(params, setup["z"], setup["y"])}

    def teval(params, state):
        return {"cost": tmlp.mean_loss(params, *(convert.tensor_from_numpy(
            a, "cpu") for a in (setup["z"], setup["y"])))}

    rj = jbl.sample_sgd(jmlp.per_sample_loss,
                        jax.tree.map(jnp.asarray, setup["p0"]), setup["jd"],
                        jbl.SGDConfig(**cfg), 24, jkey, jeval, 8,
                        momentum=momentum)
    rt = tbl.sample_sgd(tmlp.per_sample_loss,
                        convert.params_from_numpy(setup["p0"], "cpu"),
                        setup["td"], tbl.SGDConfig(**cfg), 24, tkey, teval, 8,
                        momentum=momentum, device="cpu")
    _same(rj, rt)
    assert float(rt.history["round_upload_bytes"][0]) == 4 * I * (L * J + J * P)
    assert rt.final_state.t == 25


def test_sample_sgd_int8_delta_uploads_match(setup):
    jkey, tkey = _keys()
    jc = jcodecs.StochasticQuantizer(bits=8, impl="pallas", interpret=True)
    object.__setattr__(jc, "name", "int8")
    rj = jbl.sample_sgd(jmlp.per_sample_loss,
                        jax.tree.map(jnp.asarray, setup["p0"]), setup["jd"],
                        jbl.SGDConfig(**SGDM), 12, jkey, momentum=True,
                        codec=jc)
    rt = tbl.sample_sgd(tmlp.per_sample_loss,
                        convert.params_from_numpy(setup["p0"], "cpu"),
                        setup["td"], tbl.SGDConfig(**SGDM), 12, tkey,
                        momentum=True, codec=tcodecs.make_codec("int8"),
                        device="cpu")
    np.testing.assert_array_equal(rt.history["round_upload_bytes"].numpy(),
                                  np.asarray(rj.history["round_upload_bytes"]))
    # a rounding decision that flips moves a client's delta by one step of
    # its chunk, and the residuals' largest entry (2.8e-3 here) is under one
    step = float(np.abs(np.asarray(rj.final_state.ef)).max())
    for k in rj.params:
        _close(rt.params[k].numpy(), rj.params[k], atol=step, rtol=0, msg=k)
    assert tuple(rt.final_state.ef.shape) == (I, L * J + J * P)


@pytest.mark.parametrize("momentum", [False, True], ids=["sgd", "sgdm"])
def test_feature_sgd_trajectory_matches(setup, momentum):
    jkey, tkey = _keys()
    cfg = dict(FEDSGD, momentum=0.1) if momentum else FEDSGD
    rj = jbl.feature_sgd(jmlp.per_sample_loss_from_h, jmlp.client_h,
                         setup["jfp"], setup["fd"], jbl.SGDConfig(**cfg), 24,
                         jkey, momentum=momentum)
    rt = tbl.feature_sgd(tmlp.per_sample_loss_from_h, tmlp.client_h,
                         setup["tfp"], setup["tfd"], tbl.SGDConfig(**cfg), 24,
                         tkey, momentum=momentum, device="cpu")
    _same(rj, rt)
    assert float(rt.history["round_upload_bytes"][0]) == 4 * (L * J + I * J * 8)


def test_feature_frank_wolfe_trajectory_matches(setup):
    jkey, tkey = _keys()
    rj = jbl.feature_frank_wolfe(jmlp.per_sample_loss_from_h, jmlp.client_h,
                                 setup["jfp"], setup["fd"], JFLConfig(**C_KW),
                                 jbl.FWConfig(), 24, jkey)
    rt = tbl.feature_frank_wolfe(tmlp.per_sample_loss_from_h, tmlp.client_h,
                                 setup["tfp"], setup["tfd"], FLConfig(**C_KW),
                                 tbl.FWConfig(), 24, tkey, device="cpu")
    _same(rj, rt)


def test_feature_dual_decomposition_trajectory_matches(setup):
    jkey, tkey = _keys()
    rj = jbl.feature_dual_decomposition(
        jmlp.per_sample_loss_from_h, jmlp.client_h, setup["jfp"], setup["fd"],
        JFLConfig(**C_KW), jbl.DualConfig(), 24, jkey)
    rt = tbl.feature_dual_decomposition(
        tmlp.per_sample_loss_from_h, tmlp.client_h, setup["tfp"], setup["tfd"],
        FLConfig(**C_KW), tbl.DualConfig(), 24, tkey, device="cpu")
    _same(rj, rt)
    assert float(rt.final_state.nu) > 0


def _sample_kw(s):
    return dict(per_sample_loss=tmlp.per_sample_loss,
                params0=convert.params_from_numpy(s["p0"], "cpu"), data=s["td"],
                rounds=1, key=rnd.PRNGKey(0, device="cpu"), device="cpu")


REFUSALS = [("participation", 2, "item 1"), ("cohort", True, "item 3"),
            ("topology", object(), "item 8"), ("dp", "DPConfig", "item 7"),
            ("obs", "MetricStream", "item 9")]
SAMPLE_REFUSALS = [(entry, *r) for entry in ("algorithm1", "algorithm2",
                                             "algorithm2_general", "sample_sgd")
                   for r in REFUSALS
                   if not (entry == "sample_sgd" and r[0] == "dp")]


def _entry_call(pkg, entry, kw, extra):
    """One call of a sample-based entry point of the port (pkg "torch") or
    the reference ("jax") with keywords ``kw`` plus ``extra``."""
    alg, bl, fl = ((talg, tbl, FLConfig) if pkg == "torch"
                   else (jalg, jbl, JFLConfig))
    if entry == "sample_sgd":
        return lambda: bl.sample_sgd(cfg=bl.SGDConfig(), **kw, **extra)
    if entry == "algorithm2_general":
        kw = dict(kw)
        loss = kw.pop("per_sample_loss")
        return lambda: alg.algorithm2_general(loss, loss, fl=fl(**C_KW), **kw,
                                              **extra)
    return lambda: getattr(alg, entry)(fl=fl(**C_KW), **kw, **extra)


@pytest.mark.parametrize("entry,option,value,item", SAMPLE_REFUSALS,
                         ids=[f"{r[0]}-{r[1]}" for r in SAMPLE_REFUSALS])
def test_sample_entry_points_refuse_unported_options(setup, entry, option,
                                                     value, item):
    """Each option the reference's entry point takes and the port has not
    ported (``topology=``) raises (the reference's sample_sgd takes no dp=).
    The options ported since run 2 rounds and match the reference's params
    at 1e-5: ``participation=2``, ``cohort=True`` (with participation=2),
    ``dp=`` (a 0.01 noise multiplier) and ``obs=`` (a MetricStream, which
    leaves the run unchanged)."""
    kw = _sample_kw(setup)
    if option == "topology":
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP queue 1, {item}"):
            _entry_call("torch", entry, kw, {option: value})()
        return
    extra_t = extra_j = {"participation": 2, **(
        {"cohort": True} if option == "cohort" else {})}
    if option == "dp":
        dp = dict(clip_norm=0.5, noise_multiplier=0.01)
        extra_t, extra_j = ({"dp": tpriv.DPConfig(**dp)},
                            {"dp": jpriv.DPConfig(**dp)})
    if option == "obs":
        extra_t = {"obs": tmetrics.MetricStream([tsinks.MemorySink()])}
        extra_j = {}
    kw["rounds"] = 2
    rt = _entry_call("torch", entry, kw, extra_t)()
    jkw = dict(kw, params0=jax.tree.map(jnp.asarray, setup["p0"]),
               data=setup["jd"], key=jax.random.PRNGKey(0),
               per_sample_loss=jmlp.per_sample_loss)
    jkw.pop("device")
    rj = _entry_call("jax", entry, jkw, extra_j)()
    for k in rj.params:
        _close(rt.params[k].numpy(), rj.params[k], msg=k)
    if option == "obs":
        extra_t["obs"].close()
        rows = extra_t["obs"].sinks[0].rows
        assert [r["t"] for r in rows if r["kind"] == "round"] == [1, 2]


@pytest.mark.parametrize("entry", ["feature_sgd", "feature_frank_wolfe",
                                   "feature_dual_decomposition"])
@pytest.mark.parametrize("option,item", [("topology", "item 8"),
                                         ("obs", "item 9")])
def test_feature_baselines_refuse_unported_options(setup, entry, option, item):
    """``topology=`` raises; ``obs=`` (ported since) streams the rounds."""
    extra = ({"cfg": tbl.SGDConfig()} if entry == "feature_sgd" else
             {"fl": FLConfig(**C_KW), "cfg": (tbl.FWConfig() if "wolfe" in entry
                                              else tbl.DualConfig())})

    def call(value):
        return getattr(tbl, entry)(tmlp.per_sample_loss_from_h, tmlp.client_h,
                                   setup["tfp"], setup["tfd"], rounds=1,
                                   key=rnd.PRNGKey(0, device="cpu"),
                                   device="cpu", **extra, **{option: value})
    if option == "topology":
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP queue 1, {item}"):
            call(object())
        return
    stream = tmetrics.MetricStream([tsinks.MemorySink()])
    call(stream)
    stream.close()
    assert [r["t"] for r in stream.rows] == [1]