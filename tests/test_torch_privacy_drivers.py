"""The port's drivers with ``dp=`` against the reference's on the CPU:
Algorithms 1, 2, 2 (general), 3 and 4, dense and int8 + error feedback,
over 10 rounds, the cohort engine, dense == cohort, and ``dp=None``
unchanged. The setup and tolerances are ``test_torch_privacy.py``'s: a
small noise multiplier (0.01) keeps erfinv's ulps under the trajectory
standard, params and per-round series atol 1e-5; with int8 + error
feedback, losses rtol 1e-3 and params within the largest EF residual.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import codecs as jcodecs
from repro.configs.base import FLConfig as JFLConfig
from repro.core import algorithms as jalg
from repro.core import fed as jfed
from repro.data.synthetic import VirtualFedData as JVirtual
from repro.data.synthetic import classification_dataset as jdataset
from repro.models import mlp as jmlp
from repro_torch import convert
from repro_torch.comm import codecs as tcodecs
from repro_torch.comm import error_feedback as tef
from repro_torch.configs.base import FLConfig
from repro_torch.core import algorithms as talg
from repro_torch.data.synthetic import VirtualFedData
from repro_torch.models import mlp as tmlp
from test_torch_privacy import (DP_TRAJ, FL_C, FL_KW, I_TRAJ, J, K_TRAJ, L, P,
                                S_TRAJ, _close, _dp, _params, _tk)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several processes at once: two PyTorch threads a
    process keep them from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)

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


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------

DRIVERS = ["algorithm1", "algorithm1_int8", "algorithm1_partial",
           "algorithm2", "algorithm2_int8", "algorithm2_general",
           "algorithm2_general_int8", "algorithm3", "algorithm3_int8",
           "algorithm4", "algorithm4_int8"]


def _run(pkg, name, setup, cohort=False, dp=DP_TRAJ, rounds=K_TRAJ):
    j = pkg == "jax"
    alg, mlp = (jalg, jmlp) if j else (talg, tmlp)
    key = setup["jkey"] if j else setup["tkey"]
    kw = {} if j else {"device": "cpu"}
    if dp is not None:
        kw["dp"] = _dp(pkg, **dp)
    if name.endswith("int8"):
        kw["codec"] = (jcodecs if j else tcodecs).make_codec("int8")
    constrained = "algorithm2" in name or "algorithm4" in name
    fl = (JFLConfig if j else FLConfig)(**(FL_C if constrained else FL_KW))
    if name.startswith(("algorithm3", "algorithm4")):
        data = setup["fd"] if j else setup["tfd"]
        fn = alg.algorithm4 if constrained else alg.algorithm3
        return fn(mlp.per_sample_loss_from_h, mlp.client_h,
                  _params(setup, pkg, True), data, fl, rounds, key, **kw)
    if "partial" in name or cohort:
        kw["participation"] = S_TRAJ
    if cohort:
        kw["cohort"] = True
    data = (setup["jd"] if j else setup["td"]) if not cohort else (
        setup["jv"] if j else setup["tv"])
    psl = mlp.per_sample_loss
    p0 = _params(setup, pkg)
    if name.startswith("algorithm2_general"):
        return alg.algorithm2_general(psl, psl, p0, data, fl, rounds, key, **kw)
    if name.startswith("algorithm2"):
        return alg.algorithm2(psl, p0, data, fl, rounds, key, **kw)
    return alg.algorithm1(psl, p0, data, fl, rounds, key, **kw)


def _ef_max(ef):
    if isinstance(ef, dict):
        return max(_ef_max(v) for v in ef.values())
    ef = getattr(ef, "data", ef)
    return float(np.abs(np.asarray(ef)).max())


@pytest.mark.parametrize("name", DRIVERS)
def test_driver_with_dp_matches_reference(setup, name):
    rj = _run("jax", name, setup)
    rt = _run("torch", name, setup)
    for k in ("round_dp_epsilon", "round_dp_clip_frac", "round_dp_noise_norm"):
        assert k in rt.history and k in rj.history, k
    _close(rt.history["round_dp_epsilon"].numpy(), rj.history["round_dp_epsilon"],
           rtol=1e-6, what="dp_epsilon")
    _close(rt.history["round_dp_noise_norm"].numpy(),
           rj.history["round_dp_noise_norm"], rtol=1e-5, what="dp_noise_norm")
    if name.endswith("int8"):
        step = _ef_max(rj.final_state.ef)
        for k in rj.params:
            _close(rt.params[k].numpy(), rj.params[k], atol=step, what=k)
        for k in ("round_loss_est", "round_cons_est"):
            if k in rj.history:
                _close(rt.history[k].numpy(), rj.history[k], rtol=1e-3, what=k)
        _close(rt.history["round_upload_bytes"].numpy(),
               rj.history["round_upload_bytes"], what="upload bytes")
        return
    assert set(rt.history) == set(rj.history)
    for k in rj.params:
        _close(rt.params[k].numpy(), rj.params[k], atol=1e-5, what=k)
    for k, v in rj.history.items():
        if k.startswith("round_") and k not in ("round_t", "round_slack"):
            _close(rt.history[k].numpy(), v, atol=1e-5, rtol=1e-5, what=k)


@pytest.mark.parametrize("name", ["algorithm1", "algorithm1_int8",
                                  "algorithm2_int8"])
def test_cohort_driver_with_dp_matches_reference(setup, name):
    rj = _run("jax", name, setup, cohort=True)
    rt = _run("torch", name, setup, cohort=True)
    _close(rt.history["round_dp_epsilon"].numpy(), rj.history["round_dp_epsilon"],
           rtol=1e-6, what="dp_epsilon (q = S/I)")
    atol = _ef_max(rj.final_state.ef) if name.endswith("int8") else 1e-5
    for k in rj.params:
        _close(rt.params[k].numpy(), rj.params[k], atol=atol, what=k)


@pytest.mark.parametrize("codec", [None, "int8"])
def test_dense_equals_cohort_with_dp(setup, codec):
    """The noise keys come from the stable client ids: the dense S-of-I
    engine (on the materialized population) and the cohort engine draw the
    same noise for the same client, and their trajectories agree at the
    cross-engine 1e-5."""
    kw = dict(participation=S_TRAJ, codec=tcodecs.make_codec(codec),
              dp=_dp("torch", **DP_TRAJ), device="cpu")
    run = [talg.algorithm1(tmlp.per_sample_loss, _params(setup, "torch"),
                           data, FLConfig(**FL_KW), K_TRAJ, setup["tkey"],
                           cohort=cohort, **kw)
           for data, cohort in ((setup["tv"].materialize(), False),
                                (setup["tv"], True))]
    for k in run[0].params:
        _close(run[1].params[k].numpy(), run[0].params[k].numpy(), atol=1e-5,
               what=k)
    _close(run[1].history["round_dp_noise_norm"].numpy(),
           run[0].history["round_dp_noise_norm"].numpy(), rtol=1e-5,
           what="noise norm")


def test_dp_none_is_unchanged(setup):
    """dp=None runs the round exactly as before: bit-equal to a call without
    the keyword, and no dp_* series."""
    a = _run("torch", "algorithm1_int8", setup, dp=None, rounds=4)
    b = talg.algorithm1(tmlp.per_sample_loss, _params(setup, "torch"),
                        setup["td"], FLConfig(**FL_KW), 4, setup["tkey"],
                        codec=tcodecs.make_codec("int8"), device="cpu")
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])
    assert not any(k.startswith("round_dp") for k in a.history)
    assert isinstance(a.final_state.ef, torch.Tensor)
    assert not isinstance(a.final_state.ef, tef.EFStore)
