"""The port's O(S) cohort engine against the JAX reference on the CPU: the
virtual population (``VirtualFedData``), ``cohort_round``, every
sample-based driver over 10 rounds on the dense S-of-I engine and on the
cohort engine, the dense engine against the cohort engine inside the port
(``tests/test_cohort.py``'s equalities), ``cohort_train_loop`` and the
options still refused.

Tolerances: counts, totals, labels, cohort ids and batch indices are
bit-equal; ``VirtualFedData`` features within 1e-5 (``normal`` goes through
erfinv, a few ulps from XLA's). Trajectories run from the reference's
``materialize()``d data carried across as numpy: params atol 1e-5 (fp32 sums
in another order). With int8 + error feedback a 1-ulp gradient difference
can move a stochastic-rounding decision by one level, which feeds back
through the residuals: losses are held at rtol 1e-3 and params within the
largest residual entry (under one quantization step), the wire format being
bit-equal on equal inputs (``tests/test_torch_topk.py``). Every failure
message carries the largest difference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import codecs as jcodecs
from repro.comm import error_feedback as jef
from repro.configs.base import FLConfig as JFLConfig
from repro.core import algorithms as jalg
from repro.core import baselines as jbl
from repro.core import fed as jfed
from repro.core import local_updates as jlocal
from repro.data.synthetic import VirtualFedData as JVirtual
from repro.launch import train as jtrain
from repro.models import mlp as jmlp
from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.comm import codecs as tcodecs
from repro_torch.comm import error_feedback as tef
from repro_torch.configs.base import FLConfig
from repro_torch.core import algorithms as talg
from repro_torch.core import baselines as tbl
from repro_torch.core import fed as tfed
from repro_torch.core import local_updates as tlocal
from repro_torch.core import privacy as tpriv
from repro_torch.data.synthetic import VirtualFedData
from repro_torch.kernels import cohort_sample as kcohort
from repro_torch.launch import train as ttrain
from repro_torch.models import mlp as tmlp

P, J, L = 10, 8, 3
I_TRAJ, S_TRAJ, K_TRAJ = 48, 12, 10
FL_KW = dict(batch_size=6, a1=0.9, a2=0.5, alpha_rho=0.1, alpha_gamma=0.6,
             tau=0.2, l2_lambda=1e-5)
FL_C = dict(FL_KW, constrained=True, cost_limit=1.2, penalty_c=1e4)
SGD = dict(local_steps=2, local_batch=4)


def _tk(jkey):
    return convert.key_from_numpy(np.asarray(jkey), "cpu")


def _close(got, want, atol=0.0, rtol=0.0, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    ok = err <= atol + rtol * np.abs(want)
    assert ok.all(), f"{what}: max abs diff {err.max():.3e}"


def _eq(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bad = np.flatnonzero(got.ravel() != want.ravel())
    assert bad.size == 0, f"{what}: {bad.size} entries differ, first at {bad[:5]}"


def _virtual(jkey, num_clients, **kw):
    kw = dict(dict(n_min=6, n_max=14, num_features=P, num_classes=L), **kw)
    return (JVirtual(jkey, num_clients, **kw),
            VirtualFedData(_tk(jkey), num_clients, **kw))


@pytest.fixture(scope="module")
def setup():
    key = jax.random.PRNGKey(31)
    jv, tv = _virtual(jax.random.fold_in(key, 1), I_TRAJ)
    jd = jv.materialize()
    p0 = {k: np.asarray(v) for k, v in
          jmlp.init(jax.random.fold_in(key, 2), P, J, L).items()}
    rk = jax.random.fold_in(key, 3)
    return {"jv": jv, "tv": tv, "jd": jd, "p0": p0, "jkey": rk, "tkey": _tk(rk),
            "td": convert.sample_fed_data_from_numpy(
                *(np.asarray(a) for a in jd), device="cpu")}


# ---------------------------------------------------------------------------
# the virtual population
# ---------------------------------------------------------------------------


def test_virtual_data_matches_reference(setup):
    jv, tv = setup["jv"], setup["tv"]
    assert tv.total == jv.total
    ids = np.array([0, 17, 47, 3], np.int32)
    jids, tids = jnp.asarray(ids), torch.from_numpy(ids)
    _eq(tv.counts_for(tids).numpy(), jv.counts_for(jids), "counts")
    idx = np.array([[0, 1, 2], [3, 0, 1], [2, 2, 2], [1, 0, 4]], np.int32)
    zj, yj = jv.batch_rows(jids, jnp.asarray(idx))
    zt, yt = tv.batch_rows(tids, torch.from_numpy(idx))
    _eq(yt.numpy(), yj, "labels")
    _close(zt.numpy(), zj, atol=1e-5, what="features")
    for a, b, what in zip(tv.shards_for(tids), jv.shards_for(jids),
                          ("features", "labels", "counts")):
        _close(a.numpy(), b, atol=1e-5 if what == "features" else 0.0,
               what=what)
    dense = tv.materialize()
    for a, b in zip(dense.shards_for(tids), tv.shards_for(tids)):
        assert torch.equal(a, b)
    jd = setup["jd"]
    _eq(dense.counts.numpy(), jd.counts, "materialized counts")
    _eq(dense.labels.numpy(), jd.labels, "materialized labels")
    _close(dense.features.numpy(), jd.features, atol=1e-5, what="materialized")


def test_virtual_data_million_clients_total_and_refusal():
    jv, tv = _virtual(jax.random.PRNGKey(1), 1_000_000, num_features=32,
                      num_classes=4, n_min=8, n_max=32)
    assert tv.total == jv.total > 0
    with pytest.raises(ValueError, match="materialize"):
        tv.materialize()
    ids = np.array([0, 999_999, 123_457], np.int32)
    _eq(tv.counts_for(torch.from_numpy(ids)).numpy(),
        jv.counts_for(jnp.asarray(ids)), "counts at I = 1e6")


def test_virtual_data_ragged_counts():
    _, tv = _virtual(jax.random.PRNGKey(2), 200, n_min=3, n_max=9)
    counts = tv.counts_for(torch.arange(200)).numpy()
    assert counts.min() >= 3 and counts.max() <= 9 and len(set(counts)) > 1
    with pytest.raises(ValueError, match="n_min"):
        VirtualFedData(rnd.PRNGKey(0, device="cpu"), 10, n_min=5, n_max=4)


# ---------------------------------------------------------------------------
# one cohort round
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec", [None, "int8", "topk8"])
def test_cohort_round_matches(setup, codec):
    """cohort_round against the reference's (virtual data), and against the
    port's dense sample_round(participation=S) on the same keys."""
    params = jax.tree.map(jnp.asarray, setup["p0"])
    tp = convert.params_from_numpy(setup["p0"], "cpu")
    dim = L * J + J * P
    kw_j, kw_t, store = {}, {}, None
    if codec:
        store = tef.ef_store_init(I_TRAJ, dim, device="cpu")
        kw_j = dict(codec=jcodecs.make_codec(codec, topk_frac=0.1),
                    ef=jef.ef_store_init(I_TRAJ, dim))
        kw_t = dict(codec=tcodecs.make_codec(codec, topk_frac=0.1), ef=store)
    gj, vj, uj = jfed.cohort_round(jmlp.per_sample_loss, params, setup["jv"],
                                   setup["jkey"], 6, S_TRAJ, with_value=True,
                                   **kw_j)
    gt, vt, ut = tfed.cohort_round(tmlp.per_sample_loss, tp, setup["tv"],
                                   setup["tkey"], 6, S_TRAJ, with_value=True,
                                   **kw_t)
    _eq(ut["cohort"].numpy(), uj["cohort"], "ids")
    for k in gj:
        _close(gt[k].numpy(), gj[k], atol=1e-5, what=k)
    _close(vt.item(), float(vj), atol=1e-5, what="value")
    assert ut["upload_nbytes"] == uj["upload_nbytes"]
    if codec:
        assert ut["ef"] is store
        rows = store.data.any(dim=1).nonzero()[:, 0].sort().values
        _eq(rows.numpy(), np.sort(ut["cohort"].numpy()), "rows written")
        for leaf in jax.tree.leaves(jax.tree.map(np.asarray, tuple(
                ut["encoded"]), is_leaf=lambda t: isinstance(t, torch.Tensor))):
            assert leaf.shape[0] == S_TRAJ
    # the dense engine on the same keys: same clients, aggregates to 1e-5
    if codec:
        kw_t["ef"] = tef.ef_init_stacked(I_TRAJ, dim, device="cpu")
    gd, vd, ud = tfed.sample_round(tmlp.per_sample_loss, tp, setup["td"],
                                   setup["tkey"], 6, with_value=True,
                                   participation=S_TRAJ, **kw_t)
    _eq(np.flatnonzero(ud["participants"].numpy()),
        np.sort(ut["cohort"].numpy()), "dense mask vs cohort ids")
    for k in gd:
        _close(gt[k].numpy(), gd[k].numpy(), atol=1e-5, what=f"dense {k}")
    _close(vt.item(), vd.item(), atol=1e-5, what="dense value")


def test_cohort_round_refuses_dense_ef_and_ef_without_codec(setup):
    tp = convert.params_from_numpy(setup["p0"], "cpu")
    dense = tef.ef_init_stacked(I_TRAJ, L * J + J * P, device="cpu")
    with pytest.raises(ValueError, match="EFStore"):
        tfed.cohort_round(tmlp.per_sample_loss, tp, setup["tv"],
                          setup["tkey"], 6, 8,
                          codec=tcodecs.make_codec("int8"), ef=dense)
    with pytest.raises(ValueError, match="without codec"):
        tfed.cohort_round(tmlp.per_sample_loss, tp, setup["tv"],
                          setup["tkey"], 6, 8, ef=dense)
    before = kcohort.cohort_sample.launches
    tfed.cohort_round(tmlp.per_sample_loss, tp, setup["tv"], setup["tkey"], 6, 8)
    assert kcohort.cohort_sample.launches == before       # CPU: plain walk


# ---------------------------------------------------------------------------
# trajectories: port against JAX, dense S-of-I and cohort
# ---------------------------------------------------------------------------

DRIVERS = ["algorithm1", "algorithm1_int8", "algorithm2_int8",
           "algorithm2_general_int8", "sample_sgd_int8", "algorithm1_local"]


def _run(pkg, name, setup, cohort):
    """One driver of the JAX package (pkg "jax") or the port ("torch")."""
    j = pkg == "jax"
    alg, bl, loc, mlp = ((jalg, jbl, jlocal, jmlp) if j
                         else (talg, tbl, tlocal, tmlp))
    data = setup["jd"] if j else setup["td"]
    p0 = (jax.tree.map(jnp.asarray, setup["p0"]) if j
          else convert.params_from_numpy(setup["p0"], "cpu"))
    key = setup["jkey"] if j else setup["tkey"]
    kw = dict(participation=S_TRAJ, cohort=cohort)
    if not j:
        kw["device"] = "cpu"
    if name.endswith("int8"):
        kw["codec"] = (jcodecs if j else tcodecs).make_codec("int8")
    fl = (JFLConfig if j else FLConfig)(**(FL_C if "algorithm2" in name
                                           else FL_KW))
    psl = mlp.per_sample_loss
    if name.startswith("algorithm1_local"):
        return loc.algorithm1_local(psl, p0, data, fl, K_TRAJ, key,
                                    local_steps=2, **kw)
    if name.startswith("algorithm1"):
        return alg.algorithm1(psl, p0, data, fl, K_TRAJ, key, **kw)
    if name.startswith("algorithm2_general"):
        return alg.algorithm2_general(psl, psl, p0, data, fl, K_TRAJ, key, **kw)
    if name.startswith("algorithm2"):
        return alg.algorithm2(psl, p0, data, fl, K_TRAJ, key, **kw)
    return bl.sample_sgd(psl, p0, data, bl.SGDConfig(**SGD), K_TRAJ, key, **kw)


def _ef_data(ef):
    if isinstance(ef, dict):
        return np.concatenate([_ef_data(ef[k]) for k in sorted(ef)])
    ef = ef.data if isinstance(ef, (tef.EFStore, jef.EFStore)) else ef
    return np.asarray(ef.numpy() if isinstance(ef, torch.Tensor) else ef)


@pytest.mark.parametrize("cohort", [False, True], ids=["dense", "cohort"])
@pytest.mark.parametrize("name", DRIVERS)
def test_trajectory_matches_reference(setup, name, cohort):
    rj = _run("jax", name, setup, cohort)
    rt = _run("torch", name, setup, cohort)
    if name.endswith("int8"):
        step = float(np.abs(_ef_data(rj.final_state.ef)).max())
        for k in rj.params:
            _close(rt.params[k].numpy(), rj.params[k], atol=step, what=k)
        for k in ("round_loss_est", "round_cons_est"):
            if k in rj.history:
                _close(rt.history[k].numpy(), rj.history[k], rtol=1e-3, what=k)
        _eq(rt.history["round_upload_bytes"].numpy(),
            rj.history["round_upload_bytes"], "upload bytes")
        if "round_ef_norm" in rj.history:
            _close(rt.history["round_ef_norm"].numpy(),
                   rj.history["round_ef_norm"], rtol=0.05, what="ef_norm")
        store = rt.final_state.ef
        store = store["obj"] if isinstance(store, dict) else store
        assert isinstance(store, tef.EFStore) == cohort
    else:
        for k in rj.params:
            _close(rt.params[k].numpy(), rj.params[k], atol=1e-5, what=k)
        for k, v in rj.history.items():
            if k.startswith("round_") and k != "round_t":
                _close(rt.history[k].numpy(), v, atol=1e-5, rtol=1e-5, what=k)


# ---------------------------------------------------------------------------
# dense engine against cohort engine, inside the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", DRIVERS)
def test_trajectory_dense_vs_cohort(setup, name):
    """tests/test_cohort.py's equalities at atol 1e-5, the port on its own
    virtual data: the dense engine on ``materialize()``, the cohort engine on
    the virtual view, the same keys. The reference's own sample_sgd int8
    pair misses this (2.1e-5 at this size: one rounding decision flips); the
    port's engines run the same batched local steps on the same rows, so no
    decision flips and it reads 3e-8."""
    own = dict(setup, td=setup["tv"].materialize())
    rd = _run("torch", name, own, False)
    rc = _run("torch", name, dict(own, td=setup["tv"]), True)
    for k in rd.params:
        _close(rc.params[k].numpy(), rd.params[k].numpy(), atol=1e-5, what=k)
    if "int8" in name:
        _close(_ef_data(rc.final_state.ef), _ef_data(rd.final_state.ef),
               atol=1e-5, what="EF residuals")


def test_cohort_drivers_require_participation(setup):
    tp = convert.params_from_numpy(setup["p0"], "cpu")
    for call in (
            lambda: talg.algorithm1(tmlp.per_sample_loss, tp, setup["tv"],
                                    FLConfig(**FL_KW), 2, setup["tkey"],
                                    cohort=True, device="cpu"),
            lambda: tbl.sample_sgd(tmlp.per_sample_loss, tp, setup["tv"],
                                   tbl.SGDConfig(), 2, setup["tkey"],
                                   cohort=True, device="cpu"),
            lambda: tlocal.algorithm1_local(tmlp.per_sample_loss, tp,
                                            setup["tv"], FLConfig(**FL_KW), 2,
                                            setup["tkey"], cohort=True,
                                            device="cpu")):
        with pytest.raises(ValueError, match="participation"):
            call()


def test_algorithm1_local_full_participation_matches(setup):
    """No participation: every client, the N_i/N average."""
    key = setup["jkey"]
    rj = jlocal.algorithm1_local(jmlp.per_sample_loss,
                                 jax.tree.map(jnp.asarray, setup["p0"]),
                                 setup["jd"], JFLConfig(**FL_KW), 6, key,
                                 local_steps=3)
    rt = tlocal.algorithm1_local(tmlp.per_sample_loss,
                                 convert.params_from_numpy(setup["p0"], "cpu"),
                                 setup["td"], FLConfig(**FL_KW), 6,
                                 setup["tkey"], local_steps=3, device="cpu")
    for k in rj.params:
        _close(rt.params[k].numpy(), rj.params[k], atol=1e-5, what=k)
    assert rt.final_state.t == 7


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def test_cohort_train_loop_matches_reference(capsys):
    """clients 1,000, participation 16, 10 rounds, int8 + EF, evals every 5
    rounds, from the reference's params: eval losses within 1e-4."""
    kw = dict(clients=1000, participation=16, rounds=10, codec="int8",
              log_every=5)
    rj = jtrain.cohort_train_loop(**kw)
    p0 = jmlp.init(jax.random.fold_in(jax.random.PRNGKey(0), 1), 32, 16, 4)
    rt = ttrain.cohort_train_loop(
        **kw, device="cpu",
        params0=convert.params_from_numpy(
            {k: np.asarray(v) for k, v in p0.items()}, "cpu"))
    _close(rt.history["loss"].numpy(), rj.history["loss"], atol=1e-4,
           what="eval loss")
    _eq(rt.history["round_upload_bytes"].numpy(),
        rj.history["round_upload_bytes"], "upload bytes")
    assert rt.history["round_upload_bytes"][0].item() == 16 * (4 * 3 + 576)
    assert "population 1000, cohort 16" in capsys.readouterr().out


def test_cohort_cli_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "train", "--mode", "cohort", "--clients", "1000", "--participation",
        "16", "--steps", "4", "--codec", "topk8", "--constrained", "--device",
        "cpu"])
    ttrain.main()
    out = capsys.readouterr().out
    assert "population 1000, cohort 16" in out and "loss=" in out


@pytest.mark.parametrize("kw,item", [(dict(topology="sharded"), "item 8"),
                                     (dict(dp="DPConfig"), "item 7"),
                                     (dict(log_jsonl="x.jsonl"), "item 9"),
                                     (dict(profile_dir="prof"), "item 9")])
def test_cohort_train_loop_refusals(kw, item, tmp_path):
    """The options ported since run: the sharded topology (item 8: one
    rank, the local run's history within 1e-6), dp=, JSONL logs and
    profiles (items 7 and 9)."""
    if "topology" in kw:
        got = ttrain.cohort_train_loop(clients=100, participation=4,
                                       rounds=2, log_every=1, device="cpu",
                                       codec="int8", **kw)
        want = ttrain.cohort_train_loop(clients=100, participation=4,
                                        rounds=2, log_every=1, device="cpu",
                                        codec="int8")
        for k, v in want.history.items():
            np.testing.assert_allclose(got.history[k].numpy(), v.numpy(),
                                       atol=1e-6, err_msg=k)
        return
    if "dp" in kw:
        kw = {"dp": tpriv.DPConfig(epsilon=4.0)}
    else:
        kw = {k: str(tmp_path / v) for k, v in kw.items()}
    res = ttrain.cohort_train_loop(clients=100, participation=4, rounds=1,
                                   log_every=1, device="cpu", **kw)
    assert np.isfinite(res.history["loss"].numpy()).all()
    if "dp" in kw:
        assert "round_dp_epsilon" in res.history
