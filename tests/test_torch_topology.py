"""The port's sharded client topology (``ShardedTopology`` over
``torch.distributed``) on the sample-based drivers, against the JAX
package's local run on the CPU (``tests/test_topology.py``'s cases).

Once per module, gloo groups of D = 1, 2 and 4 processes run every case of
``tests/torch_topology_ranks.py`` ("sample") at once, each rank writing its
results; inputs are numpy-seeded and fed to both packages. Tolerances are
the reference's own sharded==local standards (atol 1e-5; ``sample_sgd``
params 1e-4; with int8 + error feedback params 1e-4, since a reassociated
sum can move one stochastic-rounding decision by a level, which error
feedback re-injects next round). Every rank's history and params must be
equal; the int8 wire format of a round equals the port's local run's
exactly (the ranks' rows in rank order); ``axis_bytes`` equals the
reference's closed forms. The zoo step runs at smoke size with int8 + EF
and DP on D = 1 and 2 ranks against the reference's sharded
``make_scanned_step`` in a JAX subprocess with two host devices, at
``tests/test_torch_train_comm.py``'s tolerances (losses rtol 1e-3, params
within the largest EF residual entry, the DP metrics rtol 1e-5).
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_topology_ranks as ranks
from repro.comm import accounting as jacc
from repro.comm import codecs as jcodecs
from repro.configs.base import FLConfig as JFLConfig
from repro.configs.registry import ARCHS as JARCHS
from repro.core import algorithms as jalg
from repro.core import baselines as jbl
from repro.core import fed as jfed
from repro.core import local_updates as jlocal
from repro.core import privacy as jpriv
from repro.models import mlp as jmlp
from repro.models import transformer as jtr
from repro_torch.comm import accounting as tacc
from repro_torch.core import topology as ttopo
from repro_torch.launch import mesh as tmesh

WORLDS = ranks.WORLDS
ROOT = ranks.ROOT
DIM = ranks.P * ranks.J + ranks.J * ranks.L


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    """Run every rank case once: the gloo groups, and the JAX zoo reference
    in its own process, side by side."""
    d = tmp_path_factory.mktemp("topology")
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                jtr.init(jax.random.PRNGKey(0), JARCHS["qwen2.5-3b"].smoke()))[0]}
    weights = d / "zoo_weights.npz"
    np.savez(weights, **flat)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
           "OMP_NUM_THREADS": "1"}
    jax_ref = subprocess.Popen(
        [sys.executable, "-c", JAX_ZOO, str(weights), str(d),
         str(ROOT / "tests")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ranks.spawn("sample", d, env={"ZOO_WEIGHTS": str(weights)})
    finally:
        log, _ = jax_ref.communicate(timeout=240)
    assert jax_ref.returncode == 0, log[-4000:]
    return d


def _jax_data(ragged=None):
    z, y, p0 = ranks.sample_inputs(400 if ragged else 240)
    if ragged:
        data = jfed.partition_ragged(*ranks.dirichlet_shards(z, y, ragged, 8))
    else:
        data = jfed.partition_samples(jnp.asarray(z), jnp.asarray(y), ranks.I)
    return data, {k: jnp.asarray(v) for k, v in p0.items()}


def _fl(**kw):
    return JFLConfig(**{**ranks.FL_KW, **kw})


def _jax_case(case):
    """The JAX package's local run of a rank case, as (history, params,
    final state)."""
    psl, key = jmlp.per_sample_loss, jax.random.PRNGKey(ranks.KEY)
    int8 = jcodecs.make_codec("int8")
    kw = dict(key=key, eval_every=0)
    if case == "alg1_dense":
        data, p0 = _jax_data()
        r = jalg.algorithm1(psl, p0, data, _fl(), 20, **kw)
    elif case == "alg1_int8_ef_part":
        data, p0 = _jax_data()
        r = jalg.algorithm1(psl, p0, data, _fl(), 20, participation=3,
                            codec=int8, **kw)
    elif case == "alg2_int8_ef_part":
        data, p0 = _jax_data(ragged=0.5)
        r = jalg.algorithm2(psl, p0, data, JFLConfig(**ranks.FL_C), 20,
                            participation=3, codec=int8, **kw)
    elif case == "alg2g_topk_ef":
        data, p0 = _jax_data()
        r = jalg.algorithm2_general(psl, psl, p0, data,
                                    JFLConfig(**ranks.FL_C), 15,
                                    codec=jcodecs.make_codec("topk",
                                                             topk_frac=0.3),
                                    **kw)
    elif case == "ragged_dirichlet":
        data, p0 = _jax_data(ragged=0.3)
        r = jalg.algorithm1(psl, p0, data, _fl(batch_size=30), 20, **kw)
    elif case == "sample_sgd":
        data, p0 = _jax_data()
        r = jbl.sample_sgd(psl, p0, data, jbl.SGDConfig(**ranks.SGD), 10,
                           codec=int8, **kw)
    elif case == "alg1_local":
        data, p0 = _jax_data()
        r = jlocal.algorithm1_local(psl, p0, data, _fl(), 10, key,
                                    local_steps=3, eval_every=0)
    elif case == "alg1_dp":
        data, p0 = _jax_data()
        r = jalg.algorithm1(psl, p0, data, _fl(), 15, participation=3,
                            dp=jpriv.DPConfig(**ranks.DP), **kw)
    elif case == "cohort_int8_ef":
        data, p0 = _jax_data()
        r = jalg.algorithm1(psl, p0, data, _fl(), 10, participation=4,
                            cohort=True, codec=int8, **kw)
    else:
        raise KeyError(case)
    return ({k: np.asarray(v) for k, v in r.history.items()},
            {k: np.asarray(v) for k, v in r.params.items()}, r.final_state)


# (case, history atol, params atol): tests/test_topology.py's standards
TRAJ = [("alg1_dense", 1e-5, 1e-5), ("alg1_int8_ef_part", 1e-5, 1e-4),
        ("alg2_int8_ef_part", 1e-5, 1e-4), ("alg2g_topk_ef", 1e-5, 1e-5),
        ("ragged_dirichlet", 1e-5, 1e-5), ("sample_sgd", 1e-5, 1e-4),
        ("alg1_local", 1e-5, 1e-5), ("alg1_dp", 1e-5, 1e-5),
        ("cohort_int8_ef", 1e-5, 1e-4)]
# series held relatively, not at 1e-5 absolute: ν is a Lagrange multiplier
# at the scale of penalty_c (tests/test_topology.py: rtol 1e-4), ef_norm a
# norm of residuals (reassociated sums of squares), ε near 1e5 at a 0.01
# noise multiplier (float32 ulps of the accountant: rtol 1e-5, as in
# tests/test_torch_train_comm.py)
LOOSE = {"round_nu": dict(rtol=1e-4, atol=1e-4),
         "round_ef_norm": dict(rtol=1e-4, atol=1e-5),
         "round_dp_epsilon": dict(rtol=1e-5)}


def _close(got, want, what, atol=0.0, rtol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    ok = err <= atol + rtol * np.abs(want)
    assert ok.all(), f"{what}: max |diff| {err.max()} (atol {atol}, rtol {rtol})"


@pytest.fixture(scope="module")
def jax_runs():
    return {}


def _jax(jax_runs, case):
    if case not in jax_runs:
        jax_runs[case] = _jax_case(case)
    return jax_runs[case]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case,hist_atol,param_atol", TRAJ,
                         ids=[t[0] for t in TRAJ])
def test_sharded_trajectory_matches_jax_local(out, jax_runs, case, world,
                                              hist_atol, param_atol):
    jh, jp, jstate = _jax(jax_runs, case)
    res = ranks.load(out, case, world, 0)
    for k, v in jh.items():
        if not k.startswith("round_") or k == "round_t":
            continue
        if k == "round_axis_bytes":
            continue                    # the sharded figure; see below
        _close(res["h/" + k], v, f"{case} D={world} {k}",
               **LOOSE.get(k, dict(atol=hist_atol)))
    for k, v in jp.items():
        _close(res["p/" + k], v, f"{case} D={world} param {k}", atol=param_atol)
    if case == "cohort_int8_ef":
        # the store is whole on every rank; params tolerate one int8 level,
        # the residuals differ by whole quant steps where one flipped
        step = float(np.abs(np.asarray(jstate.ef.data)).max())
        _close(res["x/store"], np.asarray(jstate.ef.data), "store", atol=step)
    if case in ("alg2_int8_ef_part", "ragged_dirichlet"):
        assert len(set(res["x/counts"].tolist())) > 1      # ragged


@pytest.mark.parametrize("world", WORLDS[1:])
@pytest.mark.parametrize("case", [t[0] for t in TRAJ] + ["wire_int8",
                                                          "cohort_train_loop",
                                                          "zoo_int8_dp"])
def test_every_rank_is_equal(out, case, world):
    """Every rank's history, params and replicated state (the cohort store,
    the zoo's params) are equal; the per-client rows differ by rank."""
    first = ranks.load(out, case, world, 0)
    if "skipped" in first:
        assert case == "zoo_int8_dp" and world > 2
        return
    for r in range(1, world):
        res = ranks.load(out, case, world, r)
        for k, v in first.items():
            if k in ("x/ef", "values", "scales", "ef") or k.endswith("/ef"):
                continue                # the rank's own rows
            np.testing.assert_array_equal(res[k], v, err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("world", WORLDS)
def test_int8_wire_format_equals_local_exactly(out, world):
    """One int8 sample_round: the ranks' rows of the wire format, in rank
    order, are the local run's exactly; the EF rows and the aggregate
    within float reassociation."""
    local = ranks.run_case("wire_int8", None)
    parts = [ranks.load(out, "wire_int8", world, r) for r in range(world)]
    for k in ("values", "scales"):
        np.testing.assert_array_equal(np.concatenate([p[k] for p in parts]),
                                      local[k], err_msg=k)
    _close(np.concatenate([p["ef"] for p in parts]), local["ef"], "ef",
           atol=1e-6)
    for k in ("g/w0", "g/w1", "value"):
        _close(parts[0][k], local[k], k, atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_int8_ef_carry_is_the_ranks_rows(out, jax_runs, world):
    """The dense EF carry comes back as the rank's (I/D, P) rows; stacked
    in rank order they are the reference's (I, P) residuals within one
    quantization step."""
    rows = [ranks.load(out, "alg1_int8_ef_part", world, r)["x/ef"]
            for r in range(world)]
    assert all(r.shape == (ranks.I // world, DIM) for r in rows)
    jstate = _jax(jax_runs, "alg1_int8_ef_part")[2]
    step = float(np.abs(np.asarray(jstate.ef)).max())
    _close(np.concatenate(rows), np.asarray(jstate.ef), "ef", atol=step)


@pytest.mark.parametrize("world", WORLDS)
def test_axis_bytes_are_the_reference_closed_forms(out, world):
    """axis_bytes a round: 2·(D−1)·4·P for Algorithm 1, with the value
    partial for Algorithm 2, both streams for Algorithm 2 general; 0 at
    D = 1. The client-boundary upload bytes do not depend on D."""
    want = {"alg1_dense": jacc.psum_axis_bytes(DIM, world),
            "alg2_int8_ef_part": jacc.psum_axis_bytes(DIM, world,
                                                      with_value=True),
            "alg2g_topk_ef": (jacc.psum_axis_bytes(DIM, world)
                              + jacc.psum_axis_bytes(DIM, world,
                                                     with_value=True))}
    for case, w in want.items():
        got = ranks.load(out, case, world, 0)["h/round_axis_bytes"]
        assert set(got.tolist()) == {float(w)}, (case, got, w)
    if world > 1:
        assert want["alg1_dense"] == 2 * (world - 1) * 4 * DIM
    up = [ranks.load(out, "alg1_dense", d, 0)["h/round_upload_bytes"]
          for d in WORLDS]
    assert all((u == up[0]).all() for u in up)


@pytest.mark.parametrize("args", [(100, 1), (100, 8), (101_632, 2),
                                  (101_632, 4, True), (576, 4, False, 2)])
def test_accounting_closed_forms_equal_the_reference(args):
    assert tacc.psum_axis_bytes(*args) == jacc.psum_axis_bytes(*args)
    assert tacc.all_gather_axis_bytes(*args[:2]) == \
        jacc.all_gather_axis_bytes(*args[:2])


@pytest.mark.parametrize("world", WORLDS[1:])
def test_divisibility_and_fit_refusals(out, world):
    """I = D + 1 clients on D ranks: sample_round raises the reference's
    divisibility message; sharded_for raises (a rank without clients) with
    the sizes in its message."""
    res = ranks.load(out, "refusals", world, 0)
    assert res["checked"] and res["divisible"] and res["refused"]


@pytest.mark.parametrize("world", WORLDS)
def test_cohort_train_loop_sharded_matches_local(out, world):
    """cohort_train_loop(topology="sharded") splits the cohort over the
    ranks; its history and params are the local run's at 1e-5."""
    local = ranks.run_case("cohort_train_loop", None)
    res = ranks.load(out, "cohort_train_loop", world, 0)
    for k, v in local.items():
        if k.startswith("h/round_axis_bytes"):
            continue
        _close(res[k], v, k, atol=1e-5)


def test_make_topology_names_and_the_one_rank_mesh():
    """make_topology's names; a one-rank mesh still issues the collective
    (the reference's 1-device mesh runs the psum); a mesh of more ranks
    than the group has is refused."""
    assert ttopo.make_topology("local") is ttopo.LOCAL
    topo = ttopo.make_topology("sharded", device="cpu")
    assert topo.name == "sharded" and topo.num_shards == 1 and topo.rank == 0
    assert topo.mesh.mesh_dim_names == ("data",)
    assert topo.all_sum({"x": torch.tensor(2.0)})["x"].item() == 2.0
    assert tmesh.make_feature_mesh(device="cpu").mesh_dim_names == ("model",)
    with pytest.raises(RuntimeError, match="need 2 ranks"):
        tmesh.make_client_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="unknown topology"):
        ttopo.make_topology("ring")


def test_make_client_mesh_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_client_mesh()
    assert tmesh.backend_for("cuda") == "nccl"
    assert tmesh.backend_for("cpu") == "gloo"


def test_place_state_cuts_the_carry_to_the_ranks_rows():
    """On one rank the rows are all of them; a keyed EFStore stays whole;
    the feature carry's head stream stays whole."""
    from repro_torch.comm import error_feedback as tef
    topo = ttopo.make_topology("sharded", device="cpu")
    dense = tef.CommCarry(opt=None, ef={"obj": torch.ones(8, 4),
                                        "cons": torch.ones(8, 4)})
    placed = topo.place_state(dense)
    assert placed.ef["obj"].shape == (8, 4)
    store = tef.ef_store_init(8, 4, device="cpu")
    assert topo.place_state(tef.CommCarry(opt=None, ef=store)).ef is store
    feat = tef.CommCarry(opt=None, ef={"w0": torch.ones(5),
                                       "blocks": torch.ones(4, 3)})
    assert topo.place_feature_state(feat).ef["w0"].shape == (5,)
    assert topo.place_state("opaque") == "opaque"


JAX_ZOO = textwrap.dedent('''
    import sys
    import jax, jax.numpy as jnp, numpy as np
    sys.path.insert(0, sys.argv[3])
    import torch_topology_ranks as ranks
    from repro.comm import codecs
    from repro.comm.error_feedback import CommCarry, ef_init_stacked
    from repro.configs.base import FLConfig
    from repro.configs.registry import ARCHS
    from repro.core import optimizer, privacy, rounds
    from repro.core.topology import ShardedTopology
    from repro.data import synthetic
    from repro.launch import train
    from repro.launch.mesh import make_client_mesh
    from repro.models import get_model

    weights, out = sys.argv[1], sys.argv[2]
    cfg = ARCHS["qwen2.5-3b"].smoke()
    params = {}
    with np.load(weights) as f:
        for k in f.files:
            node = params
            *parents, leaf = k.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(f[k])
    fl = FLConfig(**ranks.ZOO_FL)
    toks = synthetic.token_dataset(jax.random.fold_in(jax.random.PRNGKey(0), 1),
                                   cfg.vocab_size, 2000)
    dim = sum(x.size for x in jax.tree.leaves(params))
    for d in (1, 2):
        topo = ShardedTopology(make_client_mesh(d))
        step = train.make_scanned_step(
            get_model(cfg), cfg, fl, toks, ranks.ZOO_BATCH, ranks.ZOO_SEQ,
            codec=codecs.make_codec("int8"), topology=topo,
            dp=privacy.DPConfig(**ranks.DP))
        state = topo.place_state(CommCarry(opt=optimizer.ssca_init(params),
                                           ef=ef_init_stacked(d, dim)))
        inputs = rounds.make_inputs(fl, 1, ranks.ZOO_STEPS,
                                    jax.random.PRNGKey(9))
        state, ms = rounds.loop_rounds(step, state, inputs)
        w = jnp.concatenate([x.reshape(-1) for x in
                             jax.tree.leaves(state.opt.params)])
        np.savez(f"{out}/jax_zoo.d{d}.npz", w=np.asarray(w),
                 ef=np.asarray(state.ef),
                 **{"m/" + k: np.asarray(v) for k, v in ms.items()})
''')


@pytest.mark.parametrize("world", [1, 2])
def test_zoo_step_matches_the_reference_sharded_step(out, world):
    """The zoo's sharded step (int8 + EF, DP) on D ranks against the
    reference's sharded make_scanned_step on a D-device mesh. At D = 1 this
    is not the local step: the shard keys are split by D."""
    with np.load(out / f"jax_zoo.d{world}.npz") as f:
        want = {k: f[k] for k in f.files}
    for r in range(world):
        got = ranks.load(out, "zoo_int8_dp", world, r)
        _close(got["m/loss"], want["m/loss"], "loss", rtol=1e-3)
        np.testing.assert_array_equal(got["m/upload_bytes"],
                                      want["m/upload_bytes"])
        for k in ("dp_epsilon", "dp_clip_frac", "dp_noise_norm"):
            _close(got["m/" + k], want["m/" + k], k, rtol=1e-5)
        step = float(np.abs(want["ef"]).max())
        _close(got["w"], want["w"], "params", atol=step)
        # the rank's residual row: a flipped rounding decision moves an
        # entry by a whole quantization step, under twice the largest
        # residual (with DP, erfinv's ulps make flips a few in 1e3)
        _close(got["ef"], want["ef"][r:r + 1], "ef row", atol=2 * step)
    assert float(want["m/upload_bytes"][0]) == float(np.float32(
        world * jcodecs.make_codec("int8").nbytes(want["w"].size)))
