"""The port's sharded topology on the feature-based drivers (Algorithms 3/4
and the three feature baselines, vertical FL with the feature clients on a
"model" mesh), against the port's own local run and the JAX package's.

Once per module, gloo groups of D = 1, 2 and 4 processes run every case of
``tests/torch_topology_ranks.py`` ("feature"; I = 4 feature clients). The
h-exchange is an all-gather in client order, so every rank's history and
params equal the port's local run's bit for bit (the per-client metric
columns are gathered too, and ``axis_bytes`` is the sharded figure:
``all_gather_axis_bytes`` of the I·B·J h, 0 at D = 1), and they equal the
JAX package's local run within 1e-5 (``tests/test_feature_topology.py``'s
standard; ν rtol 1e-4, ε rtol 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_topology_ranks as ranks
from repro.comm import accounting as jacc
from repro.comm import codecs as jcodecs
from repro.configs.base import FLConfig as JFLConfig
from repro.core import algorithms as jalg
from repro.core import baselines as jbl
from repro.core import fed as jfed
from repro.core import privacy as jpriv
from repro.models import mlp as jmlp

WORLDS = ranks.WORLDS
CASES = ["alg3_dense", "alg4_dense", "alg3_int8", "alg4_int8_dp", "alg3_dp",
         "feature_sgd", "frank_wolfe", "dual_decomposition"]


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    d = tmp_path_factory.mktemp("feature_topology")
    ranks.spawn("feature", d)
    return d


@pytest.fixture(scope="module")
def local_runs():
    return {}


def _local(local_runs, case):
    if case not in local_runs:
        local_runs[case] = ranks.run_case(case, None)
    return local_runs[case]


def _jax_case(case):
    """The JAX package's local run of a feature rank case: (history,
    params)."""
    z, y, p0 = ranks.feature_inputs()
    data = jfed.partition_features(jnp.asarray(z), jnp.asarray(y), ranks.IF)
    p0 = {k: jnp.asarray(v) for k, v in p0.items()}
    fl, fl_c = JFLConfig(**ranks.FL_KW), JFLConfig(**ranks.FL_C)
    int8, dp = jcodecs.make_codec("int8"), jpriv.DPConfig(**ranks.DP)
    args = (jmlp.per_sample_loss_from_h, jmlp.client_h, p0, data)
    kw = dict(rounds=10, key=jax.random.PRNGKey(ranks.KEY), eval_every=0)
    r = {"alg3_dense": lambda: jalg.algorithm3(*args, fl, **kw),
         "alg4_dense": lambda: jalg.algorithm4(*args, fl_c, **kw),
         "alg3_int8": lambda: jalg.algorithm3(*args, fl, codec=int8, **kw),
         "alg4_int8_dp": lambda: jalg.algorithm4(*args, fl_c, codec=int8,
                                                 dp=dp, **kw),
         "alg3_dp": lambda: jalg.algorithm3(*args, fl, dp=dp, **kw),
         "feature_sgd": lambda: jbl.feature_sgd(
             *args, jbl.SGDConfig(**ranks.SGD), momentum=True, codec=int8,
             **kw),
         "frank_wolfe": lambda: jbl.feature_frank_wolfe(
             *args, fl_c, jbl.FWConfig(), **kw),
         "dual_decomposition": lambda: jbl.feature_dual_decomposition(
             *args, fl_c, jbl.DualConfig(), **kw)}[case]()
    return ({k: np.asarray(v) for k, v in r.history.items()},
            {k: np.asarray(v) for k, v in r.params.items()})


def _close(got, want, what, atol=0.0, rtol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    ok = err <= atol + rtol * np.abs(want)
    assert ok.all(), f"{what}: max |diff| {err.max()} (atol {atol}, rtol {rtol})"


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", CASES)
def test_sharded_equals_local_bit_for_bit(out, local_runs, case, world):
    """Every rank's history and params are the port's local run's exactly
    (axis_bytes aside); the block residuals are the rank's rows of the
    local ones."""
    local = _local(local_runs, case)
    for r in range(world):
        res = ranks.load(out, case, world, r)
        for k, v in local.items():
            if k == "h/round_axis_bytes":
                continue
            if k == "x/ef_blocks":
                n = ranks.IF // world
                v = v[r * n:(r + 1) * n]
            np.testing.assert_array_equal(res[k], v, err_msg=f"r{r} {k}")


@pytest.fixture(scope="module")
def jax_runs():
    return {}


# ν at the scale of penalty_c (rtol 1e-4); ε near 1e5 (rtol 1e-5)
LOOSE = {"round_nu": dict(rtol=1e-4, atol=1e-4),
         "round_dp_epsilon": dict(rtol=1e-5)}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", CASES)
def test_sharded_matches_jax_local(out, jax_runs, case, world):
    if case not in jax_runs:
        jax_runs[case] = _jax_case(case)
    jh, jp = jax_runs[case]
    res = ranks.load(out, case, world, 0)
    for k, v in jh.items():
        if not k.startswith("round_") or k in ("round_t", "round_axis_bytes"):
            continue
        _close(res["h/" + k], v, f"{case} D={world} {k}",
               **LOOSE.get(k, dict(atol=1e-5)))
    for k, v in jp.items():
        _close(res["p/" + k], v, f"{case} D={world} param {k}", atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_feature_axis_bytes_are_the_reference_closed_form(out, world):
    """The h all-gather: (D−1)·4·I·B·J a round, 0 at D = 1."""
    b = ranks.FL_KW["batch_size"]
    want = jacc.all_gather_axis_bytes(ranks.IF * b * ranks.J, world)
    for case in ("alg3_dense", "alg4_int8_dp", "frank_wolfe",
                 "dual_decomposition"):
        got = ranks.load(out, case, world, 0)["h/round_axis_bytes"]
        assert set(got.tolist()) == {float(want)}, (case, got, want)
    if world > 1:
        assert want == (world - 1) * 4 * ranks.IF * b * ranks.J


@pytest.mark.parametrize("world", WORLDS)
def test_feature_round_int8_dp_equals_local(out, local_runs, world):
    """One feature_round with int8 and DP: h, the gradients and the head's
    wire format are whole and the local run's exactly; the block wire
    format, EF rows and noise stats are the rank's rows of the local
    ones."""
    local = _local(local_runs, "feature_round_int8_dp")
    n = ranks.IF // world
    for r in range(world):
        res = ranks.load(out, "feature_round_int8_dp", world, r)
        for k, v in local.items():
            if k in ("block_values", "ef_blocks", "noise_sq"):
                v = v[r * n:(r + 1) * n]
            np.testing.assert_array_equal(res[k], v, err_msg=f"r{r} {k}")


@pytest.mark.parametrize("world", WORLDS)
def test_feature_train_loop_sharded_equals_local(out, local_runs, world):
    local = _local(local_runs, "feature_train_loop")
    res = ranks.load(out, "feature_train_loop", world, 0)
    for k, v in local.items():
        if k != "h/round_axis_bytes":
            np.testing.assert_array_equal(res[k], v, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_deprecated_feature_dist_shim(out, local_runs, world):
    """train_feature_distributed on a "model" mesh warns, and returns the
    local Algorithm 3's params and its ten loss checkpoints (at 10 rounds,
    every round's)."""
    res = ranks.load(out, "feature_dist", world, 0)
    assert res["warned"]
    local = _local(local_runs, "alg3_dense")
    np.testing.assert_array_equal(res["w0"], local["p/w0"])
    np.testing.assert_array_equal(res["blocks"], local["p/blocks"])
    np.testing.assert_array_equal(res["losses"],
                                  local["h/round_loss_est"])


@pytest.mark.parametrize("world", WORLDS[1:])
def test_feature_sharded_for_idles_the_ranks_past_the_fit(out, world):
    """feature_sharded_for over I feature clients whose largest divisor d
    within the group is below D (3 on 2 ranks, 6 on 4): Algorithm 3 with
    int8 on the first d ranks, the others idle; every rank returns the
    port's local run's history and params bit for bit (as the sharded
    feature runs do) and its axis_bytes is the reference's at d."""
    for n in ranks.IDLE_FEATURE_CLIENTS[world]:
        local = ranks.feature_idle_run(None, n)
        d = max(k for k in range(1, world + 1) if n % k == 0)
        for r in range(world):
            res = ranks.load(out, "feature_idle", world, r)
            assert int(res[f"i{n}/num_shards"]) == d < world
            assert bool(res[f"i{n}/idle"]) == (r >= d)
            for k, v in local.items():
                got = res[f"i{n}/{k}"]
                if k == "h/round_axis_bytes":
                    want = jacc.all_gather_axis_bytes(
                        n * ranks.FL_KW["batch_size"] * ranks.J, d)
                    assert set(got.tolist()) == {float(want)}, (got, want)
                else:
                    np.testing.assert_array_equal(got, v, err_msg=f"I={n} r{r} {k}")
