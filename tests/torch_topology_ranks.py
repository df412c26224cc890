"""The rank side of ``tests/test_torch_topology.py`` and
``tests/test_torch_feature_topology.py``: the port's drivers on a
``ShardedTopology`` over a gloo group of D CPU processes.

    python tests/torch_topology_ranks.py SUITE RANK WORLD STORE OUT

starts rank RANK of a WORLD-rank gloo group (``init_method="file://STORE"``),
runs every case of SUITE ("sample" or "feature") on it and writes each
case's results to ``OUT/<case>.d<WORLD>.r<RANK>.npz``. Each case is a
function of the topology (None: the local one), so the tests run the same
function on the local topology in their own process. The inputs come from
numpy seeds (``sample_inputs``, ``feature_inputs``); the tests feed the
same arrays to the JAX package. This module imports no jax.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from repro_torch import convert  # noqa: E402
from repro_torch import random as rnd  # noqa: E402
from repro_torch.comm import codecs  # noqa: E402
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.core import algorithms, baselines, fed  # noqa: E402
from repro_torch.core import privacy  # noqa: E402
from repro_torch.core import topology as topo_lib  # noqa: E402
from repro_torch.core.local_updates import algorithm1_local  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import mlp  # noqa: E402

WORLDS = (1, 2, 4)
P, J, L, I = 12, 6, 3, 8           # I divisible by every D of WORLDS
IF, PF = 4, 24                     # feature clients, features
FL_KW = dict(batch_size=20, a1=0.9, a2=0.5, alpha_rho=0.1, alpha_gamma=0.6,
             tau=0.2, l2_lambda=1e-5)
FL_C = dict(FL_KW, constrained=True, cost_limit=1.2, penalty_c=1e4)
DP = dict(clip_norm=0.5, noise_multiplier=0.01)
SGD = dict(lr_a=0.3, lr_alpha=0.3, local_batch=20, local_steps=2)
KEY = 2                            # the round key: PRNGKey(2) in both packages


# ---------------------------------------------------------------------------
# inputs from numpy seeds
# ---------------------------------------------------------------------------


def sample_inputs(n: int = 240, seed: int = 0):
    """(features (n, P), one-hot labels (n, L), params0 {"w0", "w1"})."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, P)).astype(np.float32)
    y = np.eye(L, dtype=np.float32)[rng.integers(0, L, n)]
    p0 = {"w0": (rng.standard_normal((L, J)) / np.sqrt(J)).astype(np.float32),
          "w1": (rng.standard_normal((J, P)) / np.sqrt(P)).astype(np.float32)}
    return z, y, p0


def dirichlet_shards(z, y, alpha: float, seed: int):
    """Label-skewed ragged client shards: each class's samples split over
    the I clients by Dirichlet(alpha) shares (numpy), every client >= 1."""
    rng = np.random.default_rng(seed)
    lab = y.argmax(-1)
    idx = [[] for _ in range(I)]
    for c in range(L):
        rows = np.flatnonzero(lab == c)
        cuts = (np.cumsum(rng.dirichlet(alpha * np.ones(I)))[:-1]
                * rows.size).astype(int)
        for i, part in enumerate(np.split(rows, cuts)):
            idx[i].extend(part.tolist())
    for i in range(I):
        if not idx[i]:
            donor = max(range(I), key=lambda j: len(idx[j]))
            idx[i].append(idx[donor].pop())
    return [z[s] for s in idx], [y[s] for s in idx]


def feature_inputs(n: int = 200, seed: int = 1):
    """(features (n, PF), one-hot labels (n, L), params0 {"w0" (L, J),
    "blocks" (IF, J, PF/IF)})."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, PF)).astype(np.float32)
    y = np.eye(L, dtype=np.float32)[rng.integers(0, L, n)]
    p0 = {"w0": (0.2 * rng.standard_normal((L, J))).astype(np.float32),
          "blocks": (0.2 * rng.standard_normal((IF, J, PF // IF))
                     ).astype(np.float32)}
    return z, y, p0


def _key():
    return rnd.PRNGKey(KEY, device="cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _sample_data(ragged=None):
    z, y, p0 = sample_inputs(400 if ragged else 240)
    if ragged:
        zs, ys = dirichlet_shards(z, y, ragged, seed=8)
        data = fed.partition_ragged([_t(a) for a in zs], [_t(a) for a in ys],
                                    device="cpu")
    else:
        data = fed.partition_samples(_t(z), _t(y), I)
    return data, convert.params_from_numpy(p0, "cpu")


def _result(res, **extra):
    """A RunResult as flat numpy: h/<history>, p/<param>, x/<extra>."""
    out = {f"h/{k}": v.numpy() for k, v in res.history.items()}
    out.update({f"p/{k}": v.numpy() for k, v in res.params.items()})
    out.update({f"x/{k}": np.asarray(v) for k, v in extra.items()})
    return out


# ---------------------------------------------------------------------------
# sample-based cases
# ---------------------------------------------------------------------------


def case_alg1_dense(topo):
    data, p0 = _sample_data()
    return _result(algorithms.algorithm1(
        mlp.per_sample_loss, p0, data, FLConfig(**FL_KW), 20, _key(),
        eval_every=0, topology=topo, device="cpu"))


def case_alg1_int8_ef_part(topo):
    data, p0 = _sample_data()
    r = algorithms.algorithm1(
        mlp.per_sample_loss, p0, data, FLConfig(**FL_KW), 20, _key(),
        eval_every=0, participation=3, codec=codecs.make_codec("int8"),
        topology=topo, device="cpu")
    return _result(r, ef=r.final_state.ef.numpy())


def case_alg2_int8_ef_part(topo):
    data, p0 = _sample_data(ragged=0.5)
    return _result(algorithms.algorithm2(
        mlp.per_sample_loss, p0, data, FLConfig(**FL_C), 20, _key(),
        eval_every=0, participation=3, codec=codecs.make_codec("int8"),
        topology=topo, device="cpu"), counts=data.counts.numpy())


def case_alg2g_topk_ef(topo):
    data, p0 = _sample_data()
    return _result(algorithms.algorithm2_general(
        mlp.per_sample_loss, mlp.per_sample_loss, p0, data, FLConfig(**FL_C),
        15, _key(), eval_every=0,
        codec=codecs.make_codec("topk", topk_frac=0.3), topology=topo,
        device="cpu"))


def case_ragged_dirichlet(topo):
    data, p0 = _sample_data(ragged=0.3)
    return _result(algorithms.algorithm1(
        mlp.per_sample_loss, p0, data, FLConfig(**dict(FL_KW, batch_size=30)),
        20, _key(), eval_every=0, topology=topo, device="cpu"),
        counts=data.counts.numpy())


def case_sample_sgd(topo):
    data, p0 = _sample_data()
    return _result(baselines.sample_sgd(
        mlp.per_sample_loss, p0, data, baselines.SGDConfig(**SGD), 10,
        _key(), eval_every=0, codec=codecs.make_codec("int8"), topology=topo,
        device="cpu"))


def case_alg1_local(topo):
    data, p0 = _sample_data()
    return _result(algorithm1_local(
        mlp.per_sample_loss, p0, data, FLConfig(**FL_KW), 10, _key(),
        local_steps=3, eval_every=0, topology=topo, device="cpu"))


def case_alg1_dp(topo):
    data, p0 = _sample_data()
    return _result(algorithms.algorithm1(
        mlp.per_sample_loss, p0, data, FLConfig(**FL_KW), 15, _key(),
        eval_every=0, participation=3, dp=privacy.DPConfig(**DP),
        topology=topo, device="cpu"))


def case_cohort_int8_ef(topo):
    """The cohort engine (S = 4 of I = 8), int8 + EF: the EFStore comes back
    whole, and must be equal on every rank."""
    data, p0 = _sample_data()
    r = algorithms.algorithm1(
        mlp.per_sample_loss, p0, data, FLConfig(**FL_KW), 10, _key(),
        eval_every=0, participation=4, cohort=True,
        codec=codecs.make_codec("int8"), topology=topo, device="cpu")
    return _result(r, store=r.final_state.ef.data.numpy())


def case_wire_int8(topo):
    """One int8 sample_round: the rank's rows of the wire format and EF."""
    data, p0 = _sample_data()
    g, v, up = fed.sample_round(mlp.per_sample_loss, p0, data, _key(), 20,
                                codec=codecs.make_codec("int8"),
                                topology=topo)
    return {"values": up["encoded"].values.numpy(),
            "scales": up["encoded"].scales.numpy(), "ef": up["ef"].numpy(),
            "value": v.numpy(), **{f"g/{k}": t.numpy() for k, t in g.items()}}


def case_cohort_train_loop(topo):
    """cohort_train_loop at a small population (the topology by name)."""
    r = train.cohort_train_loop(
        clients=100, participation=4, rounds=6, log_every=3, codec="int8",
        topology="local" if topo is None else "sharded", device="cpu")
    return _result(r)


def case_refusals(topo):
    """The divisibility error and sharded_for's refusal, as booleans (the
    messages checked on the rank)."""
    out = {}
    if topo is None or topo.num_shards < 2:
        return {"checked": np.array(False)}
    z, y, p0 = sample_inputs(210)
    data = fed.partition_samples(_t(z), _t(y), topo.num_shards + 1)
    try:
        fed.sample_round(mlp.per_sample_loss,
                         convert.params_from_numpy(p0, "cpu"), data, _key(),
                         20, topology=topo)
        out["divisible"] = np.array(False)
    except ValueError as e:
        out["divisible"] = np.array("must be divisible by the "
                                    f"{topo.num_shards} client shards"
                                    in str(e))
    try:
        topo_lib.sharded_for(topo.num_shards + 1, device="cpu")
        out["refused"] = np.array(False)
    except ValueError as e:
        out["refused"] = np.array(
            f"{topo.num_shards + 1} clients do not divide over the "
            f"{topo.num_shards} ranks" in str(e))
    out["checked"] = np.array(True)
    return out


def case_zoo_int8_dp(topo):
    """3 steps of the zoo's train step at smoke size on this topology with
    int8 + EF and DP, from the weights in ``ZOO_WEIGHTS`` (only on groups of
    1 and 2 ranks)."""
    from repro_torch.comm.error_feedback import CommCarry, ef_init_stacked
    from repro_torch.configs.registry import get_config
    from repro_torch.core import optimizer, rounds
    from repro_torch.data.synthetic import token_dataset
    from repro_torch.models.api import get_model
    path = os.environ.get("ZOO_WEIGHTS")
    if topo is None or topo.num_shards > 2 or not path:
        return {"skipped": np.array(True)}
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    params = {}
    for k, v in flat.items():
        node = params
        *parents, leaf = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    cfg = get_config("qwen2.5-3b").smoke()
    fl = FLConfig(**ZOO_FL)
    toks = token_dataset(rnd.fold_in(rnd.PRNGKey(0, device="cpu"), 1),
                         cfg.vocab_size, 2000)
    step = train.make_scanned_step(
        get_model(cfg), cfg, fl, toks, ZOO_BATCH, ZOO_SEQ,
        codec=codecs.make_codec("int8"), topology=topo,
        dp=privacy.DPConfig(**DP))
    state = optimizer.ssca_init(convert.params_from_numpy(params, "cpu"))
    state = CommCarry(opt=state, ef=ef_init_stacked(
        1, state.w_flat.numel(), "cpu"))
    inputs = rounds.make_inputs(fl, 1, ZOO_STEPS, rnd.PRNGKey(9, device="cpu"))
    state, ms = rounds.loop_rounds(step, state, inputs)
    return {**{f"m/{k}": v.numpy() for k, v in ms.items()},
            "w": state.opt.w_flat.numpy(), "ef": state.ef.numpy()}


ZOO_FL = dict(a1=0.9, a2=0.5, alpha_rho=0.1, alpha_gamma=0.6, tau=0.2,
              l2_lambda=1e-5, cost_limit=3.0)
ZOO_BATCH, ZOO_SEQ, ZOO_STEPS = 4, 16, 3


# ---------------------------------------------------------------------------
# feature-based cases
# ---------------------------------------------------------------------------


def _feature_data():
    z, y, p0 = feature_inputs()
    return (fed.partition_features(_t(z), _t(y), IF),
            convert.params_from_numpy(p0, "cpu"))


def _feature_run(driver, topo, rounds=10, **kw):
    data, p0 = _feature_data()
    r = driver(mlp.per_sample_loss_from_h, mlp.client_h, p0, data,
               rounds=rounds, key=_key(), eval_every=0, topology=topo,
               device="cpu", **kw)
    ef = getattr(r.final_state, "ef", None)
    extra = {} if not isinstance(ef, dict) else {
        "ef_w0": ef["w0"].numpy(), "ef_blocks": ef["blocks"].numpy()}
    return _result(r, **extra)


def case_alg3_dense(topo):
    return _feature_run(algorithms.algorithm3, topo, fl=FLConfig(**FL_KW))


def case_alg4_dense(topo):
    return _feature_run(algorithms.algorithm4, topo, fl=FLConfig(**FL_C))


def case_alg3_int8(topo):
    return _feature_run(algorithms.algorithm3, topo, fl=FLConfig(**FL_KW),
                        codec=codecs.make_codec("int8"))


def case_alg4_int8_dp(topo):
    return _feature_run(algorithms.algorithm4, topo, fl=FLConfig(**FL_C),
                        codec=codecs.make_codec("int8"),
                        dp=privacy.DPConfig(**DP))


def case_alg3_dp(topo):
    return _feature_run(algorithms.algorithm3, topo, fl=FLConfig(**FL_KW),
                        dp=privacy.DPConfig(**DP))


def case_feature_sgd(topo):
    return _feature_run(baselines.feature_sgd, topo,
                        cfg=baselines.SGDConfig(**SGD), momentum=True,
                        codec=codecs.make_codec("int8"))


def case_frank_wolfe(topo):
    return _feature_run(baselines.feature_frank_wolfe, topo,
                        fl=FLConfig(**FL_C), cfg=baselines.FWConfig())


def case_dual_decomposition(topo):
    return _feature_run(baselines.feature_dual_decomposition, topo,
                        fl=FLConfig(**FL_C), cfg=baselines.DualConfig())


def case_feature_round_int8_dp(topo):
    """One feature_round with int8 and DP: h, the gathered block uploads,
    the head's wire format and the rank's rows of the blocks' and EF."""
    data, p0 = _feature_data()
    g, v, up = fed.feature_round(p0, data, _key(), 20,
                                 mlp.per_sample_loss_from_h, mlp.client_h,
                                 codec=codecs.make_codec("int8"),
                                 dp=privacy.DPConfig(**DP), topology=topo)
    enc = up["encoded"]
    return {"h": up["h_exchange"].numpy(), "value": v.numpy(),
            "g_w0": g["w0"].numpy(), "g_blocks": g["blocks"].numpy(),
            "head_values": enc["q_head"].values.numpy(),
            "block_values": enc["q_blocks"].values.numpy(),
            "ef_blocks": up["ef"]["blocks"].numpy(),
            "noise_sq": up["dp"]["blocks_noise_sq"].numpy()}


def case_feature_train_loop(topo):
    r = train.feature_train_loop(
        clients=IF, rounds=6, n=400, features=PF, batch=16, log_every=3,
        codec="int8", topology="local" if topo is None else "sharded",
        device="cpu")
    return _result(r)


def case_feature_dist(topo):
    """The deprecated shim's train_feature_distributed on a "model" mesh."""
    import warnings
    from repro_torch.launch import feature_dist
    from repro_torch.launch.mesh import make_feature_mesh
    if topo is None:
        return {"skipped": np.array(True)}
    data, p0 = _feature_data()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        params, losses = feature_dist.train_feature_distributed(
            make_feature_mesh(topo.num_shards, device="cpu"),
            mlp.per_sample_loss_from_h, mlp.client_h, p0["w0"], p0["blocks"],
            data.feature_blocks, data.labels, FLConfig(**FL_KW), 10, _key(),
            device="cpu")
    return {"losses": np.asarray(losses), "w0": params["w0"].numpy(),
            "blocks": params["blocks"].numpy(),
            "warned": np.array(any(issubclass(w.category, DeprecationWarning)
                                   for w in caught))}


SUITES = {
    "sample": ["alg1_dense", "alg1_int8_ef_part", "alg2_int8_ef_part",
               "alg2g_topk_ef", "ragged_dirichlet", "sample_sgd",
               "alg1_local", "alg1_dp", "cohort_int8_ef", "wire_int8",
               "cohort_train_loop", "refusals", "zoo_int8_dp"],
    "feature": ["alg3_dense", "alg4_dense", "alg3_int8", "alg4_int8_dp",
                "alg3_dp", "feature_sgd", "frank_wolfe", "dual_decomposition",
                "feature_round_int8_dp", "feature_train_loop",
                "feature_dist"],
}
FEATURE = set(SUITES["feature"])


def topology_for(case: str):
    """The sharded topology a case runs on: over a "model" mesh for the
    feature cases, a "data" mesh for the others."""
    if case in FEATURE:
        return topo_lib.feature_sharded_for(IF, device="cpu")
    return topo_lib.sharded_for(I, device="cpu")


def run_case(case: str, topo):
    return globals()["case_" + case](topo)


def out_path(out_dir, case: str, world: int, rank: int) -> Path:
    return Path(out_dir) / f"{case}.d{world}.r{rank}.npz"


def load(out_dir, case: str, world: int, rank: int) -> dict:
    with np.load(out_path(out_dir, case, world, rank)) as f:
        return {k: f[k] for k in f.files}


def spawn(suite: str, out_dir, worlds=WORLDS, timeout: float = 240.0,
          env=None):
    """Start a gloo group of D processes for every D of ``worlds`` at once,
    each rank running SUITE's cases; raise with the ranks' output if one
    fails or the time runs out."""
    out_dir = Path(out_dir)
    env = {**os.environ, **(env or {}), "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT / "src")}
    procs = []
    for d in worlds:
        store = out_dir / f"{suite}.store{d}"
        for r in range(d):
            procs.append((d, r, subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), suite,
                 str(r), str(d), str(store), str(out_dir)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                text=True)))
    end = time.monotonic() + timeout
    fails = []
    for d, r, p in procs:
        try:
            out, _ = p.communicate(timeout=max(1.0, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            for *_, q in procs:
                q.kill()
            raise RuntimeError(f"rank {r} of {d} timed out")
        if p.returncode:
            fails.append(f"--- rank {r} of {d} (exit {p.returncode}):\n"
                         f"{out[-4000:]}")
    if fails:
        raise RuntimeError("\n".join(fails))


def main(argv):
    suite, rank, world, store, out_dir = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        for case in SUITES[suite]:
            res = run_case(case, topology_for(case))
            np.savez(out_path(out_dir, case, world, rank), **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
