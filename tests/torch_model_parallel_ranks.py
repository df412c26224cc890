"""The rank side of ``tests/test_torch_model_parallel.py``: the port's
model-parallel launch layer (``launch.mesh``, ``serve.sharded_decode_step``,
``train.sharded_train_step``, ``layers.moe_expert_parallel``) on a gloo
group of CPU processes, a (2, 2) ("data", "model") mesh on 4 ranks or a
(1, 2) mesh on 2.

    python tests/torch_model_parallel_ranks.py SUITE RANK WORLD STORE IN OUT

starts rank RANK of a WORLD-rank gloo group (``init_method="file://STORE"``),
runs SUITE's cases ("decode", "train" or "ep") and writes each case's
results, gathered whole on every rank, to ``OUT/<case>.d<WORLD>.r<RANK>.npz``.
The params come from ``IN/<config>.npz`` (``save_tree``: the port's init at
the smoke size, which the tests also feed to the JAX package), the tokens,
prefix and frame embeddings from numpy seeds (``inputs``). This module
imports no jax.
"""
from __future__ import annotations

import dataclasses
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
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import optimizer  # noqa: E402
from repro_torch.core.tree import views  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.mesh import P  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402

SHAPES = {4: (2, 2), 2: (1, 2)}
# the smoke configs (both packages' ``smoke()``, then these fields)
CONFIGS = {
    # remat: each layer's params gathered inside its checkpoint, and again
    # in its recompute
    "dense": ("qwen2.5-3b", {"remat": True}),
    "moe": ("qwen3-moe-30b-a3b", {"remat": True}),
    "moe_ep": ("qwen3-moe-30b-a3b", {"moe_sharding": "expert_parallel"}),
    "vlm": ("paligemma-3b", {}),
    # one sLSTM block, so that the sLSTM cache entries run
    "ssm": ("xlstm-1.3b", {"block_pattern": ("m", "s")}),
    "hybrid": ("zamba2-1.2b", {}),
    "audio": ("seamless-m4t-medium", {}),
    # 16 K/V heads: the kv-head-sharded cache layout
    "kv16": ("qwen2.5-3b", {"n_heads": 16, "n_kv_heads": 16, "head_dim": 16}),
}
B, S, GEN = 4, 8, 4                 # batch, prompt, decode steps
TRAIN_STEPS = 2
FL_KW = dict(a1=0.9, a2=0.5, alpha_rho=0.1, alpha_gamma=0.6, tau=0.2,
             l2_lambda=1e-5, cost_limit=3.0)
DECODE = ["dense", "moe", "moe_ep", "vlm", "ssm", "hybrid", "audio", "kv16"]
TRAIN = [("dense", False), ("dense", True), ("moe", False), ("moe", True),
         ("ssm", False), ("ssm", True)]
SUITES = {"decode": [f"decode_{c}" for c in DECODE],
          "train": [f"train_{c}_{'constrained' if k else 'dense'}"
                    for c, k in TRAIN],
          "ep": ["ep_layer", "ep_grad", "ep_grad_combine_allreduce",
                 "ep_grad_aux_every_model_rank"]}


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def config(name, smoke_of):
    """(arch, the config) of CONFIGS[name]; ``smoke_of(arch)`` gives a
    package's smoke config."""
    arch, fields = CONFIGS[name]
    return arch, dataclasses.replace(smoke_of(arch), **fields)


def inputs(name, cfg):
    """The global batch of numpy arrays: tokens (B, S) and targets, and a
    VLM's prefix (B, Pfx, D) or an encoder-decoder's frames (B, 4·S, D)."""
    rng = np.random.default_rng(sorted(CONFIGS).index(name))
    tokens = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    out = {"tokens": tokens[:, :S], "targets": tokens[:, 1:]}
    if cfg.family == "vlm":
        out["prefix_embeddings"] = rng.standard_normal(
            (B, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frame_embeddings"] = rng.standard_normal(
            (B, 4 * S, cfg.d_model)).astype(np.float32)
    return out


def prefix_len(cfg) -> int:
    return cfg.num_prefix_tokens if cfg.family == "vlm" else 0


def flat(tree, prefix=""):
    """A nested dict of arrays as {"a/b/c": a copy of the array} (a copy:
    the port's arrays may share the state's buffers, which the next step
    writes)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.array(v)
    return out


def nest(flat_tree):
    out = {}
    for k, v in flat_tree.items():
        node = out
        *parents, leaf = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def save_tree(path, tree):
    np.savez(path, **flat(tree))


def load_tree(path):
    with np.load(path) as f:
        return nest({k: f[k] for k in f.files})


def write_params(in_dir):
    """The port's init at the smoke size, PRNGKey(0), of every config that
    a suite runs, to ``in_dir/<config>.npz``."""
    from repro_torch import random as rnd
    for name in CONFIGS:
        _, cfg = config(name, lambda a: get_config(a).smoke())
        p = get_model(cfg).init(rnd.PRNGKey(0, device="cpu"), cfg, device="cpu")
        save_tree(Path(in_dir) / f"{name}.npz", convert.params_to_numpy(p))


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------


def _setup(name, in_dir):
    _, cfg = config(name, lambda a: get_config(a).smoke())
    model = get_model(cfg)
    params = convert.params_from_numpy(load_tree(Path(in_dir) / f"{name}.npz"),
                                       "cpu")
    batch = {k: torch.from_numpy(v) for k, v in inputs(name, cfg).items()}
    return cfg, model, params, batch


def _rows(mesh, tree):
    """This rank's rows of a tree of batch-leading tensors."""
    return mesh_lib.shard_tree(tree, mesh, train.batch_specs(tree, mesh))


def _whole_rows(mesh, tree):
    return mesh_lib.gather_tree(tree, mesh, train.batch_specs(tree, mesh))


def decode(name, mesh, in_dir):
    """Prefill the global batch locally, place params, cache and token on
    the mesh, and run GEN sharded decode steps: the tokens and logits of
    every step and the cache after the last, whole."""
    cfg, model, params, batch = _setup(name, in_dir)
    pfx = prefix_len(cfg)
    kw = {"enc_len": 4 * S} if cfg.is_encdec else {}
    del batch["targets"]
    cache = model.init_cache(cfg, B, pfx + S + GEN, device="cpu", **kw)
    logits, cache = model.prefill(params, batch, cfg, cache=cache)
    tok0 = _rows(mesh, {"t": serve._greedy(logits)})["t"]
    cspecs = mesh_lib.adapt_for_mesh(model.cache_specs(cfg), mesh)
    lp = mesh_lib.shard_tree(params, mesh, model.param_specs(cfg, "serve"))
    step = serve.sharded_decode_step(model, cfg, mesh)
    # the step itself gives the forward's first token
    t1, _ = step(lp, mesh_lib.shard_tree(_clone(cache), mesh, cspecs), tok0,
                 pfx + S)
    out = {}
    lc, tok = mesh_lib.shard_tree(cache, mesh, cspecs), tok0
    for i in range(GEN):
        lg, lc = step.forward(lp, lc, tok, pfx + S + i)
        tok = serve._greedy(lg)
        whole = _whole_rows(mesh, {"t": tok, "l": lg})
        out[f"tokens{i}"], out[f"logits{i}"] = whole["t"], whole["l"]
        if i == 0:
            out["step_token0"] = _whole_rows(mesh, {"t": t1})["t"]
    whole = mesh_lib.gather_tree(lc, mesh, cspecs)
    out.update({"cache/" + k: v for k, v in flat(
        convert.params_to_numpy(whole)).items()})
    return out


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def train_case(name, constrained, mesh, in_dir):
    """TRAIN_STEPS sharded steps from the init params on the global batch:
    the params after each step (whole) and the metrics."""
    cfg, model, params, batch = _setup(name, in_dir)
    fl = FLConfig(**FL_KW)
    specs = train.state_specs(model, cfg, constrained)
    init = (optimizer.ssca_constrained_init if constrained
            else optimizer.ssca_init)
    state = train.shard_state(init(params), mesh, specs)
    step = train.sharded_train_step(model, cfg, fl, mesh, batch, constrained)
    local = _rows(mesh, batch)
    out = {}
    for i in range(TRAIN_STEPS):
        state, ms = step(state, local)
        for k, v in ms.items():
            out[f"m{i}/{k}"] = np.asarray(float(v))
        whole = mesh_lib.gather_tree(state.params, mesh, specs.params)
        out.update({f"p{i}/{k}": v for k, v in flat(
            convert.params_to_numpy(whole)).items()})
    if constrained:
        out["d"] = state.cons.d.numpy()
        g = mesh_lib.gather_tree(state.cons.g, mesh, specs.params)
        out["g_sq"] = np.asarray(sum(float((t.double() ** 2).sum())
                                     for t in _leaves(g)))
    return out


def _leaves(tree):
    from repro_torch.core.tree import leaves
    return leaves(tree)


def ep_layer(mesh, in_dir):
    """layers.moe_expert_parallel of layer 0's MoE on a numpy-seeded
    (B, S, D) x under the mesh: out (whole) and aux."""
    cfg, _, params, _ = _setup("moe_ep", in_dir)
    moe = {k: v[0] for k, v in params["layers"]["moe"].items()}
    spec = {k: P(*s[1:]) for k, s in
            get_model(cfg).param_specs(cfg, "serve")["layers"]["moe"].items()}
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32))
    with mesh_lib.use_mesh(mesh):
        out, aux = layers.moe_expert_parallel(
            mesh_lib.shard_tree(moe, mesh, spec), _rows(mesh, {"x": x})["x"], cfg)
    return {"out": _whole_rows(mesh, {"o": out})["o"].numpy(),
            "aux": aux.numpy()}


def ep_grad(mesh, in_dir):
    """The sharded train step's gradient (whole, before the update) and
    loss for the expert-parallel qwen3-moe smoke model."""
    cfg, model, params, batch = _setup("moe_ep", in_dir)
    specs = train.state_specs(model, cfg, False)
    state = train.shard_state(optimizer.ssca_init(params), mesh, specs)
    step = train.sharded_train_step(model, cfg, FLConfig(**FL_KW), mesh, batch)
    loss, grad = step.grad_of(state, _rows(mesh, batch))
    whole = mesh_lib.gather_tree(views(grad, state.params), mesh, specs.params)
    return {"loss": loss.numpy(),
            **{"g/" + k: v for k, v in flat(
                convert.params_to_numpy(whole)).items()}}


class _AllReduceBoth(torch.autograd.Function):
    """A planted combine: the model-axis sum in the forward and again in
    the backward (``torch.distributed.nn``'s all_reduce)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh_lib.all_reduce_axes(x.contiguous().clone(), mesh, "model")

    @staticmethod
    def backward(ctx, g):
        return mesh_lib.all_reduce_axes(g.contiguous().clone(), ctx.mesh,
                                        "model"), None


def _aux_on_every_model_rank(mesh):
    data = mesh_lib.data_axes(mesh)
    return (float(mesh_lib.axis_size(mesh, data))
            if mesh_lib.axis_index(mesh, data) == 0 else 0.0)


def run_case(case, mesh, in_dir):
    if case.startswith("decode_"):
        return decode(case[len("decode_"):], mesh, in_dir)
    if case.startswith("train_"):
        name, kind = case[len("train_"):].rsplit("_", 1)
        return train_case(name, kind == "constrained", mesh, in_dir)
    if case == "ep_layer":
        return ep_layer(mesh, in_dir)
    planted = {"ep_grad_combine_allreduce": ("_combine", lambda out, m:
                                             _AllReduceBoth.apply(out, m)),
               "ep_grad_aux_every_model_rank": ("_aux_grad_weight",
                                                _aux_on_every_model_rank)}
    if case in planted:
        attr, fn = planted[case]
        orig = getattr(layers, attr)
        setattr(layers, attr, fn)
        try:
            return ep_grad(mesh, in_dir)
        finally:
            setattr(layers, attr, orig)
    if case == "ep_grad":
        return ep_grad(mesh, in_dir)
    raise KeyError(case)


# ---------------------------------------------------------------------------
# the group
# ---------------------------------------------------------------------------


def out_path(out_dir, case: str, world: int, rank: int) -> Path:
    return Path(out_dir) / f"{case}.d{world}.r{rank}.npz"


def load(out_dir, case: str, world: int, rank: int) -> dict:
    with np.load(out_path(out_dir, case, world, rank)) as f:
        return {k: f[k] for k in f.files}


def spawn(suites, in_dir, out_dir, timeout: float = 240.0):
    """Start a gloo group for every (suite, world) of ``suites`` at once,
    each rank running the suite's cases; raise with the ranks' output if
    one fails or the time runs out."""
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT / "src")}
    procs = []
    for suite, world in suites:
        store = Path(out_dir) / f"{suite}.store{world}"
        for r in range(world):
            procs.append((suite, world, r, subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), suite, str(r),
                 str(world), str(store), str(in_dir), str(out_dir)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                text=True)))
    end = time.monotonic() + timeout
    fails = []
    for suite, world, r, p in procs:
        try:
            out, _ = p.communicate(timeout=max(1.0, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            for *_, q in procs:
                q.kill()
            raise RuntimeError(f"{suite}: rank {r} of {world} timed out")
        if p.returncode:
            fails.append(f"--- {suite} rank {r} of {world} (exit "
                         f"{p.returncode}):\n{out[-4000:]}")
    if fails:
        raise RuntimeError("\n".join(fails))


def main(argv):
    suite, rank, world, store, in_dir, out_dir = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        mesh = mesh_lib.make_mesh(SHAPES[world], device="cpu")
        for case in SUITES[suite]:
            res = run_case(case, mesh, in_dir)
            np.savez(out_path(out_dir, case, world, rank), **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
