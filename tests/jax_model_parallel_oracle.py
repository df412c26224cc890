"""The JAX package's side of ``tests/test_torch_model_parallel.py``: the
reference's own sharded functions on a mesh of 4 virtual CPU devices, on
the inputs of ``tests/torch_model_parallel_ranks.py``.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        python tests/jax_model_parallel_oracle.py SUITE IN OUT

SUITE "decode": each config's unsharded prefill, then GEN steps of the
reference's ``jit_decode_step`` on the (2, 2) ("data", "model") mesh: its
step jitted with its in- and out-shardings, returning the logits beside
the cache, whose argmax is the token it returns (one compile a config).
"train": TRAIN_STEPS steps of ``jit_train_step`` on that mesh. "ep": the
expert-parallel MoE layer under ``with mesh:`` on the (2, 2) and (1, 2)
meshes, and the gradient of the reference's math for the expert-parallel
train step, which its shard_map gradient cannot give on this JAX: the mean
over data shards of ``loss_fn`` on each shard's rows (``moe_sharding=
"fsdp"``, each shard's own capacity, as expert-parallel computes it), with
every layer's aux taken from data shard 0 (the value the forward
returns). Each case writes ``OUT/jax_<case>.npz``.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as JP

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_model_parallel_ranks as R  # noqa: E402
from repro.configs.base import FLConfig  # noqa: E402
from repro.configs.registry import ARCHS  # noqa: E402
from repro.core import optimizer, solvers, surrogate  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import serve, train  # noqa: E402
from repro.models import get_model  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402


def mesh_of(shape):
    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), ("data", "model"))


def setup(name, in_dir):
    _, cfg = R.config(name, lambda a: ARCHS[a].smoke())
    params = jax.tree.map(jnp.asarray, R.load_tree(Path(in_dir) / f"{name}.npz"))
    batch = {k: jnp.asarray(v) for k, v in R.inputs(name, cfg).items()}
    return cfg, get_model(cfg), params, batch


def greedy(logits):
    return jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)[:, None]


def decode(name, in_dir):
    cfg, model, params, batch = setup(name, in_dir)
    del batch["targets"]
    pfx = R.prefix_len(cfg)
    logits, cache = model.prefill(params, batch, cfg)
    cache = serve.grow_cache(cache, R.GEN)
    tok = greedy(logits)
    mesh = mesh_of((2, 2))
    with mesh:
        # jit_decode_step's shardings (src/repro/launch/serve.py:43-52)
        pspec = jmesh.named(mesh, model.param_specs(cfg, mode="serve"))
        cspec = jmesh.named(mesh, jmesh.adapt_for_mesh(model.cache_specs(cfg),
                                                       mesh))
        tspec = NamedSharding(mesh, JP(jmesh.data_axes(mesh)))
        fwd = jax.jit(lambda p, c, t, pos: model.decode_step(p, c, t, pos, cfg),
                      in_shardings=(pspec, cspec, tspec, NamedSharding(mesh, JP())),
                      out_shardings=(tspec, cspec))
        out = {}
        for i in range(R.GEN):
            lg, cache = fwd(params, cache, tok, pfx + R.S + i)
            tok = greedy(lg)
            out[f"tokens{i}"], out[f"logits{i}"] = np.asarray(tok), np.asarray(lg)
    out.update({"cache/" + k: v for k, v in R.flat(
        jax.tree.map(np.asarray, cache)).items()})
    return out


def accurate_dots():
    """The reference's ``tree_dot`` with ``jnp.sum`` of the products in
    place of its ``jnp.vdot``s, as tests/test_torch_constrained.py runs the
    constrained reference (whose vdot sums drift 4e-5 at the smoke size);
    the JAX package's files are untouched."""
    def tree_dot(x, y):
        return sum(jnp.sum(u.astype(jnp.float32) * v.astype(jnp.float32))
                   for u, v in zip(jax.tree.leaves(x), jax.tree.leaves(y)))

    for mod in (surrogate, optimizer, solvers):
        mod.tree_dot = tree_dot
        mod.tree_l2sq = lambda x: tree_dot(x, x)


def train_case(name, constrained, in_dir):
    cfg, model, params, batch = setup(name, in_dir)
    fl = FLConfig(**R.FL_KW)
    init = (optimizer.ssca_constrained_init if constrained
            else optimizer.ssca_init)
    state = init(params)
    mesh = mesh_of((2, 2))
    out = {}
    with mesh:
        step = train.jit_train_step(model, cfg, fl, mesh, batch, constrained)
        for i in range(R.TRAIN_STEPS):
            state, ms = step(state, batch)
            out.update({f"m{i}/{k}": np.asarray(v) for k, v in ms.items()})
            out.update({f"p{i}/{k}": v for k, v in R.flat(
                jax.tree.map(np.asarray, state.params)).items()})
    return out


def ep_layer(shape, in_dir):
    cfg, _, params, _ = setup("moe_ep", in_dir)
    moe = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
    x = jnp.asarray(np.random.default_rng(5).standard_normal(
        (R.B, R.S, cfg.d_model)).astype(np.float32))
    with mesh_of(shape):
        out, aux = jL.moe_expert_parallel(moe, x, cfg)
    return {"out": np.asarray(out), "aux": np.asarray(aux)}


def ep_grad(shards, in_dir):
    cfg, _, params, batch = setup("moe_ep", in_dir)
    fsdp = dataclasses.replace(cfg, moe_sharding="fsdp")
    b = R.B // shards
    parts = [{k: v[r * b:(r + 1) * b] for k, v in batch.items()}
             for r in range(shards)]

    def aux_of(p, bt):
        x, positions, mask, _ = jtr._inputs_to_states(p, bt, fsdp)
        return jtr.backbone(p, x, positions, fsdp, mask)[1]

    def oracle(p):
        loss = sum(jtr.loss_fn(p, bt, fsdp) for bt in parts) / shards
        aux = [aux_of(p, bt) for bt in parts]
        return loss + 0.01 / max(1, cfg.n_layers) * (aux[0] - sum(aux) / shards)

    loss, g = jax.jit(jax.value_and_grad(oracle))(params)
    return {"loss": np.asarray(loss),
            **{"g/" + k: v for k, v in R.flat(
                jax.tree.map(np.asarray, g)).items()}}


def main(suite, in_dir, out_dir):
    if suite == "decode":
        cases = {f"decode_{n}": (decode, n) for n in R.DECODE}
    elif suite == "train":
        accurate_dots()
        cases = {f"train_{n}_{'constrained' if k else 'dense'}": (
            lambda a, d: train_case(a[0], a[1], d), (n, k)) for n, k in R.TRAIN}
    else:
        cases = {"ep_layer.d4": (ep_layer, (2, 2)), "ep_layer.d2": (ep_layer, (1, 2)),
                 "ep_grad.d4": (ep_grad, 2), "ep_grad.d2": (ep_grad, 1)}
    for case, (fn, arg) in cases.items():
        np.savez(Path(out_dir) / f"jax_{case}.npz", **fn(arg, in_dir))


if __name__ == "__main__":
    main(*sys.argv[1:])
