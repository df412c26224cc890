"""The dry run (``repro.launch.dryrun``): every (arch × input shape × mesh)
traced on the meta device against the production meshes, (16, 16) and
(2, 16, 16), with no process group and nothing allocated, and each rank's
bytes, counted cost and roofline terms printed.

Each combination runs as rank 0 of a ``mesh.StandInMesh``: its collectives
return meta outputs of the right shapes and report their bytes to the cost
counter, and every coordinate is 0. The params, batch and cache are meta
tensors (``configs/shapes.py``), their specs fitted to the shapes
(``mesh.fit_specs``) and cut to rank 0's blocks (``mesh.shard_tree``). Then
the real steps run once under ``roofline.cost.CostCounter``:
``train.sharded_train_step`` (``--constrained``: the constrained step),
the prefill under ``param_specs(cfg, "serve")`` through ``mesh.Gathered``,
and ``serve.sharded_decode_step``. A step that reads a value back fails
on meta, as a host sync should.

CLI:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] \\
      [--constrained] [--set attention_block=256] [--json out.json]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback

import torch

from repro_torch import random as rnd
from repro_torch.configs.base import FLConfig
from repro_torch.configs.registry import ASSIGNED, get_config
from repro_torch.configs.shapes import SHAPES, supports_shape
from repro_torch.configs import shapes as shapes_lib
from repro_torch.core import optimizer
from repro_torch.core.tree import leaves
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve as serve_lib
from repro_torch.launch import train as train_lib
from repro_torch.models import layers as L
from repro_torch.models.encdec import SELF_CACHE_MAX
from repro_torch.models.api import get_model
from repro_torch.roofline import (active_params, count_params, model_flops,
                                  roofline_terms)
from repro_torch.roofline.cost import CostCounter


def param_shapes(model, cfg):
    """The params of ``cfg`` as meta tensors: init on the meta device,
    which draws nothing."""
    return model.init(rnd.PRNGKey(0, device="meta"), cfg, device="meta")


def local_bytes(tree, specs, mesh) -> int:
    """The bytes of rank 0's blocks of ``tree``'s leaves under ``specs``:
    each dim divided by the size of the axes its entry names."""
    total = 0
    for spec, t in zip(leaves(specs), leaves(tree)):
        shape = list(t.shape)
        for i, e in enumerate(spec):
            shape[i] //= mesh_lib.axis_size(mesh, e)
        total += math.prod(shape) * t.element_size()
    return total


def _state_bytes(state) -> int:
    """The bytes a train state holds: its flat buffers and 0-d tensors
    (its params and surrogate buffers are views of the flat ones)."""
    total = 0
    for f in state._fields:
        v = getattr(state, f)
        if isinstance(v, tuple):                    # QuadSurrogate: d
            v = v[0]
        if isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
    return total


def _typed(cfg, overrides):
    """``--set`` values as the reference types them: true/false as bools,
    integers as ints, the rest as strings (a float field takes a float)."""
    fields = {f.name: f.type for f in dataclasses.fields(cfg)}
    typed = {}
    for k, v in overrides.items():
        if k not in fields:
            raise KeyError(f"unknown ModelConfig field {k!r}")
        if isinstance(v, str):
            if v.lower() in ("true", "false"):
                v = v.lower() == "true"
            elif v.lstrip("-").isdigit():
                v = int(v)
            elif fields[k] == "float":
                v = float(v)
        typed[k] = v
    return typed


def decode_pos(cfg, shape) -> int:
    """The row a dry-run decode step writes: the last of its seq_len-deep
    cache (an encoder-decoder's self cache holds at most SELF_CACHE_MAX
    rows)."""
    rows = shape.seq_len
    return (min(rows, SELF_CACHE_MAX) if cfg.family == "audio" else rows) - 1


def lower_one(arch: str, shape_name: str, *, multi_pod: bool = False,
              constrained: bool = False, fl: FLConfig = None, verbose: bool = True,
              overrides: dict = None):
    """Trace one (arch, shape, mesh) on the meta device under the cost
    counter. Returns the result dict (``status`` "ok" or "skipped", with
    the reference's reason); raises where the step fails.
    ``overrides``: ModelConfig field overrides (``--set``)."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **_typed(cfg, overrides))
    shape = SHAPES[shape_name]
    ok, why = supports_shape(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped", "why": why}

    mesh = mesh_lib.production_stand_in(multi_pod)
    model = get_model(cfg)
    fl = fl or FLConfig(tau=0.2, l2_lambda=1e-5)
    t0 = time.time()
    params = param_shapes(model, cfg)
    axes = mesh_lib.data_axes(mesh)
    cache_bytes = 0

    def local_batch(batch):
        specs = mesh_lib.fit_specs(train_lib.batch_specs(batch, mesh), batch, mesh)
        return mesh_lib.shard_tree(batch, mesh, specs, "batch")

    counter = CostCounter()
    if shape.kind == "train":
        batch = shapes_lib.train_specs(cfg, shape)
        specs = train_lib.state_specs(model, cfg, constrained)
        pspecs = mesh_lib.fit_specs(specs.params, params, mesh)
        specs = specs._replace(params=pspecs, **(
            {"cons": specs.cons._replace(g=pspecs)} if constrained else {"g": pspecs}))
        whole = (optimizer.ssca_constrained_init if constrained
                 else optimizer.ssca_init)(params)
        state = train_lib.shard_state(whole, mesh, specs)
        del whole
        lb = local_batch(batch)
        step = train_lib.sharded_train_step(model, cfg, fl, mesh, batch,
                                            constrained=constrained, specs=specs)
        param_bytes = local_bytes(params, pspecs, mesh)
        state_bytes = _state_bytes(state)
        with counter:
            step(state, lb)
        num_tokens = shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        batch = shapes_lib.prefill_specs(cfg, shape)
        pspecs = mesh_lib.fit_specs(model.param_specs(cfg, mode="serve"), params, mesh)
        local = mesh_lib.shard_tree(params, mesh, pspecs, "params")
        plans = L.param_plans(cfg, pspecs, mesh)
        lb = local_batch(batch)
        param_bytes = local_bytes(params, pspecs, mesh)
        with counter, torch.no_grad(), mesh_lib.use_mesh(mesh):
            _, cache = model.prefill(mesh_lib.Gathered(local, plans, mesh), lb, cfg)
        # the cache the prefill returns: this rank's rows, whole
        cache_bytes = sum(t.numel() * t.element_size() for t in leaves(cache))
        state_bytes = param_bytes + cache_bytes
        num_tokens = shape.global_batch * shape.seq_len
    else:
        token, _, cache = shapes_lib.decode_specs(cfg, shape)
        pspecs = mesh_lib.fit_specs(model.param_specs(cfg, mode="serve"), params, mesh)
        cspecs = mesh_lib.fit_specs(mesh_lib.adapt_for_mesh(model.cache_specs(cfg), mesh), cache,
                      mesh)
        local = mesh_lib.shard_tree(params, mesh, pspecs, "params")
        lcache = mesh_lib.shard_tree(cache, mesh, cspecs, "cache")
        ltoken = mesh_lib.shard_tree(token, mesh, mesh_lib.fit_specs(mesh_lib.P(axes), token, mesh),
                                     "token")
        step = serve_lib.sharded_decode_step(model, cfg, mesh, pspecs, cspecs)
        param_bytes = local_bytes(params, pspecs, mesh)
        cache_bytes = local_bytes(cache, cspecs, mesh)
        state_bytes = param_bytes + cache_bytes
        with counter:
            step(local, lcache, ltoken, decode_pos(cfg, shape))
        num_tokens = shape.global_batch           # one new token a sequence
    seconds = time.time() - t0

    cost = counter.summary()
    coll = cost["collectives"]
    terms = roofline_terms(cost, coll["total"])
    n_params = count_params(params)
    n_active = active_params(cfg, params)
    chips = math.prod(mesh.shape)
    mflops = model_flops(cfg, num_tokens, n_params, n_active)
    if shape.kind != "train":
        mflops /= 3.0                             # forward only: 2ND
    useful = mflops / chips / max(terms["flops"], 1e-30)
    result = {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
        "status": "ok", "compile_s": round(seconds, 1),
        "params": n_params, "active_params": n_active,
        "model_flops_per_chip": mflops / chips,
        "useful_flop_ratio": useful,
        "memory": {"param_bytes": param_bytes, "cache_bytes": cache_bytes,
                   "state_bytes": state_bytes},
        "collectives": coll,
        "kernels": cost["kernels"],
        **{k: terms[k] for k in ("flops", "bytes", "collective_bytes",
                                 "compute_s", "memory_s", "collective_s",
                                 "bottleneck")},
    }
    if verbose:
        print(f"[{result['mesh']}] {arch} x {shape_name}: OK "
              f"trace={seconds:.1f}s bottleneck={result['bottleneck']} "
              f"compute={terms['compute_s']*1e3:.2f}ms "
              f"memory={terms['memory_s']*1e3:.2f}ms "
              f"collective={terms['collective_s']*1e3:.2f}ms "
              f"useful={useful:.3f}", flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--constrained", action="store_true")
    ap.add_argument("--json", default=None)
    ap.add_argument("--set", action="append", default=[],
                    help="ModelConfig override, e.g. --set attention_block=256")
    args = ap.parse_args(argv)
    overrides = dict(s.split("=", 1) for s in args.set)

    archs = ASSIGNED if args.all else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    combos = [(a, s, mp) for mp in meshes for a in archs for s in shapes]

    results, failures = [], []
    for a, s, mp in combos:
        try:
            r = lower_one(a, s, multi_pod=mp, constrained=args.constrained,
                          overrides=overrides)
        except Exception as e:
            traceback.print_exc()
            r = {"arch": a, "shape": s, "mesh": "2x16x16" if mp else "16x16",
                 "status": "error", "error": f"{type(e).__name__}: {e}"}
            failures.append(r)
            print(f"[{'2x16x16' if mp else '16x16'}] {a} x {s}: FAIL {e}",
                  flush=True)
        results.append(r)

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    print(f"\n== dry-run: {n_ok} ok, {n_skip} skipped, {len(failures)} failed "
          f"of {len(results)}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1, default=str)
        print("wrote", args.json)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
