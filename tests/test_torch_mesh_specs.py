"""The model-parallel launch layer's pure functions against the reference's,
on the CPU with no process group: every registry arch's ``param_specs``
(both modes; the MoE archs under each ``moe_sharding``) and every decoder's
``cache_specs`` equal the reference's entry for entry, and each spec tree
has the nesting of the port's own init tree (its shapes from init on the
meta device) or cache tree, a spec no longer than its leaf's dims. ``data_axes``, ``adapt_for_mesh`` and ``fit_specs`` equal
the reference's on (16, 16), (2, 16, 16), (2, 2) and (1, 4) meshes, the
batch-1 decode cache's re-homing included; both take a stand-in mesh (the
reference's reads ``axis_names`` and ``devices.shape``, the port's
``mesh_dim_names`` and ``shape``). ``named``'s placements, the steps'
refusal of a batch that does not divide, and ``make_production_mesh``'s
refusal on one rank, which starts no group.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.registry import ARCHS as JARCHS
from repro.launch import mesh as jmesh
from repro.models import get_model as jget_model
from repro_torch.configs.base import FLConfig
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.dryrun import param_shapes
from repro_torch.launch.mesh import P
from repro_torch.models.api import get_model

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2), ("data", "model")), ((1, 4), ("data", "model"))]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several processes at once: two PyTorch threads a
    process keep them from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def stand_ins(shape, axes):
    """(the port's mesh, the reference's mesh): the attributes each reads."""
    return (SimpleNamespace(mesh_dim_names=axes, shape=shape),
            SimpleNamespace(axis_names=axes, devices=np.empty(shape)))


def same(got, want, path=""):
    """Spec trees equal entry for entry (the port's P against the
    reference's PartitionSpec; both are tuples of entries)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got, want)
        for k in want:
            same(got[k], want[k], f"{path}/{k}")
    else:
        assert isinstance(got, P), (path, got)
        assert tuple(got) == tuple(want), (path, got, want)


def fits(specs, tree, path=""):
    """The spec tree has the tree's nesting, each spec no longer than its
    leaf's dims (a leaf: a tensor or its shape)."""
    if isinstance(tree, dict):
        assert set(specs) == set(tree), (path, set(specs) ^ set(tree))
        for k in tree:
            fits(specs[k], tree[k], f"{path}/{k}")
    else:
        shape = tuple(getattr(tree, "shape", tree))
        assert len(specs) <= len(shape), (path, specs, shape)


def _configs(arch):
    t, j = get_config(arch).smoke(), JARCHS[arch].smoke()
    if not t.n_experts:
        return [(t, j)]
    return [(dataclasses.replace(t, moe_sharding=m), dataclasses.replace(j, moe_sharding=m))
            for m in ("fsdp", "expert2d", "expert_parallel")]


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_equal_the_reference(arch, mode):
    """Against the port's init tree at the smoke size (its shapes, from
    init on the meta device: nothing drawn)."""
    for t, j in _configs(arch):
        model = get_model(t)
        specs = model.param_specs(t, mode)
        same(specs, jget_model(j).param_specs(j, mode), arch)
        fits(specs, _meta_params(model, t), arch)


@pytest.mark.parametrize("arch", sorted(a for a in ARCHS if a != "mnist-mlp"))
def test_cache_specs_equal_the_reference(arch):
    """Also where the port's tree differs in kind from the reference's
    (its SSM and encoder-decoder caches carry ``pos`` as a 0-d tensor,
    whose spec is P())."""
    t, j = get_config(arch).smoke(), JARCHS[arch].smoke()
    model = get_model(t)
    specs = model.cache_specs(t)
    same(specs, jget_model(j).cache_specs(j), arch)
    kw = {"enc_len": 8} if t.is_encdec else {}
    fits(specs, model.init_cache(t, 2, 8, device="cpu", **kw), arch)
    if "pos" in specs:
        assert specs["pos"] == P()


def test_kv_shardable_is_the_reference_literal_test():
    """The K/V heads go over "model" exactly when n_kv_heads % 16 == 0,
    whatever the mesh: gemma-7b's 16 heads do, qwen2.5-3b's 2 do not."""
    for arch, sharded in (("gemma-7b", True), ("qwen2.5-3b", False)):
        cfg = get_config(arch)
        attn = get_model(cfg).param_specs(cfg, "serve")["layers"]["attn"]
        assert (attn["wk"][2] == "model") is sharded
        cache = get_model(cfg).cache_specs(cfg)["k"]
        assert cache == (P(None, "data", None, "model", None) if sharded
                         else P(None, "data", "model", None, None))


@pytest.mark.parametrize("shape,axes", MESHES, ids=["16x16", "2x16x16", "2x2", "1x4"])
def test_data_axes_and_adapt_for_mesh_equal_the_reference(shape, axes):
    tm, jm = stand_ins(shape, axes)
    assert tmesh.data_axes(tm) == jmesh.data_axes(jm)
    for arch in ("qwen2.5-3b", "xlstm-1.3b", "zamba2-1.2b", "seamless-m4t-medium"):
        t, j = get_config(arch), JARCHS[arch]
        same(tmesh.adapt_for_mesh(get_model(t).cache_specs(t), tm),
             jmesh.adapt_for_mesh(jget_model(j).cache_specs(j), jm), arch)
        batch = {"tokens": None, "targets": None}
        same(ttrain.batch_specs(batch, tm), {k: jmesh.P(jmesh.data_axes(jm))
                                             for k in batch})


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


@pytest.mark.parametrize("shape,axes", MESHES, ids=["16x16", "2x16x16", "2x2", "1x4"])
@pytest.mark.parametrize("arch,batch", [("qwen2.5-3b", 1), ("qwen2.5-3b", 32),
                                        ("gemma-7b", 1), ("xlstm-1.3b", 1),
                                        ("zamba2-1.2b", 2),
                                        ("seamless-m4t-medium", 1),
                                        ("qwen3-moe-30b-a3b", 16)])
def test_fit_specs_equal_the_reference(arch, batch, shape, axes):
    """On the full-size param shapes (init on the meta device) and the
    decode cache of ``batch`` rows by 4,096 (a batch of 1 re-homes the
    "data" entry to the largest other dim it divides)."""
    tm, jm = stand_ins(shape, axes)
    t, j = get_config(arch), JARCHS[arch]
    model, jmodel = get_model(t), jget_model(j)
    kw = {"enc_len": 4096} if t.is_encdec else {}
    cache = _shapes(model.init_cache(t, batch, 4096, device="meta", **kw))
    cspecs = tmesh.adapt_for_mesh(model.cache_specs(t), tm)
    jcspecs = jmesh.adapt_for_mesh(jmodel.cache_specs(j), jm)
    fitted = tmesh.fit_specs(cspecs, cache, tm)
    same(fitted, jmesh.fit_specs(jcspecs, _jax_shapes(cache), jm))
    if batch == 1 and arch == "qwen2.5-3b" and shape == (16, 16):
        # "data" leaves the batch of 1 for the head dim (128), the largest
        # free dim it divides
        assert fitted["k"] == P(None, None, "model", None, "data")
    params = _meta_params(model, t)
    for mode in ("train", "serve"):
        same(tmesh.fit_specs(model.param_specs(t, mode), params, tm),
             jmesh.fit_specs(jmodel.param_specs(j, mode), _jax_shapes(params), jm))


def _jax_shapes(shapes):
    return {k: _jax_shapes(v) if isinstance(v, dict)
            else SimpleNamespace(shape=v) for k, v in shapes.items()}


_PARAM_SHAPES = {}


def _meta_params(model, cfg):
    """The params' shapes of ``cfg`` (a full-size or smoke config), from
    init on the meta device (``dryrun.param_shapes``: nothing drawn)."""
    if cfg.name not in _PARAM_SHAPES:
        _PARAM_SHAPES[cfg.name] = _shapes(param_shapes(model, cfg))
    return _PARAM_SHAPES[cfg.name]


def test_named_gives_the_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    tm, _ = stand_ins((2, 16, 16), ("pod", "data", "model"))
    got = tmesh.named(tm, {"w": P(None, "data", "model"), "b": P(("pod", "data")),
                           "s": P()})
    assert got == {"w": (Replicate(), Shard(1), Shard(2)),
                   "b": (Shard(0), Shard(0), Replicate()),
                   "s": (Replicate(), Replicate(), Replicate())}
    shapes = {"k": (32, 1, 4096, 2, 128)}
    fitted = tmesh.named_fitted(tm, {"k": P(None, ("pod", "data"), "model", None, None)},
                                shapes)
    # batch 1: ("pod", "data") re-homes to the largest free dim it divides
    assert fitted["k"] == (Shard(4), Shard(4), Shard(2))


def test_sharded_steps_refuse_what_does_not_divide():
    """A batch whose rows do not divide over the data axis, and a leaf
    whose dim does not divide over its axis, raise naming the dim."""
    tm, _ = stand_ins((2, 2), ("data", "model"))
    cfg = get_config("qwen2.5-3b").smoke()
    batch = {"tokens": torch.zeros(3, 8, dtype=torch.int64)}
    with pytest.raises(ValueError, match="batch 'tokens': dim 0 of"):
        ttrain.sharded_train_step(get_model(cfg), cfg, FLConfig(), tm, batch)
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.shard_tree({"w": torch.zeros(3, 4)}, tm, {"w": P("model", None)})


def test_production_mesh_refuses_one_rank_and_starts_no_group():
    assert not dist.is_initialized() or dist.get_world_size() == 1
    started = dist.is_initialized()
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"need {n} ranks"):
            tmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
    assert dist.is_initialized() == started
    assert tmesh.PRODUCTION[True] == ((2, 16, 16), ("pod", "data", "model"))


def test_sharded_decode_refuses_the_paper_mlp():
    cfg = get_config("mnist-mlp")
    tm, _ = stand_ins((1, 1), ("data", "model"))
    with pytest.raises(ValueError, match="no decode path"):
        tserve.sharded_decode_step(get_model(cfg), cfg, tm)
