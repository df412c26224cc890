"""The dry run's input shapes (``repro_torch.configs.shapes``) against the
reference's ``repro.configs.shapes``: ``SHAPES``, ``ShapeConfig``,
``ASSIGNED`` and ``supports_shape`` equal; for every ASSIGNED arch and
every shape it supports, each spec a meta tensor of the reference's
``ShapeDtypeStruct``'s shape and dtype (the decode cache's leaves against
``jax.eval_shape`` of the reference's ``init_cache``, the port's from
``init_cache`` on the meta device); ``ModelConfig.smoke(**overrides)``
equal to the reference's, field by field. Nothing is allocated on either
side."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import shapes as jshapes
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import ASSIGNED as JASSIGNED
from repro_torch.configs import shapes as tshapes
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import ARCHS, ASSIGNED, get_config
from repro_torch.core.tree import leaves

CASES = [(a, s) for a in JASSIGNED for s in jshapes.SHAPES
         if jshapes.supports_shape(JARCHS[a], jshapes.SHAPES[s])[0]]


def _same_spec(got, want, what):
    assert isinstance(got, torch.Tensor) and got.device.type == "meta", what
    assert tuple(got.shape) == tuple(want.shape), (what, got.shape, want.shape)
    assert str(got.dtype).split(".")[-1] == np.dtype(want.dtype).name, (
        what, got.dtype, want.dtype)


def test_shapes_assigned_and_shape_config_match_reference():
    assert ASSIGNED == JASSIGNED
    assert [f.name for f in dataclasses.fields(ShapeConfig)] == \
        [f.name for f in dataclasses.fields(JShapeConfig)]
    assert list(tshapes.SHAPES) == list(jshapes.SHAPES)
    for name, shape in tshapes.SHAPES.items():
        assert dataclasses.astuple(shape) == dataclasses.astuple(jshapes.SHAPES[name])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_supports_shape_matches_reference(arch):
    for name, shape in tshapes.SHAPES.items():
        assert tshapes.supports_shape(get_config(arch), shape) == \
            jshapes.supports_shape(JARCHS[arch], jshapes.SHAPES[name])


@pytest.mark.parametrize("arch,shape", CASES, ids=[f"{a}-{s}" for a, s in CASES])
def test_input_specs_match_reference(arch, shape):
    kind, got = tshapes.input_specs(get_config(arch), shape)
    jkind, want = jshapes.input_specs(JARCHS[arch], shape)
    assert kind == jkind
    if kind != "decode":
        assert set(got) == set(want)
        for k in want:
            _same_spec(got[k], want[k], k)
        return
    (token, pos, cache), (jtoken, jpos, jcache) = got, want
    _same_spec(token, jtoken, "token")
    _same_spec(pos, jpos, "pos")
    got_leaves, want_leaves = leaves(cache), jax.tree.leaves(jcache)
    assert len(got_leaves) == len(want_leaves)
    for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
        _same_spec(g, w, f"cache leaf {i}")


def test_unsupported_shapes_are_refused_with_the_reference_reason():
    for arch, shape in (("qwen2.5-3b", "long_500k"), ("mnist-mlp", "decode_32k")):
        with pytest.raises(ValueError) as got:
            tshapes.input_specs(get_config(arch), shape)
        with pytest.raises(ValueError) as want:
            jshapes.input_specs(JARCHS[arch], shape)
        assert str(got.value).split("skipped: ")[1] == str(want.value).split("skipped: ")[1]


@pytest.mark.parametrize("overrides", [{}, {"n_layers": 3}, {"chunk_size": 64},
                                       {"dtype": "bfloat16", "remat": True}])
def test_smoke_overrides_match_reference(overrides):
    for arch in ("qwen2.5-3b", "xlstm-1.3b", "qwen3-moe-30b-a3b"):
        t, j = get_config(arch).smoke(**overrides), JARCHS[arch].smoke(**overrides)
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), (arch, f.name)
