"""The dry run (``repro_torch.launch.dryrun``) on the CPU with no process
group, against the reference's rules:

- mnist-mlp on both production meshes through the CLI: its train shape
  ``ok``, the other three skipped with the reference's ``supports_shape``
  reasons, and ``== dry-run: ...`` as the last line;
- one arch per family at one shape (and a VLM train on the multi-pod
  mesh), in a subprocess that starts no group: every row ``ok`` with
  FLOPs, bytes and a bottleneck, its per-rank param, cache and state bytes
  equal to the sum of rank 0's blocks of the fitted specs (computed here
  from ``mesh.fit_specs`` and ``mesh.shard_tree`` of the meta params,
  cache and state), its kernel launches those of the step, and the model
  axis's share of the dense train step's FLOPs near 1/16 (every weight
  is gathered whole on every model rank);
- a failing combination makes the CLI exit 1;
- the encoder-decoder's prefill past 4,096 decoder tokens (the dry run's
  prefill_32k), which failed before this slice: its cache now takes S
  self rows, as the reference's prefill returns them (held against the
  reference at the smoke size with the cap cut to 4 rows);
- the cost phase's gate on the CPU: a local train step and a decode step
  of the smoke qwen2.5-3b counted on CPU tensors give the FLOPs and
  launches of the same steps traced on meta tensors.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.configs.shapes import SHAPES as JSHAPES
from repro.configs.shapes import supports_shape as jsupports
from repro.models import encdec as jenc
from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.configs import shapes as shapes_lib
from repro_torch.configs.base import FLConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import optimizer
from repro_torch.core.tree import leaves
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve as serve_lib
from repro_torch.launch import train as train_lib
from repro_torch.models import encdec as tenc
from repro_torch.models.api import get_model
from repro_torch.roofline.cost import CostCounter

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "2"}
# one arch a family at one cheap shape (the dense and MoE decoders cut to 4
# layers by --set), on either mesh
FAMILY_CASES = [("qwen2.5-3b", "train_4k", False), ("qwen3-moe-30b-a3b", "decode_32k", False),
                ("paligemma-3b", "train_4k", True), ("xlstm-1.3b", "decode_32k", False),
                ("zamba2-1.2b", "long_500k", True), ("seamless-m4t-medium", "decode_32k", True)]
CUT = {"qwen2.5-3b": {"n_layers": 4}, "qwen3-moe-30b-a3b": {"n_layers": 4}}


def _run(args, tmp_path, timeout=300):
    out = subprocess.run([sys.executable, *args], cwd=tmp_path, env=ENV,
                         capture_output=True, text=True, timeout=timeout)
    return out.returncode, out.stdout, out.stderr


def test_mnist_mlp_on_both_meshes_through_the_cli(tmp_path):
    rc, out, err = _run(["-m", "repro_torch.launch.dryrun", "--arch", "mnist-mlp",
                         "--both-meshes", "--json", "out.json"], tmp_path)
    assert rc == 0, out + err
    rows = json.loads((tmp_path / "out.json").read_text())
    assert len(rows) == 8
    for r in rows:
        ok, why = jsupports(JARCHS["mnist-mlp"], JSHAPES[r["shape"]])
        assert r["status"] == ("ok" if ok else "skipped"), r
        if ok:
            assert r["mesh"] in ("16x16", "2x16x16") and r["flops"] > 0
            assert r["kernels"] == {"ssca_update": 1}
        else:
            assert r["why"] == why
    assert "== dry-run: 2 ok, 6 skipped, 0 failed of 8" in out.splitlines()[-2]


@pytest.fixture(scope="module")
def family_rows(tmp_path_factory):
    """The family cases' rows, from one subprocess that starts no process
    group."""
    tmp = tmp_path_factory.mktemp("dry")
    code = ("import json, sys; import torch.distributed as dist; "
            "from repro_torch.launch import dryrun; "
            f"cases = {FAMILY_CASES!r}; "
            f"cut = {CUT!r}; "
            "rows = [dryrun.lower_one(a, s, multi_pod=mp, verbose=False, "
            "overrides=cut.get(a)) for a, s, mp in cases]; "
            "assert not dist.is_initialized(), 'a process group started'; "
            "json.dump(rows, open('rows.json', 'w'))")
    rc, out, err = _run(["-c", code], tmp, timeout=600)
    assert rc == 0, out + err
    return json.loads((tmp / "rows.json").read_text())


def _local_bytes(tree, specs, mesh):
    """Bytes of rank 0's blocks, as ``shard_tree`` cuts them."""
    return sum(t.numel() * t.element_size()
               for t in leaves(mesh_lib.shard_tree(tree, mesh, specs)))


def _expected_bytes(arch, shape_name, multi_pod):
    cfg, shape = get_config(arch), shapes_lib.SHAPES[shape_name]
    cfg = dataclasses.replace(cfg, **CUT.get(arch, {}))
    model = get_model(cfg)
    mesh = mesh_lib.production_stand_in(multi_pod)
    params = dryrun.param_shapes(model, cfg)
    if shape.kind == "train":
        specs = mesh_lib.fit_specs(model.param_specs(cfg, "train"), params, mesh)
        local = mesh_lib.shard_tree(params, mesh, specs)
        state = optimizer.ssca_init(local)
        nstate = sum(t.numel() * t.element_size() for t in (state.w_flat, state.g_flat)
                     + tuple(x for x in (state.w_side, state.g_side) if x is not None))
        return _local_bytes(params, specs, mesh), 0, nstate
    specs = mesh_lib.fit_specs(model.param_specs(cfg, "serve"), params, mesh)
    p = _local_bytes(params, specs, mesh)
    if shape.kind == "decode":
        _, _, cache = shapes_lib.decode_specs(cfg, shape)
        cspecs = mesh_lib.fit_specs(
            mesh_lib.adapt_for_mesh(model.cache_specs(cfg), mesh), cache, mesh)
        c = _local_bytes(cache, cspecs, mesh)
        return p, c, p + c
    return p, None, None


@pytest.mark.parametrize("i", range(len(FAMILY_CASES)),
                         ids=[f"{a}-{s}-{'2x16x16' if mp else '16x16'}"
                              for a, s, mp in FAMILY_CASES])
def test_one_arch_per_family(family_rows, i):
    arch, shape, multi_pod = FAMILY_CASES[i]
    r = family_rows[i]
    assert (r["arch"], r["shape"], r["status"]) == (arch, shape, "ok"), r
    assert r["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert r["chips"] == (512 if multi_pod else 256)
    assert r["flops"] > 0 and r["bytes"] > 0
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert r["kernels"].get("rmsnorm", 0) > 0
    p, c, s = _expected_bytes(arch, shape, multi_pod)
    assert r["memory"]["param_bytes"] == p
    if c is not None:
        assert (r["memory"]["cache_bytes"], r["memory"]["state_bytes"]) == (c, s)
    else:       # the prefill's own cache: this rank's rows
        assert r["memory"]["state_bytes"] == p + r["memory"]["cache_bytes"] > p
    if shape == "train_4k":
        assert r["memory"]["state_bytes"] == s
        assert r["collectives"]["all-gather"] > 0 and r["collectives"]["reduce-scatter"] > 0
    if (arch, shape) == ("qwen2.5-3b", "train_4k"):
        # every weight gathered whole on each of the 16 model ranks: the
        # model axis adds no compute
        assert 0.03 < r["useful_flop_ratio"] < 1 / 16
        # 4 layers under remat: the forward's 2·L+1 norms and L attentions,
        # each layer's again in the recompute, and the backwards
        assert r["kernels"] == {"rmsnorm": 17, "flash_attention": 8,
                                "rmsnorm_bwd": 9, "flash_attention_bwd": 4,
                                "ssca_update": 1}


def test_cli_exits_1_on_a_failing_combination(capsys):
    rc = dryrun.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k",
                      "--set", "n_kv_heads=3"])
    out, err = capsys.readouterr()
    assert rc == 1
    assert "== dry-run: 0 ok, 0 skipped, 1 failed of 1" in out
    assert "query heads over 3 KV heads" in out + err


def test_encdec_prefill_past_the_self_cache_cap_matches_reference(monkeypatch):
    """The reference's prefill returns S self rows whatever S; the port's
    made its cache at min(S, 4096) rows and failed past them. With the cap
    cut to 4, a 6-token prefill gives the reference's 6 rows."""
    s = 6
    monkeypatch.setattr(tenc, "SELF_CACHE_MAX", 4)
    jcfg, tcfg = JARCHS["seamless-m4t-medium"].smoke(), get_config("seamless-m4t-medium").smoke()
    jp = jenc.init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(3)
    frames = rng.standard_normal((2, 4 * s, tcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, tcfg.vocab_size, (2, s), dtype=np.int32)
    _, want = jenc.prefill(jp, {"frame_embeddings": jnp.asarray(frames),
                                "tokens": jnp.asarray(toks)}, jcfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    _, got = tenc.prefill(tp, {"frame_embeddings": torch.from_numpy(frames),
                               "tokens": torch.from_numpy(toks)}, tcfg)
    assert got["self_k"].shape[2] == s
    for k in ("self_k", "self_v", "cross_k", "cross_v"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=2e-5,
                                   err_msg=k)
    # a given cache with fewer self rows than tokens is refused, naming them
    small = tenc.init_cache(tcfg, 2, s, device="cpu", enc_len=4 * s)
    with pytest.raises(ValueError, match="4 self rows for 6 tokens"):
        tenc.prefill(tp, {"frame_embeddings": torch.from_numpy(frames),
                          "tokens": torch.from_numpy(toks)}, tcfg, cache=small)


def _steps(device, b=2, s=16):
    """(train step, state, batch, decode step, params, cache, token, pos) of
    the smoke qwen2.5-3b on ``device`` (its weights drawn on the CPU, or
    meta tensors)."""
    cfg = get_config("qwen2.5-3b").smoke()
    model = get_model(cfg)
    if device == "meta":
        params = dryrun.param_shapes(model, cfg)
        toks = torch.empty(b, s, dtype=torch.int32, device="meta")
    else:
        params = model.init(rnd.PRNGKey(0, device="cpu"), cfg, device="cpu")
        toks = torch.randint(0, cfg.vocab_size, (b, s), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(0))
    step = train_lib.make_train_step(model, cfg, FLConfig(tau=0.2, l2_lambda=1e-5))
    state = optimizer.ssca_init(params)
    cache = model.init_cache(cfg, b, s + 4, device=device)
    decode = serve_lib.make_decode_step(model, cfg)
    return (step, state, {"tokens": toks, "targets": toks}, decode, params, cache,
            toks[:, :1], s)


def test_counted_cpu_steps_equal_the_meta_trace():
    """What chip_smoke's cost phase gates on the card, here on the CPU: the
    FLOPs and kernel launches of a train step and a decode step run on
    CPU tensors equal those of the same steps traced on meta tensors."""
    got = {}
    for device in ("cpu", "meta"):
        step, state, batch, decode, params, cache, token, pos = _steps(device)
        with CostCounter() as t:
            step(state, batch)
        with CostCounter() as d, torch.no_grad():
            decode(params, cache, token, pos)
        got[device] = [(c.summary()["flops"], c.summary()["kernels"]) for c in (t, d)]
    assert got["cpu"] == got["meta"]
    (train_flops, train_kernels), (_, decode_kernels) = got["cpu"]
    assert train_flops > 0
    # 2 layers, no remat: 2·L+1 norms and L attentions each way
    assert train_kernels == {"rmsnorm": 5, "flash_attention": 2, "rmsnorm_bwd": 5,
                             "flash_attention_bwd": 2, "ssca_update": 1}
    assert decode_kernels == {"rmsnorm": 5, "flash_attention": 2}
