"""The port's model-parallel decode and expert-parallel MoE on gloo groups
of CPU processes, against the reference's own sharded functions.

Once per module, beside a JAX subprocess on 4 virtual CPU devices
(``tests/jax_model_parallel_oracle.py`` "decode" and "ep"), a 4-rank gloo
group on a (2, 2) ("data", "model") mesh runs ``tests/
torch_model_parallel_ranks.py``'s decode and expert-parallel cases, and a
2-rank group on a (1, 2) mesh the expert-parallel ones. Params are the
port's smoke init fed to both packages; tokens, prefix and frames come from
numpy seeds.

``sharded_decode_step`` for every family with a decode (dense, MoE with
fsdp and expert-parallel experts, the VLM, xLSTM with an sLSTM block,
zamba2, the encoder-decoder, and a 16-K/V-head config whose cache shards
its heads rather than its rows): tokens equal and logits within 1e-5 of
``jit_decode_step``'s, every rank alike, and the cache within 1e-4 of
max(1, |entry|) (the SSM consistency gate's standard: each side prefills
unsharded, and zamba2's steep smoke model moves its shared block's K/V by
2e-5 between the two packages' prefills). ``moe_expert_parallel``'s
forward within 1e-6 (absolute and relative: the two packages' fp32
products round apart at that size) of the reference's under ``with
mesh:``, its aux data shard 0's; the expert-parallel train
step's gradient within 1e-5 of the reference's math (the reference's
shard_map gradient does not run on this JAX), and two planted faults (a
combine whose backward all-reduces, aux's gradient on every model rank)
outside it. On one rank the sharded decode is the local one bit for bit.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_model_parallel_ranks as R
from repro_torch.configs.registry import get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.models.api import get_model

ORACLE = R.ROOT / "tests" / "jax_model_parallel_oracle.py"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several processes at once: two PyTorch threads a
    process keep them from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def oracle_env():
    return {**os.environ, "PYTHONPATH": str(R.ROOT / "src"), "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
            "OMP_NUM_THREADS": "1"}


def run_beside_oracle(tmp, oracle_suites, rank_suites):
    """The port's params to ``tmp/in``, then the JAX oracle's suites (one
    process each) and the gloo groups at once; returns the output dir."""
    in_dir, out = tmp / "in", tmp / "out"
    in_dir.mkdir()
    out.mkdir()
    R.write_params(in_dir)
    jax_procs = [subprocess.Popen(
        [sys.executable, str(ORACLE), s, str(in_dir), str(out)],
        env=oracle_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for s in oracle_suites]
    try:
        R.spawn(rank_suites, in_dir, out)
    finally:
        logs = [p.communicate(timeout=240)[0] for p in jax_procs]
    for p, log in zip(jax_procs, logs):
        assert p.returncode == 0, log[-4000:]
    return out


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    return run_beside_oracle(tmp_path_factory.mktemp("model_parallel"),
                             ["decode", "ep"],
                             [("decode", 4), ("ep", 4), ("ep", 2)])


def jax_result(out, case):
    with np.load(out / f"jax_{case}.npz") as f:
        return {k: f[k] for k in f.files}


def _close(got, want, what, atol=0.0, rtol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    assert (err <= atol + rtol * np.abs(want)).all(), \
        f"{what}: max |diff| {err.max()} (atol {atol}, rtol {rtol})"


def ranks_equal(out, case, world):
    first = R.load(out, case, world, 0)
    for r in range(1, world):
        res = R.load(out, case, world, r)
        for k, v in first.items():
            np.testing.assert_array_equal(res[k], v, err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("name", R.DECODE)
def test_sharded_decode_matches_jit_decode_step(out, name):
    got, want = R.load(out, f"decode_{name}", 4, 0), jax_result(out, f"decode_{name}")
    # the step's token is its forward's argmax
    np.testing.assert_array_equal(got["step_token0"], got["tokens0"])
    for i in range(R.GEN):
        np.testing.assert_array_equal(got[f"tokens{i}"], want[f"tokens{i}"],
                                      err_msg=f"step {i}")
        _close(got[f"logits{i}"], want[f"logits{i}"], f"logits {i}", atol=1e-5)
    caches = [k for k in want if k.startswith("cache/")]
    assert caches and set(caches) == {k for k in got if k.startswith("cache/")}
    for k in caches:
        scale = np.maximum(1.0, np.abs(want[k].astype(np.float64)))
        err = np.abs(got[k].astype(np.float64) - want[k]) / scale
        assert err.max() <= 1e-4, (k, err.max())


@pytest.mark.parametrize("name", R.DECODE)
def test_sharded_decode_ranks_are_equal(out, name):
    ranks_equal(out, f"decode_{name}", 4)


@pytest.mark.parametrize("world", [4, 2])
def test_expert_parallel_forward_matches_reference(out, world):
    """On (2, 2) and (1, 2) meshes: out within 1e-6 of the reference's
    shard_map under ``with mesh:``, and aux its value (data shard 0's)."""
    got, want = R.load(out, "ep_layer", world, 0), jax_result(out, f"ep_layer.d{world}")
    _close(got["out"], want["out"], "out", atol=1e-6, rtol=1e-6)
    _close(got["aux"], want["aux"], "aux", atol=1e-6)
    ranks_equal(out, "ep_layer", world)


def _grad_err(got, want):
    keys = [k for k in want if k.startswith("g/")]
    assert keys and set(keys) == {k for k in got if k.startswith("g/")}
    return max(float(np.abs(got[k].astype(np.float64) - want[k]).max())
               for k in keys)


GRAD_ATOL = 1e-5


@pytest.mark.parametrize("world", [4, 2])
def test_expert_parallel_gradient_matches_reference_math(out, world):
    """The sharded step's gradient (whole) and loss against value_and_grad
    of the mean over data shards of the reference's loss (aux from data
    shard 0); every rank alike."""
    got, want = R.load(out, "ep_grad", world, 0), jax_result(out, f"ep_grad.d{world}")
    _close(got["loss"], want["loss"], "loss", rtol=1e-6)
    assert _grad_err(got, want) <= GRAD_ATOL
    ranks_equal(out, "ep_grad", world)


@pytest.mark.parametrize("world", [4, 2])
@pytest.mark.parametrize("case", ["ep_grad_combine_allreduce",
                                  "ep_grad_aux_every_model_rank"])
def test_planted_expert_parallel_faults_fail_the_gradient_gate(out, world, case):
    """A combine whose backward all-reduces (M times the expert path) and
    aux's gradient on every model rank (M times aux) each leave the
    gradient gate."""
    got, want = R.load(out, case, world, 0), jax_result(out, f"ep_grad.d{world}")
    assert _grad_err(got, want) > 100 * GRAD_ATOL


def test_one_rank_decode_is_the_local_decode():
    """On a 1x1 mesh the sharded decode (expert-parallel MoE) returns the
    local decode's logits and cache bit for bit: no gather, no copy."""
    import dataclasses
    from repro_torch import random as rnd
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").smoke(),
                              moe_sharding="expert_parallel")
    model = get_model(cfg)
    params = model.init(rnd.PRNGKey(0, device="cpu"), cfg, device="cpu")
    tokens = rnd.randint(rnd.PRNGKey(1, device="cpu"), (2, 8), 0, cfg.vocab_size)
    cache = model.init_cache(cfg, 2, 11, device="cpu")
    logits, cache = model.prefill(params, {"tokens": tokens}, cfg, cache=cache)
    tok = tserve._greedy(logits)
    mesh = tmesh.make_mesh((1, 1), device="cpu")
    placed = tmesh.shard_tree(cache, mesh, model.cache_specs(cfg))
    assert all(placed[k] is cache[k] for k in cache)
    other = {k: v.clone() for k, v in cache.items()}
    step = tserve.sharded_decode_step(model, cfg, mesh)
    for i in range(3):
        want, other = model.decode_step(params, other, tok, 8 + i, cfg)
        got, placed = step.forward(params, placed, tok, 8 + i)
        assert torch.equal(got, want)
        tok = tserve._greedy(got)
    assert all(torch.equal(placed[k], other[k]) for k in cache)
