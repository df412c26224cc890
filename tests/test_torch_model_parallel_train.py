"""The port's sharded train step on a 4-rank gloo group, a (2, 2) ("data",
"model") mesh, against the reference's ``jit_train_step`` on 4 virtual CPU
devices (``tests/jax_model_parallel_oracle.py`` "train", run beside the
group): qwen2.5-3b, qwen3-moe-30b-a3b (fsdp MoE: the global capacity,
slots and aux over the data shards), both with remat (the layer's params
gathered again in its recompute), and xlstm-1.3b with an sLSTM block, at
the smoke size, each dense and constrained, two steps from the same
params. Dense: the params within 1e-5 after each step and the loss rtol
1e-5. Constrained, as tests/test_torch_constrained.py holds the
constrained step (the reference run with ``jnp.sum`` dots in place of its
``jnp.vdot``s): loss, ν and ‖ω‖² within 1e-5 (absolute and relative), the
slack within 8 fp32 ulps of its terms' scale, the params within 1e-5. Every
rank's results are equal. On a one-rank mesh the sharded step is the local
step bit for bit.
"""
import numpy as np
import pytest
import torch

import torch_model_parallel_ranks as R
from test_torch_model_parallel import _close, jax_result, ranks_equal, run_beside_oracle
from repro_torch import random as rnd
from repro_torch.configs.base import FLConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import optimizer
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.models.api import get_model

CASES = [f"train_{n}_{'constrained' if k else 'dense'}" for n, k in R.TRAIN]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several processes at once: two PyTorch threads a
    process keep them from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    return run_beside_oracle(tmp_path_factory.mktemp("model_parallel_train"),
                             ["train"], [("train", 4)])


def _slack_atol(d, g_sq, tau):
    """8 fp32 ulps of the slack's terms, |d| and ‖g‖²/(4τ)
    (tests/test_torch_constrained.py's)."""
    scale = max(abs(float(d)), float(g_sq) / (4 * tau))
    return 8 * float(np.spacing(np.float32(scale)))


@pytest.mark.parametrize("case", CASES)
def test_sharded_train_step_matches_jit_train_step(out, case):
    got, want = R.load(out, case, 4, 0), jax_result(out, case)
    constrained = case.endswith("constrained")
    for i in range(R.TRAIN_STEPS):
        params = [k for k in want if k.startswith(f"p{i}/")]
        assert params and set(params) == {k for k in got if k.startswith(f"p{i}/")}
        for k in params:
            _close(got[k], want[k], f"{case} step {i} {k}", atol=1e-5)
        _close(got[f"m{i}/loss"], want[f"m{i}/loss"], "loss", rtol=1e-5)
        if constrained:
            for k in ("nu", "l2"):
                _close(got[f"m{i}/{k}"], want[f"m{i}/{k}"], k, atol=1e-5, rtol=1e-5)
    if constrained:
        last = R.TRAIN_STEPS - 1
        _close(got[f"m{last}/slack"], want[f"m{last}/slack"], "slack",
               atol=_slack_atol(got["d"], got["g_sq"], R.FL_KW["tau"]))


@pytest.mark.parametrize("case", CASES)
def test_sharded_train_ranks_are_equal(out, case):
    ranks_equal(out, case, 4)


@pytest.mark.parametrize("constrained", [False, True])
def test_one_rank_step_is_the_local_step(constrained):
    """On a 1x1 mesh the state placed by ``shard_state`` is the state
    itself, and two sharded steps leave the params bit-equal to the local
    step's."""
    cfg = get_config("qwen2.5-3b").smoke()
    model = get_model(cfg)
    params = model.init(rnd.PRNGKey(0, device="cpu"), cfg, device="cpu")
    tok = rnd.randint(rnd.PRNGKey(1, device="cpu"), (2, 9), 0, cfg.vocab_size)
    batch = {"tokens": tok[:, :8], "targets": tok[:, 1:]}
    fl = FLConfig(**R.FL_KW)
    init = optimizer.ssca_constrained_init if constrained else optimizer.ssca_init
    mesh = tmesh.make_mesh((1, 1), device="cpu")
    specs = ttrain.state_specs(model, cfg, constrained)
    sharded = init(params)
    assert ttrain.shard_state(sharded, mesh, specs) is sharded
    local = init(params)
    step = ttrain.sharded_train_step(model, cfg, fl, mesh, batch, constrained)
    local_step = (ttrain.make_constrained_train_step if constrained
                  else ttrain.make_train_step)(model, cfg, fl)
    for _ in range(2):
        sharded, ms = step(sharded, batch)
        local, lms = local_step(local, batch)
        assert all(torch.equal(ms[k], lms[k]) for k in ("loss",))
    assert torch.equal(sharded.w_flat, local.w_flat)
    assert torch.equal(sharded.g_flat, local.g_flat)
