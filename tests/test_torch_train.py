"""The port's training slice against the JAX reference on the CPU: the token
stream, the nested flat layout, the SSCA state, ``loss_fn`` and its
gradient, and the trajectory of ``make_scanned_step``, on qwen2.5-3b's
smoke variant (2 layers, d_model 256, 4 query heads over 2 KV heads,
head_dim 64, vocab 512, fp32), weights carried across by ``convert``.

Tolerances: tokens and windows bit-equal; loss rtol 1e-5 and gradients atol
1e-5 (fp32 sums in another order, and the flash softmax against the
reference's ``dot_attention``); 4 SSCA steps: each loss rtol 1e-5 and the
params atol 1e-5 after step 4, the roadmap's whole-trajectory standard.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import codecs as jcodecs
from repro.configs.base import FLConfig as JFLConfig
from repro.configs.registry import ARCHS as JARCHS
from repro.core import optimizer as jopt
from repro.core import rounds as jrounds
from repro.data import synthetic as jsyn
from repro.launch import train as jtrain
from repro.models import get_model as jget_model
from repro.models import transformer as jtr
from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.comm import codecs as tcodecs
from repro_torch.configs.base import FLConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import optimizer as topt
from repro_torch.core import privacy as tpriv
from repro_torch.core import rounds as trounds
from repro_torch.core.tree import leaves
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from repro_torch.models import transformer as ttr

JCFG = JARCHS["qwen2.5-3b"].smoke()
TCFG = get_config("qwen2.5-3b").smoke()
FL_KW = dict(a1=0.9, a2=0.5, alpha_rho=0.1, alpha_gamma=0.6, tau=0.2,
             l2_lambda=1e-5, cost_limit=3.0)
B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several processes at once: two PyTorch threads a
    process keep them from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)

def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _named(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _named(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


@pytest.fixture(scope="module")
def weights():
    """The reference's smoke weights, as jax arrays and as numpy."""
    jp = jtr.init(jax.random.PRNGKey(0), JCFG)
    return jp, _np_tree(jp)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, JCFG.vocab_size, (B, S + 1), dtype=np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def test_token_dataset_and_windows_are_bit_equal():
    jkey = jax.random.fold_in(jax.random.PRNGKey(0), 1)
    tkey = convert.key_from_numpy(np.asarray(jkey), "cpu")
    jt = np.asarray(jsyn.token_dataset(jkey, 512, 3000))
    tt = tsyn.token_dataset(tkey, 512, 3000)
    assert tt.dtype == torch.int32 and np.array_equal(tt.numpy(), jt)
    for seed in (0, 7):
        jw = jsyn.sample_window(jnp.asarray(jt), jax.random.PRNGKey(seed), 3, 33)
        tw = tsyn.sample_window(tt, rnd.PRNGKey(seed, device="cpu"), 3, 33)
        for k in ("tokens", "targets"):
            assert np.array_equal(tw[k].numpy(), np.asarray(jw[k])), k


def test_nested_flatten_order_matches_jax(weights):
    _, npp = weights
    tp = convert.params_from_numpy(npp, "cpu")
    want = [np.asarray(x) for x in jax.tree.leaves(npp)]
    got = [t.numpy() for t in leaves(tp)]
    assert len(got) == len(want)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    flat, unflatten = tcodecs.flatten_tree(tp)
    jflat, _ = jcodecs.flatten_tree(npp)
    assert np.array_equal(flat.numpy(), np.asarray(jflat))
    assert tcodecs.tree_flat_dim(tp) == jcodecs.tree_flat_dim(npp)
    back = unflatten(flat)
    assert all(torch.equal(a, b) for a, b in zip(leaves(back), leaves(tp)))
    state = topt.ssca_init(tp)
    assert np.array_equal(state.w_flat.numpy(), np.asarray(jflat))


def test_nested_ssca_state_round_trip(weights):
    _, npp = weights
    rng = np.random.default_rng(3)
    g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), npp)
    js = jopt.SSCAState(params=npp, g=g, t=np.int32(5))
    ts = convert.ssca_state_from_numpy(js.params, js.g, js.t, device="cpu")
    assert ts.t == 5
    assert np.array_equal(ts.g_flat.numpy(), np.asarray(jcodecs.flatten_tree(g)[0]))
    back = convert.ssca_state_to_numpy(ts)
    for tree, want in ((back["params"], npp), (back["g"], g)):
        got, exp = dict(_named(tree)), dict(_named(want))
        assert got.keys() == exp.keys()
        assert all(np.array_equal(got[k], exp[k]) for k in exp)


def test_loss_and_grad_match_jax(weights):
    jp, npp = weights
    batch = _batch()
    jloss, jgrads = jax.value_and_grad(jtr.loss_fn)(
        jp, jax.tree.map(jnp.asarray, batch), JCFG)
    tp = convert.params_from_numpy(npp, "cpu")
    for t in leaves(tp):
        t.requires_grad_()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = tapi.get_model(TCFG).loss_fn(tp, tb, TCFG)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    got = dict(_named({k: v for k, v in _leaf_grads(tp).items()}))
    want = dict(_named(_np_tree(jgrads)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)


def _leaf_grads(tree):
    return {k: _leaf_grads(v) if isinstance(v, dict) else v.grad.numpy()
            for k, v in tree.items()}


def test_remat_gives_equal_gradients(weights):
    _, npp = weights
    tb = {k: torch.from_numpy(v) for k, v in _batch(1).items()}
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(TCFG, remat=remat)
        tp = convert.params_from_numpy(npp, "cpu")
        for t in leaves(tp):
            t.requires_grad_()
        ttr.loss_fn(tp, tb, cfg).backward()
        grads.append([t.grad for t in leaves(tp)])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_train_step_lands_gradients_in_the_flat_buffer(weights):
    """One step's gradient is the flat concatenation of the stacked-params
    gradient, in w_flat's layout, and reaches ssca_step without a copy."""
    _, npp = weights
    tb = {k: torch.from_numpy(v) for k, v in _batch(2).items()}
    tp = convert.params_from_numpy(npp, "cpu")
    for t in leaves(tp):
        t.requires_grad_()
    ttr.loss_fn(tp, tb, TCFG).backward()
    want = torch.cat([t.grad.reshape(-1) for t in leaves(tp)])

    state = topt.ssca_init(convert.params_from_numpy(npp, "cpu"))
    grad = torch.empty_like(state.w_flat)
    held = ttrain.grad_leaves(state, grad)
    assert isinstance(held["layers"], list) and len(held["layers"]) == TCFG.n_layers
    ptrs = [t.grad.data_ptr() for t in _all(held)]
    grad.zero_()
    ttr.loss_fn(held, tb, TCFG).backward()
    assert [t.grad.data_ptr() for t in _all(held)] == ptrs
    torch.testing.assert_close(grad, want, rtol=0, atol=1e-6)


def _all(tree):
    if isinstance(tree, list):
        for x in tree:
            yield from _all(x)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _all(tree[k])
    else:
        yield tree


def test_trajectory_matches_reference(weights):
    """4 steps of make_scanned_step from the same weights, tokens and round
    inputs (keys bit-equal): the reference's on its loop driver."""
    jp, npp = weights
    steps, batch, seq = 4, 2, 16
    jkey = jax.random.fold_in(jax.random.PRNGKey(0), 1)
    jtoks = jsyn.token_dataset(jkey, JCFG.vocab_size, 2000)
    ttoks = tsyn.token_dataset(convert.key_from_numpy(np.asarray(jkey), "cpu"),
                               TCFG.vocab_size, 2000)
    jfl, tfl = JFLConfig(**FL_KW), FLConfig(**FL_KW)
    jstep = jtrain.make_scanned_step(jget_model(JCFG), JCFG, jfl, jtoks, batch, seq)
    tstep = ttrain.make_scanned_step(tapi.get_model(TCFG), TCFG, tfl, ttoks,
                                     batch, seq)
    rkey = jax.random.PRNGKey(9)
    jin = jrounds.make_inputs(jfl, 1, steps, rkey)
    tin = trounds.make_inputs(tfl, 1, steps, rnd.PRNGKey(9, device="cpu"))
    assert np.array_equal(convert.key_to_numpy(tin.key), np.asarray(jin.key))
    jstate, jms = jrounds.loop_rounds(jstep, jopt.ssca_init(jp), jin)
    tstate, tms = trounds.ENGINES["scan"](tstep, topt.ssca_init(
        convert.params_from_numpy(npp, "cpu")), tin)
    np.testing.assert_allclose(tms["loss"].numpy(), np.asarray(jms["loss"]), rtol=1e-5)
    assert tms["t"].tolist() == [1, 2, 3, 4]
    got = dict(_named(convert.params_to_numpy(tstate.params)))
    want = dict(_named(_np_tree(jstate.params)))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)


def test_engines_name_both_drivers():
    assert set(trounds.ENGINES) == {"scan", "loop"}
    assert trounds.ENGINES["scan"] is trounds.ENGINES["loop"]


def test_train_loop_runs_the_smoke_model_on_the_cpu(capsys):
    state, logs = ttrain.train_loop("qwen2.5-3b", 3, 2, 8, smoke=True,
                                    log_every=2, device="cpu")
    assert [m["step"] for m in logs] == [2, 3]
    assert all(np.isfinite(m["loss"]) for m in logs) and state.t == 4
    assert "loss=" in capsys.readouterr().out


@pytest.mark.parametrize("kw", [dict(codec="int8"), dict(topology="sharded"),
                                dict(dp=tpriv.DPConfig()),
                                dict(constrained=True, codec="int8"),
                                dict(log_jsonl="x.jsonl"),
                                dict(profile_dir="prof"),
                                dict(ckpt_path="ck")])
def test_refused_options_raise(kw, tmp_path):
    """The sharded topology still raises, naming its ROADMAP item; the
    options ported since (codec uploads, dp, JSONL logs, profiles,
    checkpoints) run a step of the smoke model."""
    kw = {k: (str(tmp_path / v) if k in ("log_jsonl", "profile_dir",
                                          "ckpt_path") else v)
          for k, v in kw.items()}
    if "topology" in kw:
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 8"):
            ttrain.train_loop("qwen2.5-3b", 1, 2, 8, smoke=True, device="cpu",
                              **kw)
        return
    state, logs = ttrain.train_loop("qwen2.5-3b", 1, 2, 8, smoke=True,
                                    device="cpu", **kw)
    assert np.isfinite(logs[-1]["loss"]) and trounds.unwrap_comm(state).t == 2
    for k in ("log_jsonl", "ckpt_path"):
        if k in kw:
            assert os.path.exists(kw[k])


@pytest.mark.parametrize("mode", ["feature", "cohort"])
def test_cli_refuses_other_modes(mode, monkeypatch):
    """--mode feature and --mode cohort run, and refuse the sharded
    topology."""
    extra = ["--topology", "sharded", "--device", "cpu"]
    if mode == "cohort":
        extra += ["--clients", "100", "--participation", "4"]
    monkeypatch.setattr("sys.argv", ["train", "--mode", mode, *extra])
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        ttrain.main()


def test_vlm_prefix_is_refused(weights):
    _, npp = weights
    cfg = dataclasses.replace(TCFG, num_prefix_tokens=4)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    batch["prefix_embeddings"] = torch.zeros(B, 4, TCFG.d_model)
    with pytest.raises(NotImplementedError, match="VLM"):
        ttr.loss_fn(convert.params_from_numpy(npp, "cpu"), batch, cfg)


def test_train_loop_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.train_loop("qwen2.5-3b", 1, 2, 8, smoke=True)
