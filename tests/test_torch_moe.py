"""The port's MoE layer and MoE decoder against the JAX reference on the
CPU, at the smoke size of qwen3-moe-30b-a3b (2 layers, d_model 256, 4
heads over 4 KV heads, head_dim 64, 4 experts, 2 a token, moe_d_ff 128,
fp32) and arctic-480b (the same with a dense residual MLP, d_ff 512),
weights carried across by ``convert``, inputs drawn with numpy from a seed.

The routing (top experts, their renormalized probabilities, each
assignment's slot and whether it is kept) is compared with the
reference's own lines (``repro.models.layers.moe``: ``jax.lax.top_k``, the
cumsum over the one-hot) run in jnp: experts, slots and keeps equal, the
probabilities at 1e-6. Tolerances: the layer's output 2e-5 and its aux
1e-6; init 1e-5 (torch.erfinv against XLA's, a few ulps); prefill and
decode logits 2e-5 (the flash tolerance); ``loss_fn`` rtol 1e-5 and its
gradient atol 1e-5; a 4-step ``make_scanned_step`` trajectory: losses rtol
1e-5, params atol 1e-5; greedy tokens exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFLConfig
from repro.configs.registry import ARCHS as JARCHS
from repro.core import optimizer as jopt
from repro.core import rounds as jrounds
from repro.data import synthetic as jsyn
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.models import get_model as jget_model
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.configs.base import FLConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import optimizer as topt
from repro_torch.core import rounds as trounds
from repro_torch.core.tree import leaves
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttr

ARCHS = ["qwen3-moe-30b-a3b", "arctic-480b"]
FL_KW = dict(a1=0.9, a2=0.5, alpha_rho=0.1, alpha_gamma=0.6, tau=0.2,
             l2_lambda=1e-5, cost_limit=3.0)
B = 2
TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several processes at once: two PyTorch threads a
    process keep them from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch, **change):
    return (dataclasses.replace(JARCHS[arch].smoke(), **change),
            dataclasses.replace(get_config(arch).smoke(), **change))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _named(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _named(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _close(got, want, tol=TOL, what=""):
    got = convert.tensor_to_numpy(got) if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    """(arch, the reference's smoke weights as jax arrays, as numpy)."""
    jcfg, _ = _cfgs(request.param)
    jp = jtr.init(jax.random.PRNGKey(0), jcfg)
    return request.param, jp, _np_tree(jp)


def _ref_route(router, xt, cfg):
    """The reference's routing, ``repro.models.layers.moe``'s own lines in
    jnp: (top_p, top_e, slot, keep, cap)."""
    e, k = cfg.n_experts, cfg.experts_per_token
    t = xt.shape[0]
    probs = jax.nn.softmax((xt @ router).astype(jnp.float32), axis=-1)
    top_p, top_e = jax.lax.top_k(probs, k)
    top_p = top_p / jnp.sum(top_p, axis=-1, keepdims=True)
    cap = max(1, int(cfg.capacity_factor * t * k / e))
    flat_e = top_e.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    slot = jnp.sum(jnp.cumsum(onehot, axis=0) * onehot, axis=-1) - 1
    keep = slot < cap
    slot = jnp.where(keep, slot, cap - 1)
    return top_p, top_e, slot, keep, cap


def _assert_routing_equal(router, xt, jcfg, tcfg):
    want = _ref_route(jnp.asarray(router), jnp.asarray(xt), jcfg)
    _, top_p, top_e, slot, keep, cap = tlayers.moe_route(
        torch.from_numpy(router), torch.from_numpy(xt), tcfg)
    assert cap == want[4]
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want[3]))
    _close(top_p, want[0], 1e-6, "top_p")
    return keep.numpy()


def _layer_moe(npp):
    return jax.tree.map(lambda a: a[0], npp["layers"]["moe"])


def _moe_case(npp, jcfg, tcfg, x):
    jm = _layer_moe(npp)
    keep = _assert_routing_equal(jm["router"], x.reshape(-1, x.shape[-1]),
                                 jcfg, tcfg)
    want, want_aux = jlayers.moe(jax.tree.map(jnp.asarray, jm), jnp.asarray(x),
                                 jcfg)
    got, aux = tlayers.moe(convert.params_from_numpy(jm, "cpu"),
                           torch.from_numpy(x), tcfg)
    assert tuple(got.shape) == want.shape and aux.dtype == torch.float32
    _close(got, want, what="out")
    _close(aux, want_aux, 1e-6, "aux")
    return keep


@pytest.mark.parametrize("s", [1, 24])
def test_moe_matches_reference(weights, s):
    """Layer 0's MoE over (B, s, D) inputs: a prefill-sized call and a
    decode-sized one (T = 2, cap 1: drops from the capacity alone)."""
    arch, _, npp = weights
    jcfg, tcfg = _cfgs(arch)
    x = np.random.default_rng(s).standard_normal((B, s, jcfg.d_model),
                                                 dtype=np.float32)
    _moe_case(npp, jcfg, tcfg, x)
    if s == 1:
        assert tlayers.moe_capacity(tcfg, B) == 1


def test_moe_forced_drops_match_reference(weights):
    """capacity_factor 0.3: a third of the assignments or more dropped."""
    arch, _, npp = weights
    jcfg, tcfg = _cfgs(arch, capacity_factor=0.3)
    x = np.random.default_rng(5).standard_normal((B, 24, jcfg.d_model),
                                                 dtype=np.float32)
    keep = _moe_case(npp, jcfg, tcfg, x)
    assert (~keep).mean() > 0.3


def _with_router(jm, router):
    """A one-layer stack of layer moe params jm with another router."""
    return {"layers": {"moe": jax.tree.map(lambda a: a[None],
                                           {**jm, "router": router})}}


def test_moe_planted_ties_take_the_lower_expert(weights):
    """Router columns 0 and 2 equal, and column 3 equal to column 1: every
    token's top two are a tied pair, the lower expert first (as
    jax.lax.top_k orders them); an all-zero router ties
    all four, so every token takes experts 0 and 1 and most are dropped."""
    arch, _, npp = weights
    jcfg, tcfg = _cfgs(arch)
    jm = _layer_moe(npp)
    router = np.array(jm["router"])
    router[:, 2] = router[:, 0]
    router[:, 3] = router[:, 1]
    x = np.random.default_rng(6).standard_normal((B, 24, jcfg.d_model),
                                                 dtype=np.float32)
    _moe_case(_with_router(jm, router), jcfg, tcfg, x)
    _, _, top_e, _, _, _ = tlayers.moe_route(torch.from_numpy(router),
                                             torch.from_numpy(x[0]), tcfg)
    assert set(map(tuple, top_e.tolist())) <= {(0, 2), (1, 3)}
    keep = _moe_case(_with_router(jm, np.zeros_like(router)), jcfg, tcfg, x)
    _, _, top_e, _, _, _ = tlayers.moe_route(
        torch.zeros(tuple(router.shape)), torch.from_numpy(x[0]), tcfg)
    assert (top_e == torch.tensor([0, 1])).all()
    assert keep.sum() == 2 * tlayers.moe_capacity(tcfg, B * 24)


@pytest.mark.parametrize("t,e,k", [(300, 128, 8), (4096, 16, 2), (5, 8, 2)])
def test_moe_slots_match_reference_at_scale(t, e, k):
    """The stable sort's slots against the reference's cumsum over the
    (T·k, E) one-hot at full width's 128 experts and top-8, with bf16-like
    coarse logits (many ties among 128 experts)."""
    jcfg = dataclasses.replace(JARCHS["qwen3-moe-30b-a3b"], n_experts=e,
                               experts_per_token=k)
    tcfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"), n_experts=e,
                               experts_per_token=k)
    rng = np.random.default_rng(t)
    xt = np.round(rng.standard_normal((t, 16)) * 4).astype(np.float32)
    router = np.round(rng.standard_normal((16, e))).astype(np.float32)
    keep = _assert_routing_equal(router, xt, jcfg, tcfg)
    assert (~keep).any()


def test_moe_init_matches_reference(weights):
    """The router, expert and (arctic) dense residual draws: split(key, 4)
    and fold_in(key, 7), as the reference's."""
    arch, _, npp = weights
    _, tcfg = _cfgs(arch)
    tp = ttr.init(rnd.PRNGKey(0, device="cpu"), tcfg, device="cpu")
    got, want = dict(_named(tp)), dict(_named(npp))
    assert sorted(got) == sorted(want)
    assert ("layers/moe/dense/wg" in want) == (arch == "arctic-480b")
    for name in want:
        assert tuple(got[name].shape) == want[name].shape, name
        _close(got[name], want[name], 1e-5, name)


def _batch(vocab, seed=0, s=16):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, s + 1),
                                                dtype=np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _leaf_grads(tree):
    return {k: _leaf_grads(v) if isinstance(v, dict) else v.grad.numpy()
            for k, v in tree.items()}


def test_loss_and_grad_match_jax(weights):
    """The loss with its aux (0.01 · Σ aux / L) and the gradient of every
    leaf, router and experts included."""
    arch, jp, npp = weights
    jcfg, tcfg = _cfgs(arch)
    batch = _batch(jcfg.vocab_size)
    jloss, jgrads = jax.value_and_grad(jtr.loss_fn)(
        jp, jax.tree.map(jnp.asarray, batch), jcfg)
    tp = convert.params_from_numpy(npp, "cpu")
    for t in leaves(tp):
        t.requires_grad_()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = tapi.get_model(tcfg).loss_fn(tp, tb, tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    got, want = dict(_named(_leaf_grads(tp))), dict(_named(_np_tree(jgrads)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    # the aux is in the loss: the router's gradient has it even where the
    # cross-entropy's would vanish
    x = ttr.embed(tp, tb["tokens"], tcfg)
    rope_cs = tlayers.rope_tables(torch.arange(16)[None], tcfg.resolved_head_dim,
                                  tcfg.rope_theta)
    _, aux = ttr.backbone(tp, x, rope_cs, tcfg)
    assert aux.item() > 0


def test_remat_gives_equal_gradients(weights):
    arch, _, npp = weights
    _, tcfg = _cfgs(arch)
    tb = {k: torch.from_numpy(v) for k, v in _batch(tcfg.vocab_size, 1).items()}
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        tp = convert.params_from_numpy(npp, "cpu")
        for t in leaves(tp):
            t.requires_grad_()
        ttr.loss_fn(tp, tb, cfg).backward()
        grads.append([t.grad for t in leaves(tp)])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_prefill_and_decode_match_reference(weights):
    """Prefill of 24 tokens, then three decode steps (T = 2 a step: cap 1)
    from the reference's prefill cache."""
    arch, jp, npp = weights
    jcfg, tcfg = _cfgs(arch)
    tp = convert.params_from_numpy(npp, "cpu")
    s = 24
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (B, s + 3),
                                             dtype=np.int32)
    jl, jc = jtr.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])}, jcfg)
    tl, tc = ttr.prefill(tp, {"tokens": torch.from_numpy(toks[:, :s])}, tcfg,
                         cache=ttr.init_cache(tcfg, B, s + 3, device="cpu"))
    _close(tl, jl, what="prefill logits")
    jc = jserve.grow_cache(jc, 3)
    for i in range(3):
        tok = toks[:, s + i:s + i + 1]
        jl, jc = jtr.decode_step(jp, jc, jnp.asarray(tok), jnp.int32(s + i), jcfg)
        tl, tc = ttr.decode_step(tp, tc, torch.from_numpy(tok), s + i, tcfg)
        _close(tl, jl, what=f"logits at step {i}")
    for k in ("k", "v"):
        _close(tc[k], jc[k], what=k)


def test_generate_matches_reference():
    """Greedy generation of qwen3-moe's smoke variant through the port's
    entry point gives the reference ``generate``'s tokens."""
    gen, plen = 8, 16
    seqs, _ = tserve.generate("qwen3-moe-30b-a3b", smoke=True, batch=B,
                              prompt_len=plen, gen=gen, seed=0, device="cpu")
    jseqs, _ = jserve.generate("qwen3-moe-30b-a3b", smoke=True, batch=B,
                               prompt_len=plen, gen=gen, seed=0)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(jseqs))


def test_trajectory_matches_reference(weights):
    """4 steps of make_scanned_step from the same weights, tokens and round
    inputs: the loss metric carries the aux, and the 3-D expert leaves
    take their gradient through the flat buffer."""
    arch, jp, npp = weights
    jcfg, tcfg = _cfgs(arch)
    steps, batch, seq = 4, 2, 16
    jkey = jax.random.fold_in(jax.random.PRNGKey(0), 1)
    jtoks = jsyn.token_dataset(jkey, jcfg.vocab_size, 2000)
    ttoks = tsyn.token_dataset(convert.key_from_numpy(np.asarray(jkey), "cpu"),
                               tcfg.vocab_size, 2000)
    jfl, tfl = JFLConfig(**FL_KW), FLConfig(**FL_KW)
    jstep = jtrain.make_scanned_step(jget_model(jcfg), jcfg, jfl, jtoks, batch, seq)
    tstep = ttrain.make_scanned_step(tapi.get_model(tcfg), tcfg, tfl, ttoks,
                                     batch, seq)
    jin = jrounds.make_inputs(jfl, 1, steps, jax.random.PRNGKey(9))
    tin = trounds.make_inputs(tfl, 1, steps, rnd.PRNGKey(9, device="cpu"))
    jstate, jms = jrounds.loop_rounds(jstep, jopt.ssca_init(jp), jin)
    state0 = topt.ssca_init(convert.params_from_numpy(npp, "cpu"))
    held = ttrain.grad_leaves(state0, torch.empty_like(state0.w_flat))
    assert held["layers"][0]["moe"]["wi"].shape == (4, 256, 128)
    tstate, tms = trounds.ENGINES["scan"](tstep, state0, tin)
    np.testing.assert_allclose(tms["loss"].numpy(), np.asarray(jms["loss"]), rtol=1e-5)
    got = dict(_named(convert.params_to_numpy(tstate.params)))
    want = dict(_named(_np_tree(jstate.params)))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)


def test_train_loop_runs_the_moe_smoke_model_on_the_cpu(capsys):
    state, logs = ttrain.train_loop("qwen3-moe-30b-a3b", 4, 2, 16, smoke=True,
                                    log_every=2, device="cpu")
    assert [m["step"] for m in logs] == [2, 4] and state.t == 5
    assert all(np.isfinite(m["loss"]) for m in logs)


def test_moe_shardings_compute_the_same_layer(weights):
    """"expert2d" differs from "fsdp" only in the reference's sharding
    specs: the same layer, bit for bit."""
    arch, _, npp = weights
    _, tcfg = _cfgs(arch)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (B, 8, tcfg.d_model), dtype=np.float32))
    p = convert.params_from_numpy(_layer_moe(npp), "cpu")
    want = tlayers.moe(p, x, tcfg)
    got = tlayers.moe(p, x, dataclasses.replace(tcfg, moe_sharding="expert2d"))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_expert_parallel_is_refused(weights):
    """The expert-parallel MoE needs the mesh's model axis (ROADMAP item
    13): init, the layer and the loss refuse it; nothing falls back."""
    arch, _, npp = weights
    _, tcfg = _cfgs(arch, moe_sharding="expert_parallel")
    with pytest.raises(NotImplementedError, match="item 13"):
        ttr.init(rnd.PRNGKey(0, device="cpu"), tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        tlayers.moe(convert.params_from_numpy(_layer_moe(npp), "cpu"),
                    torch.zeros(B, 4, tcfg.d_model), tcfg)
    tb = {k: torch.from_numpy(v) for k, v in _batch(tcfg.vocab_size).items()}
    with pytest.raises(NotImplementedError, match="item 13"):
        ttr.loss_fn(convert.params_from_numpy(npp, "cpu"), tb, tcfg)


def test_chip_smoke_routing_gate_passes_only_near_ties():
    """chip_smoke.py's card-against-CPU routing gate, on planted routings
    on the CPU: a flip across a 4e-6 top-k margin passes, is counted and
    takes its row out of the logits gate; one across 0.2 fails."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_gate", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.rehearse_routing_gate(torch) == 1
