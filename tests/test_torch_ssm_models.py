"""The port's SSM and hybrid families (``repro_torch.models.xlstm`` and
``zamba``) against the JAX reference on the CPU: configs, full-size shapes
and parameter counts, init, prefill and decode logits and caches through
``convert``, ``loss_fn`` and its gradient, ``generate``'s tokens and a
4-step ``make_scanned_step`` trajectory.

Configs: the smoke variants with the cuts that keep every code path: xlstm
with ``block_pattern=("m", "s")`` (the plain smoke keeps ("m", "m"): no
sLSTM) and zamba2 with ``n_layers=5`` (two groups of 2 Mamba2 blocks, the
shared block after each, and a tail block; the plain smoke has no tail).

Tolerances, absolute plus relative: 2e-5 in fp32, the zoo's gate, for
prefill and decode logits and caches, the gradient and the params; the
loss and the trajectory's losses rtol 1e-5; init 1e-5 (torch's erfinv
against XLA's), and bit-equal with the normal draw taken from jax; greedy
tokens exactly. zamba2's smoke model is steep: where a result misses the
fixed gate, it is held within 4 times the reference's own largest move
when the reference's params are perturbed by 1e-7 relative, with each of
the 4 seeds of ``SEEDS`` (``_close_sensitive``; the perturbed runs are made
only then). The move is the model's: a 1e-7 change of any one of zamba2's
weight matrices moves the smoke model's embedding gradient (up to 11) by
2e-4 to 3e-3, through its chain of RMSNorms on a residual stream of rms
~0.02.
"""
import dataclasses
import functools
import types

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
from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.configs.base import FLConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import optimizer as topt
from repro_torch.core import rounds as trounds
from repro_torch.core.tree import leaves, split_views, tree_map, views
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi

ARCHS = ["xlstm-1.3b", "zamba2-1.2b"]
OVERRIDES = {"xlstm-1.3b": dict(block_pattern=("m", "s")),
             "zamba2-1.2b": dict(n_layers=5)}
# parameters at full size (jax.eval_shape of the reference's init)
N_PARAMS = {"xlstm-1.3b": 1_136_138_240, "zamba2-1.2b": 1_110_831_232}
B = 2
TOL = 2e-5
LOSS_RTOL = 1e-5
# the trajectory's FLConfig: the train loop's but τ = 5 (its τ = 0.2 takes
# a first step w <- w - 1.25·ĝ, after which zamba2's smoke model diverges:
# loss 6.3, 27, 311, 1.2e5, params up to 1e6, its attention saturated)
FL_KW = dict(a1=0.9, a2=0.5, alpha_rho=0.1, alpha_gamma=0.6, tau=5.0,
             l2_lambda=1e-5, cost_limit=3.0)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
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


def _close(got, want, tol=TOL, what=""):
    got = convert.tensor_to_numpy(got) if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _close_trees(got, want, tol=TOL, what=""):
    got, want = dict(_named(got)), dict(_named(want))
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], tol, what=f"{what}{k}")


SEEDS = (11, 12, 13, 14)


def _perturbed(tree, seed):
    """The reference's params times 1 + 1e-7·N(0, 1), elementwise."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: jnp.asarray((np.asarray(a) * (
        1 + 1e-7 * rng.standard_normal(a.shape))).astype(np.float32)), tree)


def _close_sensitive(got, want, shifted, what=""):
    """Each leaf of ``got`` within 2e-5 (absolute plus relative) of
    ``want``, or, where it is not, within 4 times the reference's own
    sensitivity: the largest |want - shifted(seed)| over ``SEEDS``,
    ``shifted(seed)`` being the reference's result from
    ``_perturbed(params, seed)`` (run only if a leaf misses the fixed
    gate)."""
    got, want = dict(_named(got)), dict(_named(want))
    assert got.keys() == want.keys()
    runs = None
    for k in want:
        w = np.asarray(want[k], np.float32)
        g = convert.tensor_to_numpy(got[k]) if isinstance(got[k], torch.Tensor) else got[k]
        if np.all(np.abs(g - w) <= TOL * (1 + np.abs(w))):
            continue
        if runs is None:
            runs = [dict(_named(shifted(seed))) for seed in SEEDS]
        move = max(float(np.abs(np.asarray(r[k], np.float32) - w).max()) for r in runs)
        np.testing.assert_allclose(g, w, rtol=TOL, atol=max(TOL, 4 * move),
                                   err_msg=f"{what}{k}")


def _close_losses(got, want, shifted, what=""):
    """Losses at rtol 1e-5, or, where they miss it, at 4 times the largest
    relative move of ``shifted(seed)`` over ``SEEDS``, the reference's
    losses from ``_perturbed`` params."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rtol = LOSS_RTOL
    if np.any(np.abs(got / want - 1) > LOSS_RTOL):
        rtol = max([rtol] + [4 * float(np.abs(np.asarray(shifted(seed)) / want - 1).max())
                             for seed in SEEDS])
    np.testing.assert_allclose(got, want, rtol=rtol, err_msg=what)


def _configs(arch):
    """(reference, port) smoke configs with the arch's OVERRIDES."""
    over = OVERRIDES[arch]
    return (JARCHS[arch].smoke(**over),
            dataclasses.replace(get_config(arch).smoke(), **over))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, reference config, port config, jax model, jax params, port
    params)."""
    jcfg, tcfg = _configs(request.param)
    jm = jget_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0), jcfg)
    return (request.param, jcfg, tcfg, jm, jp,
            convert.params_from_numpy(_np_tree(jp), "cpu"))


def _tokens(cfg, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, s),
                                                dtype=np.int32)


# ---------------------------------------------------------------------------
# configs and init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cut", ["full", "smoke", "overrides"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, cut):
    """The port's fields at full size, at the smoke size and with the
    tests' overrides; the smoke cuts reach the SSM fields."""
    t, j = get_config(arch), JARCHS[arch]
    if cut == "smoke":
        t, j = t.smoke(), j.smoke()
    elif cut == "overrides":
        j, t = _configs(arch)
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    if cut != "full":
        assert t.chunk_size == 32 and t.ssm_state <= 16 and t.ssm_heads <= 4
        assert len(t.block_pattern) <= 2 and t.shared_attn_every in (0, 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_shapes_match_reference(arch, monkeypatch):
    """The port's init at full size on the meta device, the normal draw
    stubbed by an empty tensor of its shape, gives the reference's shapes
    (``jax.eval_shape``), leaf by leaf, and the parameter counts quoted;
    the cache too (batch 8, 544 rows)."""
    monkeypatch.setattr(rnd, "normal", lambda key, shape: torch.empty(
        *key.shape[:-1], *shape, device=key.device))
    cfg = get_config(arch)
    m = tapi.get_model(cfg)
    got = m.init(torch.zeros(2, dtype=torch.int64, device="meta"), cfg, device="meta")
    jm = jget_model(JARCHS[arch])
    want = jax.eval_shape(lambda k: jm.init(k, JARCHS[arch]), jax.random.PRNGKey(0))
    assert [tuple(t.shape) for t in leaves(got)] == \
        [x.shape for x in jax.tree.leaves(want)]
    assert sum(t.numel() for t in leaves(got)) == N_PARAMS[arch]
    cache = m.init_cache(cfg, 8, 544, device="meta")
    want = jax.eval_shape(lambda: jm.init_cache(JARCHS[arch], 8, 544))
    assert [(tuple(t.shape), str(t.dtype)[6:]) for t in leaves(cache)] == \
        [(x.shape, str(x.dtype)) for x in jax.tree.leaves(want)]


def _jax_normal(key, shape):
    k = jnp.asarray(convert.key_to_numpy(key))
    return torch.from_numpy(np.array(jax.random.normal(k, tuple(shape))))


def test_init_matches_reference(model, monkeypatch):
    """From the same key: within 1e-5 of the reference's weights, and
    bit-equal with the normal draw taken from jax."""
    arch, _, tcfg, _, jp, _ = model
    init = tapi.get_model(tcfg).init
    want = _np_tree(jp)
    _close_trees(init(rnd.PRNGKey(0, device="cpu"), tcfg, device="cpu"), want,
                 tol=1e-5)
    monkeypatch.setattr(rnd, "normal", _jax_normal)
    _close_trees(init(rnd.PRNGKey(0, device="cpu"), tcfg, device="cpu"), want, tol=0)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_prefill_and_decode_match_reference(model):
    """Prefill of 40 tokens (chunk 32: the padded path) into a 43-row cache,
    then 3 decode steps from the reference's prefill cache carried across
    by ``convert`` (its K/V padded as ``grow_cache`` pads them): logits and
    every cache entry, ``pos`` included, at ``_close_sensitive`` (zamba2's
    smoke model moves its second application's K/V by 1e-4 when its params
    move by 1e-7 relative; xlstm's stays inside 2e-5)."""
    _, jcfg, tcfg, jm, jp, tp = model
    m = tapi.get_model(tcfg)
    s = 40
    toks = _tokens(tcfg, s + 3, 5)
    prefill = jax.jit(jm.prefill, static_argnums=2)
    step = jax.jit(jm.decode_step, static_argnums=4)

    def reference(params):
        out = {}
        out["prefill_logits"], jc = prefill(params, {"tokens": jnp.asarray(toks[:, :s])},
                                            jcfg)
        out["prefill"] = jc
        jc = jserve.grow_cache(jc, 3)
        for i in range(3):
            out[f"decode_{i}"], jc = step(params, jc, jnp.asarray(toks[:, s + i:s + i + 1]),
                                          jnp.int32(s + i), jcfg)
        out["decode"] = jc
        return _np_tree(out)

    want = reference(jp)
    cache = m.init_cache(tcfg, B, s + 3, device="cpu")
    tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks[:, :s])}, tcfg, cache=cache)
    assert tc is cache
    got = {"prefill_logits": tl, "prefill": convert.cache_to_numpy(tc, length=s)}
    tc = convert.cache_from_numpy(want["prefill"], max_seq=s + 3, device="cpu")
    for i in range(3):
        got[f"decode_{i}"], tc = m.decode_step(
            tp, tc, torch.from_numpy(toks[:, s + i:s + i + 1]), s + i, tcfg)
    got["decode"] = convert.cache_to_numpy(tc)
    _close_sensitive(got, want, lambda seed: reference(_perturbed(jp, seed)))
    assert int(tc["pos"]) == s + 3


def test_generate_matches_reference(model, monkeypatch):
    """``generate``'s greedy tokens from seed 0 equal the reference's (both
    packages' ``get_config`` patched to give the config with the
    overrides)."""
    arch, jcfg, tcfg = model[:3]
    monkeypatch.setattr(jserve, "get_config",
                        lambda name: types.SimpleNamespace(smoke=lambda: jcfg))
    monkeypatch.setattr(tserve, "get_config",
                        lambda name: types.SimpleNamespace(smoke=lambda: tcfg))
    kw = dict(smoke=True, batch=B, prompt_len=13, gen=6)
    want, _ = jserve.generate(arch, **kw)
    got, stats = tserve.generate(arch, device="cpu", **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32 and stats["tokens_per_s"] > 0


def test_convert_pads_only_the_kv_caches():
    """``cache_from_numpy`` pads ``attn_k``/``attn_v`` along the sequence
    axis and passes the states, conv tails and ``pos`` through;
    ``cache_to_numpy`` cuts the K/V back and keeps the rest whole."""
    jcfg, _ = _configs("zamba2-1.2b")
    jc = _np_tree(jget_model(jcfg).init_cache(jcfg, B, 7))
    jc = jax.tree.map(lambda a: np.random.default_rng(a.size).standard_normal(
        a.shape).astype(a.dtype), jc)
    tc = convert.cache_from_numpy(jc, max_seq=10, device="cpu")
    assert tc["attn_k"].shape[2] == 10 and tc["attn_v"].shape[2] == 10
    assert not tc["attn_k"][:, :, 7:].any()
    assert tc["mamba"]["state"].shape == jc["mamba"]["state"].shape
    assert tc["pos"].dtype == torch.int32 and tc["pos"].shape == ()
    _close_trees(convert.cache_to_numpy(tc, length=7), jc, tol=0)
    with pytest.raises(ValueError, match="max_seq"):
        convert.cache_from_numpy(jc, max_seq=3, device="cpu")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def tree_grads(tree):
    return {k: tree_grads(v) if isinstance(v, dict) else v.grad.numpy()
            for k, v in tree.items()}


def test_loss_and_grad_match_reference(model):
    """``loss_fn`` and its gradient against ``jax.value_and_grad`` of the
    reference's, and the same through ``train.grad_leaves`` (the blocks cut
    into per-block leaves whose gradients land in one flat buffer) with
    remat on. The loss at rtol 1e-5, the gradient at ``_close_sensitive``
    (zamba2's smoke gradient reaches 11 on the embedding and moves by
    4e-3 when the params move by 1e-7 relative)."""
    _, jcfg, tcfg, jm, jp, _ = model
    toks = _tokens(tcfg, 17, 6)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    vg = jax.jit(jax.value_and_grad(jm.loss_fn), static_argnums=2)
    jloss, jgrads = vg(jp, jax.tree.map(jnp.asarray, batch), jcfg)
    jgrads = _np_tree(jgrads)

    @functools.cache
    def shifted(seed):
        return _np_tree(vg(_perturbed(jp, seed),
                           jax.tree.map(jnp.asarray, batch), jcfg)[1])

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tp = convert.params_from_numpy(_np_tree(jp), "cpu")
    for t in leaves(tp):
        t.requires_grad_()
    loss = tapi.get_model(tcfg).loss_fn(tp, tb, tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    _close_sensitive(tree_grads(tp), jgrads, shifted, what="grad ")
    state = topt.ssca_init(convert.params_from_numpy(_np_tree(jp), "cpu"))
    grad = torch.zeros_like(state.w_flat)
    held = ttrain.grad_leaves(state, grad, tapi.get_model(tcfg).stacked)
    key = "m_blocks" if "m_blocks" in held else "mamba"
    assert isinstance(held[key], list)
    loss = tapi.get_model(tcfg).loss_fn(held, tb, dataclasses.replace(tcfg, remat=True))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    _close_sensitive(views(grad, state.params), jgrads, shifted, what="flat grad ")


def test_trajectory_matches_reference(model):
    """4 steps of make_scanned_step from the same weights, tokens and round
    inputs (``FL_KW``): the free-running losses, and each step's loss and
    params, the step taken from the reference's state before it. Losses at
    rtol 1e-5 and params at 2e-5, or at ``_close_sensitive``'s bound where
    they miss it (zamba2's embedding after step 4 reads 7.0e-5 off, where
    the reference's own step 4 moves it by 0.6e-5 to 7.6e-5 from params
    perturbed by 1e-7, over 8 seeds)."""
    arch, jcfg, tcfg, jm, jp, _ = model
    steps, batch, seq = 4, 2, 16
    jkey = jax.random.fold_in(jax.random.PRNGKey(0), 1)
    jtoks = jsyn.token_dataset(jkey, jcfg.vocab_size, 2000)
    ttoks = tsyn.token_dataset(convert.key_from_numpy(np.asarray(jkey), "cpu"),
                               tcfg.vocab_size, 2000)
    jfl, tfl = JFLConfig(**FL_KW), FLConfig(**FL_KW)
    jstep = jtrain.make_scanned_step(jm, jcfg, jfl, jtoks, batch, seq)
    tstep = ttrain.make_scanned_step(tapi.get_model(tcfg), tcfg, tfl, ttoks, batch, seq)
    jin = jrounds.make_inputs(jfl, 1, steps, jax.random.PRNGKey(9))
    tin = trounds.make_inputs(tfl, 1, steps, rnd.PRNGKey(9, device="cpu"))
    jstep = jax.jit(jstep)

    def free_running(params):
        """The reference's losses over the steps (``rounds.loop_rounds``'
        loop, one jitted step)."""
        state, losses = jopt.ssca_init(params), []
        for r in range(steps):
            state, ms = jstep(state, jax.tree.map(lambda x: x[r], jin))
            losses.append(float(ms["loss"]))
        return np.asarray(losses)

    _, tms = trounds.ENGINES["scan"](tstep, topt.ssca_init(
        convert.params_from_numpy(_np_tree(jp), "cpu")), tin)
    _close_losses(tms["loss"].numpy(), free_running(jp),
                  lambda seed: free_running(_perturbed(jp, seed)),
                  what="free-running losses")
    jstate = jopt.ssca_init(jp)
    for r in range(steps):
        jinp = jax.tree.map(lambda x: x[r], jin)
        tstate = convert.ssca_state_from_numpy(_np_tree(jstate.params),
                                               _np_tree(jstate.g), jstate.t, "cpu")
        tstate, tm = tstep(tstate, tin.round(r))

        @functools.cache
        def shifted(seed, before=jstate, jinp=jinp):
            state, ms = jstep(before._replace(params=_perturbed(before.params, seed)),
                              jinp)
            return _np_tree(state.params), float(ms["loss"])

        jstate, jm_ = jstep(jstate, jinp)
        _close_losses([float(tm["loss"])], [float(jm_["loss"])],
                      lambda seed: [shifted(seed)[1]], what=f"step {r + 1}'s loss")
        _close_sensitive(convert.params_to_numpy(tstate.params),
                         _np_tree(jstate.params), lambda seed: shifted(seed)[0],
                         what=f"after step {r + 1}: ")


def test_bf16_state_keeps_fp32_leaves_and_steps_as_the_reference():
    """zamba2 in bf16 keeps its Mamba2 decay and dt bias in fp32 (the
    reference's dtypes, from ``jax.eval_shape`` of its bf16 init):
    ``ssca_init`` puts them in an fp32 side buffer and ``ssca_step``
    updates them there. Two steps from the same bf16 params and a random
    gradient (each leaf in its param's dtype) give the reference's
    ``ssca_step`` params and surrogate buffers: at 2e-5 for the fp32
    leaves, within one bf16 rounding (2^-8) for the bf16 leaves and their
    surrogate buffers (which take the rounded params in the second step).
    Through the train step (``grad_leaves`` with a (main, side) gradient
    pair) each leaf's gradient lands in its own buffer, equal to autograd's
    on the plain params. A flat gradient is refused. The constrained state
    keeps the same side buffer, with an fp32 constraint surrogate of its
    own, and the upload (codec=, dp=) takes the (main, side) pair with the
    runs that lay the reference's flat vector over it
    (tests/test_torch_mixed_dtype.py holds both against the reference)."""
    _, tcfg = _configs("zamba2-1.2b")
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    tm = tapi.get_model(tcfg)
    rng = np.random.default_rng(7)

    def jax_tree(fill):
        return tree_map(lambda t: jnp.asarray(fill(t), jnp.bfloat16 if t.dtype
                                              == torch.bfloat16 else jnp.float32),
                        tm.init(rnd.PRNGKey(0, device="cpu"), tcfg, device="cpu"))

    jp = jax_tree(convert.tensor_to_numpy)
    jgrad = jax_tree(lambda t: rng.standard_normal(t.shape))
    toks = _tokens(tcfg, 17, 6)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    jfl, tfl = JFLConfig(**FL_KW), FLConfig(**FL_KW)
    jstep = jax.jit(lambda st, g: jopt.ssca_step(st, g, jfl))
    jstate = jopt.ssca_init(jp)
    state = topt.ssca_init(convert.params_from_numpy(_np_tree(jp), "cpu"))
    fp32 = {k for k, t in _named(state.params) if t.dtype == torch.float32}
    assert fp32 == {"mamba/a_log", "mamba/dt_bias"}
    jcfg = dataclasses.replace(_configs("zamba2-1.2b")[0], dtype="bfloat16")
    want = jax.eval_shape(lambda k: jget_model(jcfg).init(k, jcfg), jax.random.PRNGKey(0))
    assert {k: str(x.dtype) for k, x in _named(want)} == \
        {k: str(t.dtype)[6:] for k, t in _named(state.params)}
    assert state.w_flat.dtype == torch.bfloat16
    assert state.w_side.numel() == 2 * tcfg.n_layers * tcfg.ssm_heads
    tgrad = convert.params_from_numpy(_np_tree(jgrad), "cpu")
    with pytest.raises(ValueError, match="side buffer"):
        topt.ssca_step(state, torch.zeros_like(state.w_flat), tfl)
    for _ in range(2):
        jstate = jstep(jstate, jgrad)
        state = topt.ssca_step(state, tgrad, tfl)
    dtypes = {k: t.dtype for k, t in _named(state.params)}
    for tree, want in ((state.params, jstate.params), (state.g, jstate.g)):
        got, want = dict(_named(tree)), _np_tree(dict(_named(want)))
        for k in want:
            assert str(got[k].dtype)[6:] == str(want[k].dtype), k
            tol = TOL if dtypes[k] == torch.float32 else 2.0 ** -8
            np.testing.assert_allclose(got[k].float().numpy(),
                                       want[k].astype(np.float32), rtol=tol,
                                       atol=tol, err_msg=k)

    state = topt.ssca_init(convert.params_from_numpy(_np_tree(jp), "cpu"))
    grad = (torch.zeros_like(state.w_flat), torch.zeros_like(state.w_side))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tm.loss_fn(ttrain.grad_leaves(state, grad, tm.stacked), tb, tcfg).backward()
    plain = convert.params_from_numpy(_np_tree(jp), "cpu")
    for t in leaves(plain):
        t.requires_grad_()
    tm.loss_fn(plain, tb, tcfg).backward()
    got = dict(_named(split_views(*grad, state.params, torch.bfloat16)))
    for k, t in _named(plain):
        assert got[k].dtype == t.dtype, k
        assert torch.equal(got[k], t.grad), k
    cstate = topt.ssca_constrained_init(convert.params_from_numpy(_np_tree(jp), "cpu"))
    assert {k: t.dtype for k, t in _named(cstate.params)} == dtypes
    assert cstate.w_side.numel() == cstate.g_side.numel() == state.w_side.numel()
    assert cstate.g_side.dtype == torch.float32
    assert torch.equal(cstate.w_side, state.w_side.new_tensor(
        np.concatenate([np.asarray(x).ravel() for k, x in _named(_np_tree(jp))
                        if k in fp32])))
    with pytest.raises(ValueError, match="runs="):
        ttrain.comm_update_(grad, torch.zeros(state.w_flat.numel()),
                            rnd.PRNGKey(0, device="cpu"))


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def test_get_model_serves_both_families_and_refuses_the_encoder_decoder():
    from repro_torch.models import xlstm, zamba
    for arch, mod in (("xlstm-1.3b", xlstm), ("zamba2-1.2b", zamba)):
        m = tapi.get_model(get_config(arch))
        assert (m.init, m.loss_fn, m.prefill, m.decode_step, m.init_cache) == (
            mod.init, mod.loss_fn, mod.prefill, mod.decode_step, mod.init_cache)
        assert m.has_decode
    from repro_torch.models import encdec, transformer
    m = tapi.get_model(get_config("seamless-m4t-medium"))
    assert (m.init, m.loss_fn, m.prefill, m.decode_step, m.init_cache) == (
        encdec.init, encdec.loss_fn, encdec.prefill, encdec.decode_step,
        encdec.init_cache)
    with pytest.raises(NotImplementedError, match="models/encdec.py"):
        transformer.loss_fn({}, {}, get_config("seamless-m4t-medium"))
