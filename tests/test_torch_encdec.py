"""The port's encoder-decoder (``repro_torch.models.encdec``,
seamless-m4t-medium) against the JAX reference ``repro.models.encdec`` on
the CPU, at the smoke size in fp32 (2 encoder and 2 decoder layers, d_model
256, 4 heads over 4, vocab 512), the reference's weights carried across by
``convert``: configs, full-size shapes and the parameter count, init,
``encode``, ``loss_fn`` and its gradient, ``prefill``'s logits and cache,
4 decode steps at explicit positions, ``generate``'s tokens, 3
``make_train_step`` steps and 2 ``make_constrained_train_step`` steps, and
the train loops' refusal (the reference's loop feeds token windows only).

Tolerances: init 1e-5 (torch's erfinv against XLA's, a few ulps), and
bit-equal with the normal draw taken from jax; encode, prefill and decode
logits and caches, the gradient 2e-5 (the zoo's gate: the flash kernel's
plain version sums the online softmax in another order than the
reference's ``dot_attention``); the losses rtol 1e-5; the train trajectory
atol 1e-5 (ROADMAP's cross-engine standard); decode after prefill 1e-4 of
the longer prefill (the reference's own check reads 5e-2); greedy tokens
exactly.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFLConfig
from repro.configs.registry import ARCHS as JARCHS
from repro.core import optimizer as jopt
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.models import encdec as jenc
from repro.models import get_model as jget_model
from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.configs.base import FLConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import optimizer as topt
from repro_torch.core.tree import leaves, views
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from repro_torch.models import encdec as tenc
from test_torch_constrained import _accurate_reference_dots
from test_torch_ssm_models import SEEDS, _perturbed

ARCH = "seamless-m4t-medium"
# parameters at full size: embedding 262,354,944, an encoder layer
# 12,584,960, a decoder layer 16,780,288, two final norms
N_PARAMS = 614_739_968
B = 2
S = 24                 # decoder tokens; the encoder takes 4·S frames
STEPS = 4              # decode steps
TOL = 2e-5
LOSS_RTOL = 1e-5
CONSISTENCY = 1e-4
TRAIN_KW = dict(a1=0.9, a2=0.5, alpha_rho=0.1, alpha_gamma=0.6, tau=0.2,
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


def _torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _batch(cfg, s, seed):
    """frame_embeddings (B, 4·s, D) fp32, tokens (B, s + 1) int32, from a
    numpy seed."""
    rng = np.random.default_rng(seed)
    return {"frame_embeddings": rng.standard_normal((B, 4 * s, cfg.d_model)
                                                    ).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (B, s + 1), dtype=np.int32)}


@pytest.fixture(scope="module")
def ref():
    """The smoke configs, the reference's params (jax and numpy), the port's
    params carried across, and the reference's jitted results every test
    below compares with, computed once."""
    jcfg, tcfg = JARCHS[ARCH].smoke(), get_config(ARCH).smoke()
    jp = jenc.init(jax.random.PRNGKey(0), jcfg)
    npp = _np_tree(jp)
    data = _batch(tcfg, S + STEPS, 5)
    frames, toks = data["frame_embeddings"][:, :4 * S], data["tokens"]
    prefill = jax.jit(jenc.prefill, static_argnums=2)
    step = jax.jit(jenc.decode_step, static_argnums=4)
    out = {"encode": jax.jit(jenc.encode, static_argnums=2)(
        jp, jnp.asarray(frames), jcfg)}
    logits, jc = prefill(jp, {"frame_embeddings": jnp.asarray(frames),
                              "tokens": jnp.asarray(toks[:, :S])}, jcfg)
    out["prefill_logits"], out["prefill"] = logits, jc
    jc = jserve.grow_cache(jc, STEPS)
    for i in range(STEPS):
        out[f"decode_{i}"], jc = step(jp, jc, jnp.asarray(toks[:, S + i:S + i + 1]),
                                      jnp.int32(S + i), jcfg)
    out["decode"] = jc
    return types.SimpleNamespace(jcfg=jcfg, tcfg=tcfg, jp=jp, npp=npp,
                                 tp=convert.params_from_numpy(npp, "cpu"),
                                 frames=frames, toks=toks, want=_np_tree(out))


# ---------------------------------------------------------------------------
# configs and init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_reference(smoke):
    t, j = get_config(ARCH), JARCHS[ARCH]
    if smoke:
        t, j = t.smoke(), j.smoke()
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.is_encdec and j.is_encdec
    assert t.encoder_layers == (2 if smoke else 12) and t.resolved_head_dim == 64


def test_full_size_shapes_match_reference(monkeypatch):
    """The port's init at full size on the meta device, the normal draw
    stubbed by an empty tensor of its shape, gives the reference's shapes
    (``jax.eval_shape``) leaf by leaf and 614,739,968 parameters; the cache
    at batch 8, 544 decoder rows and 2,048 encoder rows too."""
    monkeypatch.setattr(rnd, "normal", lambda key, shape: torch.empty(
        *key.shape[:-1], *shape, device=key.device))
    cfg, jcfg = get_config(ARCH), JARCHS[ARCH]
    m = tapi.get_model(cfg)
    got = m.init(torch.zeros(2, dtype=torch.int64, device="meta"), cfg, device="meta")
    want = jax.eval_shape(lambda k: jenc.init(k, jcfg), jax.random.PRNGKey(0))
    assert [tuple(t.shape) for t in leaves(got)] == \
        [x.shape for x in jax.tree.leaves(want)]
    assert sum(t.numel() for t in leaves(got)) == N_PARAMS
    cache = m.init_cache(cfg, 8, 544, device="meta", enc_len=2048)
    want = jax.eval_shape(lambda: jenc.init_cache(jcfg, 8, 544, enc_len=2048))
    assert [(tuple(t.shape), str(t.dtype)[6:]) for t in leaves(cache)] == \
        [(x.shape, str(x.dtype)) for x in jax.tree.leaves(want)]
    # the reference's cap on the self-attention rows
    long = m.init_cache(cfg, 1, 5000, device="meta", enc_len=8)
    assert long["self_k"].shape[2] == 4096 and long["cross_k"].shape[2] == 8


def _jax_normal(key, shape):
    k = jnp.asarray(convert.key_to_numpy(key))
    return torch.from_numpy(np.array(jax.random.normal(k, tuple(shape))))


def test_init_matches_reference(ref, monkeypatch):
    """From the same key: within 1e-5 of the reference's weights (the
    stacked encoder and decoder layers each drawn from its own key), and
    bit-equal with the normal draw taken from jax."""
    init = tapi.get_model(ref.tcfg).init
    _close_trees(init(rnd.PRNGKey(0, device="cpu"), ref.tcfg, device="cpu"),
                 ref.npp, tol=1e-5)
    monkeypatch.setattr(rnd, "normal", _jax_normal)
    _close_trees(init(rnd.PRNGKey(0, device="cpu"), ref.tcfg, device="cpu"),
                 ref.npp, tol=0)


def test_get_model_gives_the_encoder_decoder():
    m = tapi.get_model(get_config(ARCH))
    assert (m.init, m.loss_fn, m.prefill, m.decode_step, m.init_cache) == (
        tenc.init, tenc.loss_fn, tenc.prefill, tenc.decode_step, tenc.init_cache)
    assert m.has_decode and m.stacked == {"encoder": 1, "decoder": 1}


# ---------------------------------------------------------------------------
# forward and serving
# ---------------------------------------------------------------------------


def test_encode_matches_reference(ref):
    """The bidirectional encoder (RoPE at positions 0..Se-1, non-causal
    flash, GELU, ``ln_enc``) over 96 frames."""
    got = tenc.encode(ref.tp, torch.from_numpy(ref.frames), ref.tcfg)
    _close(got, ref.want["encode"], what="encode")


def test_prefill_matches_reference(ref):
    """Prefill of S tokens after 4·S frames into a cache with room for
    STEPS more rows: the last logits, the self K/V rows [0, S), every
    layer's cross K/V (the reference computes them twice, the port once)
    and ``pos``."""
    m = tapi.get_model(ref.tcfg)
    cache = m.init_cache(ref.tcfg, B, S + STEPS, device="cpu", enc_len=4 * S)
    logits, tc = m.prefill(ref.tp, {"frame_embeddings": torch.from_numpy(ref.frames),
                                    "tokens": torch.from_numpy(ref.toks[:, :S])},
                           ref.tcfg, cache=cache)
    assert tc is cache and int(tc["pos"]) == S
    _close(logits, ref.want["prefill_logits"], what="prefill logits")
    _close_trees(convert.cache_to_numpy(tc, length=S), ref.want["prefill"],
                 what="prefill cache ")
    assert not tc["self_k"][:, :, S:].any()
    # made without a cache: S self rows, 4·S cross rows
    _, made = m.prefill(ref.tp, {"frame_embeddings": torch.from_numpy(ref.frames),
                                 "tokens": torch.from_numpy(ref.toks[:, :S])}, ref.tcfg)
    assert made["self_k"].shape[2] == S and made["cross_k"].shape[2] == 4 * S
    with pytest.raises(ValueError, match="enc_len"):
        m.prefill(ref.tp, {"frame_embeddings": torch.from_numpy(ref.frames),
                           "tokens": torch.from_numpy(ref.toks[:, :S])}, ref.tcfg,
                  cache=m.init_cache(ref.tcfg, B, S + STEPS, device="cpu"))


def test_decode_steps_match_reference(ref):
    """4 decode steps at the explicit positions S..S+3 from the reference's
    prefill cache carried across by ``convert`` (self K/V padded as
    ``grow_cache`` pads them, cross K/V whole): each step's logits and the
    final cache."""
    m = tapi.get_model(ref.tcfg)
    tc = convert.cache_from_numpy(ref.want["prefill"], max_seq=S + STEPS, device="cpu")
    assert tc["self_k"].shape[2] == S + STEPS and tc["cross_k"].shape[2] == 4 * S
    for i in range(STEPS):
        logits, tc = m.decode_step(ref.tp, tc, torch.from_numpy(
            ref.toks[:, S + i:S + i + 1]), S + i, ref.tcfg)
        _close(logits, ref.want[f"decode_{i}"], what=f"decode {i}")
    _close_trees(convert.cache_to_numpy(tc), ref.want["decode"], what="decode cache ")
    assert int(tc["pos"]) == S + STEPS


@pytest.mark.parametrize("s", [24, 32])
def test_prefill_then_decode_consistency(ref, s):
    """The reference's ``test_prefill_then_decode_consistency`` on the port
    (32 tokens, 128 frames) and at S = 24: decode at position s after a
    prefill of s tokens gives the last logits of a prefill of s + 1 tokens
    within 1e-4 (the reference's test reads 5e-2)."""
    m = tapi.get_model(ref.tcfg)
    data = _batch(ref.tcfg, s, 11)
    frames, toks = torch.from_numpy(data["frame_embeddings"]), torch.from_numpy(data["tokens"])
    _, cache = m.prefill(ref.tp, {"frame_embeddings": frames, "tokens": toks[:, :s]},
                         ref.tcfg, cache=m.init_cache(ref.tcfg, B, s + 4, device="cpu",
                                                      enc_len=4 * s))
    got, _ = m.decode_step(ref.tp, cache, toks[:, s:s + 1], s, ref.tcfg)
    full, _ = m.prefill(ref.tp, {"frame_embeddings": frames, "tokens": toks}, ref.tcfg)
    np.testing.assert_allclose(got[:, -1].numpy(), full[:, -1].numpy(),
                               rtol=CONSISTENCY, atol=CONSISTENCY)


def test_generate_matches_reference(ref):
    """``generate``'s greedy tokens from seed 0 (prompt 13, so 52 drawn
    frames; 6 tokens) equal the reference's."""
    kw = dict(smoke=True, batch=B, prompt_len=13, gen=6)
    want, _ = jserve.generate(ARCH, **kw)
    got, stats = tserve.generate(ARCH, device="cpu", **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32 and stats["tokens_per_s"] > 0


def test_convert_pads_only_the_self_kv(ref):
    """``cache_from_numpy`` pads ``self_k``/``self_v`` along the sequence
    axis and passes the cross K/V and ``pos`` through; ``cache_to_numpy``
    cuts the self K/V back."""
    tc = convert.cache_from_numpy(ref.want["prefill"], max_seq=S + 6, device="cpu")
    assert tc["self_v"].shape[2] == S + 6 and not tc["self_v"][:, :, S:].any()
    assert tc["cross_v"].shape == ref.want["prefill"]["cross_v"].shape
    assert tc["pos"].dtype == torch.int32 and tc["pos"].shape == ()
    _close_trees(convert.cache_to_numpy(tc, length=S), ref.want["prefill"], tol=0)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def tree_grads(tree):
    return {k: tree_grads(v) if isinstance(v, dict) else v.grad.numpy()
            for k, v in tree.items()}


def _loss_batch(cfg, seed):
    data = _batch(cfg, 16, seed)
    return {"frame_embeddings": data["frame_embeddings"],
            "tokens": data["tokens"][:, :-1], "targets": data["tokens"][:, 1:]}


def test_loss_and_grad_match_reference(ref):
    """``loss_fn`` and its gradient against ``jax.value_and_grad`` of the
    reference's, leaf by leaf; then the same through ``train.grad_leaves``
    (the encoder and decoder cut into per-layer leaves whose gradients land
    in one flat buffer) with remat on, where the gradient of every decoder
    layer's cross K/V reaches the encoder through checkpointed layers."""
    batch = _loss_batch(ref.tcfg, 6)
    jloss, jgrads = jax.jit(jax.value_and_grad(jenc.loss_fn), static_argnums=2)(
        ref.jp, _jax(batch), ref.jcfg)
    jgrads = _np_tree(jgrads)
    m = tapi.get_model(ref.tcfg)
    tp = convert.params_from_numpy(ref.npp, "cpu")
    for t in leaves(tp):
        t.requires_grad_()
    loss = m.loss_fn(tp, _torch(batch), ref.tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    _close_trees(tree_grads(tp), jgrads, what="grad ")
    assert float(np.abs(jgrads["encoder"]["attn"]["wq"]).max()) > 0

    state = topt.ssca_init(convert.params_from_numpy(ref.npp, "cpu"))
    grad = torch.zeros_like(state.w_flat)
    held = ttrain.grad_leaves(state, grad, m.stacked)
    assert isinstance(held["encoder"], list) and isinstance(held["decoder"], list)
    loss = m.loss_fn(held, _torch(batch), dataclasses.replace(ref.tcfg, remat=True))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    _close_trees(views(grad, state.params), jgrads, what="flat grad ")


def test_train_step_trajectory_matches_reference(ref):
    """3 steps of ``make_train_step`` on encoder-decoder batches
    (frame_embeddings, tokens, targets; a new batch a step) from the same
    weights under the train loop's FLConfig, free-running: each step's
    loss at rtol 1e-5 and the params after each step at atol 1e-5."""
    jfl, tfl = JFLConfig(**TRAIN_KW), FLConfig(**TRAIN_KW)
    jstep = jax.jit(jtrain.make_train_step(jget_model(ref.jcfg), ref.jcfg, jfl))
    tstep = ttrain.make_train_step(tapi.get_model(ref.tcfg), ref.tcfg, tfl)
    jstate = jopt.ssca_init(ref.jp)
    tstate = topt.ssca_init(convert.params_from_numpy(ref.npp, "cpu"))
    for r in range(3):
        batch = _loss_batch(ref.tcfg, 20 + r)
        jstate, jm = jstep(jstate, _jax(batch))
        tstate, tm = tstep(tstate, _torch(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL, err_msg=f"step {r + 1}'s loss")
        got = convert.params_to_numpy(tstate.params)
        for k, w in _named(_np_tree(jstate.params)):
            np.testing.assert_allclose(dict(_named(got))[k], w, rtol=0, atol=1e-5,
                                       err_msg=f"after step {r + 1}: {k}")
    assert tstate.t == 4


def test_constrained_train_step_matches_reference(ref, monkeypatch):
    """2 steps of ``make_constrained_train_step`` (formulation (40), U =
    3.0) on encoder-decoder batches, free-running (the reference's sums as
    ``jnp.sum``, see ``test_torch_constrained._accurate_reference_dots``):
    the loss and ‖ω‖² at rtol 1e-5, the params at atol 1e-5, ν at rtol
    1e-5 at step 1. Past step 1 Lemma 1's ν = (√(b/disc) − 1)/τ takes the
    surrogate minimum's rounding relative to its size: the reference's own
    step-2 ν moves by 6e-6 to 2.8e-5 relative when its params move by 1e-7
    relative (4 seeds), so there ν is held at rtol 1e-5 or, where it misses
    that, at 4 times that move."""
    _accurate_reference_dots(monkeypatch)
    jfl, tfl = JFLConfig(**TRAIN_KW), FLConfig(**TRAIN_KW)
    jstep = jax.jit(jtrain.make_constrained_train_step(jget_model(ref.jcfg),
                                                       ref.jcfg, jfl))
    tstep = ttrain.make_constrained_train_step(tapi.get_model(ref.tcfg), ref.tcfg, tfl)
    batches = [_loss_batch(ref.tcfg, 30 + r) for r in range(2)]

    def reference(params):
        state, out = jopt.ssca_constrained_init(params), []
        for batch in batches:
            state, ms = jstep(state, _jax(batch))
            out.append(({k: float(v) for k, v in ms.items()}, state.params))
        return out

    want = reference(ref.jp)
    tstate = topt.ssca_constrained_init(convert.params_from_numpy(ref.npp, "cpu"))
    for r, batch in enumerate(batches):
        tstate, tm = tstep(tstate, _torch(batch))
        jm, jparams = want[r]
        for k in ("loss", "l2") + (("nu",) if r == 0 else ()):
            np.testing.assert_allclose(float(tm[k]), jm[k], rtol=LOSS_RTOL,
                                       err_msg=f"step {r + 1}'s {k}")
        _close_trees(convert.params_to_numpy(tstate.params), _np_tree(jparams),
                     tol=1e-5, what=f"after step {r + 1}: ")
        rel = abs(float(tm["nu"]) / jm["nu"] - 1)
        if r and rel > LOSS_RTOL:
            move = max(abs(reference(_perturbed(ref.jp, seed))[r][0]["nu"] / jm["nu"] - 1)
                       for seed in SEEDS)
            assert rel <= 4 * move, (f"step {r + 1}'s ν {float(tm['nu'])} against "
                                     f"{jm['nu']}: {rel} > 4 × {move}")


def test_train_loops_refuse_the_encoder_decoder():
    """Both train loops feed token windows only: the reference's fails in
    its loss (no ``frame_embeddings``), the port's refuses the arch before
    it draws anything, naming the entry that trains it."""
    with pytest.raises(KeyError, match="frame_embeddings"):
        jtrain.train_loop(ARCH, 1, B, 16, smoke=True, log_every=1)
    with pytest.raises(ValueError, match="make_train_step"):
        ttrain.train_loop(ARCH, 1, B, 16, smoke=True, device="cpu")
