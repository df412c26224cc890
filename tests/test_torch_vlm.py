"""The port's head-dim-256 and prefix-LM slice against the JAX reference on
the CPU: the plain flash versions with ``prefix_len``, GeGLU and GELU, the
VLM prefix through the decoder (init, prefill, decode, ``loss_fn`` and its
gradient, a 4-step ``make_scanned_step`` trajectory, ``generate``), and the
``mnist-mlp`` zoo entry. Inputs come from numpy seeds; weights are carried
across by ``convert``.

Configs: gemma-7b's and paligemma-3b's smoke variants (the reference's cuts:
2 layers, d_model 256, head dim 64, paligemma 8 prefix tokens) and HD256,
a paligemma-3b cut that keeps head dim 256 (2 layers, d_model 512, 2 query
heads over 1 KV head, GeGLU d_ff 1024, vocab 512, 8 prefix tokens, fp32).

Tolerances: the plain flash forward and its backward against the
reference's ``dot_attention`` and ``chunked_attention`` (``jax.vjp``) 2e-5
in fp32, the flash tolerance (the softmax sums in another order); init,
prefill and decode logits and caches, the loss (rtol), its gradient and a
4-step trajectory's losses (rtol) and params 1e-5; the mnist-mlp loss 1e-6;
greedy tokens exactly.
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
from repro.models import mlp as jmlp
from repro.models import transformer as jtr
from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.configs.base import FLConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import optimizer as topt
from repro_torch.core import rounds as trounds
from repro_torch.core.tree import leaves
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttr

B = 2
TOL = 1e-5
FLASH_TOL = 2e-5
HD256 = dict(name="paligemma-hd256", n_layers=2, d_model=512, n_heads=2,
             n_kv_heads=1, head_dim=256, d_ff=1024, vocab_size=512,
             num_prefix_tokens=8, dtype="float32", remat=False)
CONFIGS = ["gemma-7b", "paligemma-3b", "hd256"]
FL_KW = dict(a1=0.9, a2=0.5, alpha_rho=0.1, alpha_gamma=0.6, tau=0.2,
             l2_lambda=1e-5, cost_limit=3.0)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _configs(name):
    """(reference config, port config) of one of CONFIGS."""
    if name == "hd256":
        return (dataclasses.replace(JARCHS["paligemma-3b"], **HD256),
                dataclasses.replace(get_config("paligemma-3b"), **HD256))
    return JARCHS[name].smoke(), get_config(name).smoke()


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


@pytest.fixture(scope="module", params=CONFIGS)
def model(request):
    """(name, reference config, port config, jax params, port params)."""
    jcfg, tcfg = _configs(request.param)
    jp = jtr.init(jax.random.PRNGKey(0), jcfg)
    return request.param, jcfg, tcfg, jp, convert.params_from_numpy(_np_tree(jp), "cpu")


def _batch(cfg, s, seed, prefix):
    """Tokens and targets (B, s) and, with ``prefix``, the config's prefix
    embeddings (B, Pfx, d_model), as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, s + 1), dtype=np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if prefix:
        batch["prefix_embeddings"] = rng.standard_normal(
            (B, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)
    return batch


# ---------------------------------------------------------------------------
# the plain flash versions with the prefix-LM block
# ---------------------------------------------------------------------------

PREFIX_CASES = [  # h, kv, sq, sk, d, prefix, window
    (4, 2, 24, 24, 64, 8, 0),        # paligemma's rule at the smoke size
    (2, 1, 40, 40, 256, 13, 0),      # head dim 256, a ragged prefix
    (4, 4, 30, 30, 32, 6, 10),       # the prefix inside the window for the first rows
    (4, 2, 50, 50, 64, 12, 5),       # ... and past it for the later ones
    (4, 2, 9, 37, 64, 32, 0),        # right-aligned rows, the prefix past the first
    (2, 2, 16, 16, 64, 16, 0),       # every key in the prefix: bidirectional
]


def _positions(sq, sk):
    return (jnp.arange(sk - sq, sk, dtype=jnp.int32)[None, :],
            jnp.arange(sk, dtype=jnp.int32)[None, :])


def _flash_inputs(h, kv, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, sq, h, d), (B, sk, kv, d), (B, sk, kv, d), (B, sq, h, d))]


def _t(a):
    """(B, S, H, D) numpy -> the port's (B, H, S, D) tensor."""
    return torch.from_numpy(a).transpose(1, 2)


@pytest.mark.parametrize("h,kv,sq,sk,d,prefix,window", PREFIX_CASES)
def test_flash_prefix_plain_matches_reference_mask(h, kv, sq, sk, d, prefix, window):
    """``flash_attention_fwd_ref`` and the split-and-merge version with
    ``prefix_len`` against ``make_attention_mask(prefix_len=)`` +
    ``dot_attention`` and against ``chunked_attention(prefix_len=)``; the
    mask itself against the reference's, element by element."""
    q, k, v, _ = _flash_inputs(h, kv, sq, sk, d, sq + sk + prefix)
    qp, kp = _positions(sq, sk)
    jmask = jlayers.make_attention_mask(qp, kp, causal=True, window=window,
                                        prefix_len=prefix)
    got_mask = tref._visible(sq, sk, True, window, "cpu", prefix)
    assert np.array_equal(got_mask.numpy(), np.asarray(jmask[0]))
    rep = h // kv
    dot = jlayers.dot_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask,
                                kv_heads_repeat=rep)
    kb, vb = (jnp.repeat(jnp.asarray(a), rep, axis=2) for a in (k, v))
    chunked = jlayers.chunked_attention(jnp.asarray(q), kb, vb, qp, kp, causal=True,
                                        window=window, prefix_len=prefix, block=16)
    got = tref.flash_attention_fwd_ref(_t(q), _t(k), _t(v), window=window,
                                       prefix_len=prefix).transpose(1, 2)
    split = tref.flash_attention_split_ref(_t(q), _t(k), _t(v), window=window,
                                           prefix_len=prefix, splits=3).transpose(1, 2)
    for want in (dot, chunked):
        _close(got, want, FLASH_TOL)
        _close(split, want, FLASH_TOL)
    without = tref.flash_attention_fwd_ref(_t(q), _t(k), _t(v), window=window)
    assert not torch.allclose(without.transpose(1, 2), got, atol=1e-3)


@pytest.mark.parametrize("h,kv,sq,sk,d,prefix,window", PREFIX_CASES)
def test_flash_prefix_backward_matches_vjp(h, kv, sq, sk, d, prefix, window):
    """``flash_attention_bwd_ref`` with ``prefix_len`` (from the forward's
    output and logsumexp) against ``jax.vjp`` of ``chunked_attention`` with
    K and V broadcast over each group inside the function (so dK and dV sum
    over the group)."""
    q, k, v, do = _flash_inputs(h, kv, sq, sk, d, 3 * sq + sk + prefix)
    qp, kp = _positions(sq, sk)
    rep = h // kv

    def f(q_, k_, v_):
        return jlayers.chunked_attention(q_, jnp.repeat(k_, rep, axis=2),
                                         jnp.repeat(v_, rep, axis=2), qp, kp,
                                         causal=True, window=window,
                                         prefix_len=prefix, block=16)

    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    o, lse = tref.flash_attention_fwd_ref(_t(q), _t(k), _t(v), window=window,
                                          prefix_len=prefix, return_lse=True)
    _close(o.transpose(1, 2), out, FLASH_TOL, "out")
    grads = tref.flash_attention_bwd_ref(_t(q), _t(k), _t(v), o, lse, _t(do),
                                         window=window, prefix_len=prefix)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        _close(g.transpose(1, 2), w, FLASH_TOL, name)


def test_flash_wrapper_takes_the_prefix_on_the_cpu():
    """The wrapper and its autograd Function hand ``prefix_len`` to the
    plain versions on CPU tensors."""
    q, k, v, do = (torch.from_numpy(a).transpose(1, 2).requires_grad_()
                   for a in _flash_inputs(2, 1, 20, 20, 256, 1))
    from repro_torch.kernels import flash_attention as tflash
    out = tflash.FlashAttention.apply(q, k, v, True, 0, 7)
    torch.testing.assert_close(out, tref.flash_attention_ref(q, k, v, prefix_len=7))
    out.backward(do.detach())
    o, lse = tref.flash_attention_fwd_ref(q, k, v, prefix_len=7, return_lse=True)
    want = tref.flash_attention_bwd_ref(q, k, v, o, lse, do.detach(), prefix_len=7)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        torch.testing.assert_close(got, w)
    assert tflash.decode_splits(torch.bfloat16, 8, 8, 1, 1, 799, d=256,
                                prefix_len=256) == 0
    assert tflash.decode_splits(torch.bfloat16, 8, 8, 1, 1, 799, d=256) == 9


# ---------------------------------------------------------------------------
# GeGLU and GELU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("activation", ["geglu", "gelu"])
def test_mlp_keys_values_and_output_match_reference(activation):
    """``mlp_init``'s keys and draws (GELU: wi from ks[0], wo from ks[2])
    and ``mlp``'s output (the tanh GELU) against the reference's."""
    jkey = jax.random.PRNGKey(3)
    jp = jlayers.mlp_init(jkey, 64, 96, activation, jnp.float32)
    tp = tlayers.mlp_init(convert.key_from_numpy(np.asarray(jkey), "cpu"), 64, 96,
                          activation, torch.float32)
    assert list(tp) == list(jp) == (["wi", "wo"] if activation == "gelu"
                                    else ["wi", "wg", "wo"])
    for name in jp:
        _close(tp[name], jp[name], what=name)
    x = np.random.default_rng(4).standard_normal((3, 5, 64)).astype(np.float32)
    want = jlayers.mlp(jax.tree.map(jnp.asarray, _np_tree(jp)), jnp.asarray(x), activation)
    got = tlayers.mlp(convert.params_from_numpy(_np_tree(jp), "cpu"),
                      torch.from_numpy(x), activation)
    _close(got, want, what="mlp")


@pytest.mark.parametrize("activation", ["gelu", "geglu"])
def test_convert_and_grad_leaves_carry_the_mlp_leaves(activation):
    """convert round-trips the GELU (wi, wo) and GeGLU (wi, wg, wo) leaves,
    and ``train.grad_leaves`` lands their gradients in the flat buffer."""
    cfg = dataclasses.replace(JARCHS["gemma-7b"].smoke(), activation=activation)
    tcfg = dataclasses.replace(get_config("gemma-7b").smoke(), activation=activation)
    jp = _np_tree(jtr.init(jax.random.PRNGKey(2), cfg))
    tp = convert.params_from_numpy(jp, "cpu")
    back = dict(_named(convert.params_to_numpy(tp)))
    assert back.keys() == dict(_named(jp)).keys()
    assert sorted(tp["layers"]["mlp"]) == sorted(jp["layers"]["mlp"])
    tb = {k: torch.from_numpy(v) for k, v in _batch(tcfg, 12, 1, False).items()}
    for t in leaves(tp):
        t.requires_grad_()
    ttr.loss_fn(tp, tb, tcfg).backward()
    want = torch.cat([t.grad.reshape(-1) for t in leaves(tp)])
    state = topt.ssca_init(convert.params_from_numpy(jp, "cpu"))
    grad = torch.zeros_like(state.w_flat)
    ttr.loss_fn(ttrain.grad_leaves(state, grad), tb, tcfg).backward()
    torch.testing.assert_close(grad, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the decoders: gemma-7b, paligemma-3b (smoke) and the head-dim-256 cut
# ---------------------------------------------------------------------------


def test_init_matches_reference(model):
    _, _, tcfg, jp, _ = model
    tp = ttr.init(rnd.PRNGKey(0, device="cpu"), tcfg, device="cpu")
    got, want = dict(_named(tp)), dict(_named(_np_tree(jp)))
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], what=k)
    assert tp["layers"]["attn"]["wq"].shape[-1] == tcfg.n_heads * tcfg.resolved_head_dim


def test_prefill_and_decode_match_reference(model):
    """Prefill of 12 tokens (after the prefix, for a VLM) and 3 decode
    steps from the reference's prefill cache at rows Pfx + 12 + i: logits
    and caches."""
    _, jcfg, tcfg, jp, tp = model
    s = 12
    vlm = tcfg.family == "vlm"
    batch = _batch(tcfg, s + 3, 5, vlm)
    pre = {"tokens": batch["tokens"][:, :s]}
    if vlm:
        pre["prefix_embeddings"] = batch["prefix_embeddings"]
    pfx = tcfg.num_prefix_tokens if vlm else 0
    jl, jc = jtr.prefill(jp, jax.tree.map(jnp.asarray, pre), jcfg)
    tl, tc = ttr.prefill(tp, {k: torch.from_numpy(v) for k, v in pre.items()}, tcfg)
    _close(tl, jl, what="prefill logits")
    assert tc["k"].shape[2] == pfx + s
    for k in ("k", "v"):
        _close(tc[k], jc[k], what=k)
    tc = convert.cache_from_numpy(_np_tree(jc), max_seq=pfx + s + 3, device="cpu")
    jc = jserve.grow_cache(jc, 3)
    for i in range(3):
        tok = batch["tokens"][:, s + i:s + i + 1]
        pos = pfx + s + i
        jl, jc = jtr.decode_step(jp, jc, jnp.asarray(tok), jnp.int32(pos), jcfg)
        tl, tc = ttr.decode_step(tp, tc, torch.from_numpy(tok), pos, tcfg)
        _close(tl, jl, what=f"decode logits at {pos}")


def _loss_cases():
    return [(n, p) for n in CONFIGS for p in (False, True)
            if p is False or n != "gemma-7b"]


@pytest.mark.parametrize("name,prefix", _loss_cases())
def test_loss_and_grad_match_reference(name, prefix):
    """``loss_fn`` and its gradient against ``jax.value_and_grad`` of the
    reference's, with and without the VLM prefix (its positions take no
    loss; every position sees it)."""
    jcfg, tcfg = _configs(name)
    jp = jtr.init(jax.random.PRNGKey(1), jcfg)
    batch = _batch(tcfg, 16, 6, prefix)
    jloss, jgrads = jax.value_and_grad(jtr.loss_fn)(jp, jax.tree.map(jnp.asarray, batch),
                                                     jcfg)
    tp = convert.params_from_numpy(_np_tree(jp), "cpu")
    for t in leaves(tp):
        t.requires_grad_()
    loss = tapi.get_model(tcfg).loss_fn(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    got = dict(_named(tree_grads(tp)))
    want = dict(_named(_np_tree(jgrads)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL, err_msg=k)


def tree_grads(tree):
    return {k: tree_grads(v) if isinstance(v, dict) else v.grad.numpy()
            for k, v in tree.items()}


def test_trajectory_matches_reference(model):
    """4 steps of make_scanned_step from the same weights, tokens and round
    inputs, as the reference's train loop feeds them (token windows, no
    prefix): the free-running losses at rtol 1e-5, and each step's loss
    (rtol 1e-5) and params, the step taken from the reference's state before
    it (its params and SSCA buffer carried across). Free-running params are
    no fair gate here: under the train loop's FLConfig the loss climbs
    (HD256: 6.6, 8.0, 15.5 over steps 1-3), and params perturbed by 1e-7
    relative at the start move the port's own params by 8e-4 after 4 steps
    at HD256 (8e-6 on paligemma-3b's smoke variant). The params gate is atol
    1e-5, or 4 times the reference's own sensitivity where that is larger:
    how far the reference's step moves the params when its state is
    perturbed by 1e-7 relative (2e-5 at HD256's step 4)."""
    _, jcfg, tcfg, jp, _ = model
    steps, batch, seq = 4, 2, 16
    jkey = jax.random.fold_in(jax.random.PRNGKey(0), 1)
    jtoks = jsyn.token_dataset(jkey, jcfg.vocab_size, 2000)
    ttoks = tsyn.token_dataset(convert.key_from_numpy(np.asarray(jkey), "cpu"),
                               tcfg.vocab_size, 2000)
    jfl, tfl = JFLConfig(**FL_KW), FLConfig(**FL_KW)
    jstep = jtrain.make_scanned_step(jget_model(jcfg), jcfg, jfl, jtoks, batch, seq)
    tstep = ttrain.make_scanned_step(tapi.get_model(tcfg), tcfg, tfl, ttoks, batch, seq)
    jin = jrounds.make_inputs(jfl, 1, steps, jax.random.PRNGKey(9))
    tin = trounds.make_inputs(tfl, 1, steps, rnd.PRNGKey(9, device="cpu"))
    jstate, jms = jrounds.loop_rounds(jstep, jopt.ssca_init(jp), jin)
    _, tms = trounds.ENGINES["scan"](tstep, topt.ssca_init(
        convert.params_from_numpy(_np_tree(jp), "cpu")), tin)
    np.testing.assert_allclose(tms["loss"].numpy(), np.asarray(jms["loss"]), rtol=TOL)
    jstate = jopt.ssca_init(jp)
    rng = np.random.default_rng(11)
    for r in range(steps):
        jinp = jax.tree.map(lambda x: x[r], jin)
        tstate = convert.ssca_state_from_numpy(_np_tree(jstate.params),
                                               _np_tree(jstate.g), jstate.t, "cpu")
        tstate, tm = tstep(tstate, tin.round(r))
        perturbed = jstate._replace(params=jax.tree.map(
            lambda a: (np.asarray(a) * (1 + 1e-7 * rng.standard_normal(a.shape)))
            .astype(np.float32), jstate.params))
        shifted = dict(_named(_np_tree(jstep(perturbed, jinp)[0].params)))
        jstate, jm = jstep(jstate, jinp)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=TOL)
        got = dict(_named(convert.params_to_numpy(tstate.params)))
        want = dict(_named(_np_tree(jstate.params)))
        for k in want:
            tol = max(TOL, 4 * float(np.abs(shifted[k] - want[k]).max()))
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                       err_msg=f"{k} after step {r + 1}")


# ---------------------------------------------------------------------------
# generate: the VLM's decode position (a reference caveat)
# ---------------------------------------------------------------------------


def test_vlm_decode_position_reference_caveat():
    """After a prefill of Pfx = 8 prefix embeddings and S = 12 tokens, the
    reference's ``generate`` decodes at pos = S (its cache has no "pos"):
    that step overwrites a prompt row and misses the full forward over S + 1
    tokens by far. At Pfx + S, the row after the prefill's last, the decode
    equals the full forward, in the reference and in the port, and the
    port's decode equals the reference's there."""
    jcfg, tcfg = _configs("paligemma-3b")
    jp = jtr.init(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_numpy(_np_tree(jp), "cpu")
    s, pfx = 12, tcfg.num_prefix_tokens
    batch = _batch(tcfg, s + 1, 8, True)
    toks, pref = batch["tokens"], batch["prefix_embeddings"]
    jfull, _ = jtr.prefill(jp, {"tokens": jnp.asarray(toks),
                                "prefix_embeddings": jnp.asarray(pref)}, jcfg)
    _, jc = jtr.prefill(jp, {"tokens": jnp.asarray(toks[:, :s]),
                             "prefix_embeddings": jnp.asarray(pref)}, jcfg)
    jc = jserve.grow_cache(jc, 1)
    last = jnp.asarray(toks[:, s:])
    wrong, _ = jtr.decode_step(jp, jc, last, jnp.int32(s), jcfg)
    right, _ = jtr.decode_step(jp, jc, last, jnp.int32(pfx + s), jcfg)
    assert float(jnp.abs(wrong - jfull).max()) > 0.1
    _close(right, jfull, what="reference decode at Pfx + S")

    tpre = torch.from_numpy(pref)
    tfull, _ = ttr.prefill(tp, {"tokens": torch.from_numpy(toks),
                                "prefix_embeddings": tpre}, tcfg)
    cache = ttr.init_cache(tcfg, B, pfx + s + 1, device="cpu")
    _, cache = ttr.prefill(tp, {"tokens": torch.from_numpy(toks[:, :s]),
                                "prefix_embeddings": tpre}, tcfg, cache=cache)
    tdec, _ = ttr.decode_step(tp, cache, torch.from_numpy(toks[:, s:]), pfx + s, tcfg)
    _close(tdec, tfull.detach(), what="port decode vs its full forward")
    _close(tdec, right, what="port decode vs the reference's at Pfx + S")


def test_vlm_generate_draws_the_reference_prefix_and_decodes_after_it():
    """``generate("paligemma-3b", smoke=True)``: its first token is the
    reference's (the same seeded weights, prompt and prefix draw), and every
    decoded token is the greedy token of a full forward over the prefix and
    everything before it."""
    seqs, _ = tserve.generate("paligemma-3b", smoke=True, batch=B, prompt_len=12,
                              gen=4, device="cpu")
    jseqs, _ = jserve.generate("paligemma-3b", smoke=True, batch=B, prompt_len=12,
                               gen=4)
    assert np.array_equal(seqs[:, 0].numpy(), np.asarray(jseqs)[:, 0])
    cfg = get_config("paligemma-3b").smoke()
    key = rnd.PRNGKey(0, device="cpu")
    params = ttr.init(key, cfg, device="cpu")
    prompt = rnd.randint(rnd.fold_in(key, 1), (B, 12), 0, cfg.vocab_size)
    pref = rnd.normal(rnd.fold_in(key, 2), (B, cfg.num_prefix_tokens, cfg.d_model))
    for i in range(1, 4):
        toks = torch.cat([prompt, seqs[:, :i]], 1)
        logits, _ = ttr.prefill(params, {"tokens": toks, "prefix_embeddings": pref}, cfg)
        assert torch.equal(torch.argmax(logits[:, -1], -1).to(torch.int32), seqs[:, i])


# ---------------------------------------------------------------------------
# mnist-mlp, the paper's own model as a zoo entry
# ---------------------------------------------------------------------------


def test_mnist_mlp_zoo_matches_reference():
    """``zoo_init`` (the widths from the config's fields) and
    ``zoo_loss_fn`` (a features batch) against the reference's."""
    jcfg, tcfg = JARCHS["mnist-mlp"], get_config("mnist-mlp")
    jkey = jax.random.PRNGKey(4)
    jp = jmlp.zoo_init(jkey, jcfg)
    model = tapi.get_model(tcfg)
    assert not model.has_decode and model.prefill is None
    tp = model.init(convert.key_from_numpy(np.asarray(jkey), "cpu"), tcfg, device="cpu")
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape
        _close(tp[k], jp[k], what=k)
    rng = np.random.default_rng(2)
    z = rng.standard_normal((16, 784)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 16)]
    want = jmlp.zoo_loss_fn(jp, {"features": jnp.asarray(z), "labels_onehot": jnp.asarray(y)},
                            jcfg)
    got = model.loss_fn(tp, {"features": torch.from_numpy(z),
                             "labels_onehot": torch.from_numpy(y)}, tcfg)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_mnist_mlp_refuses_serving_and_the_token_train_loop():
    with pytest.raises(ValueError, match="no decode path"):
        tserve.generate("mnist-mlp", batch=1, prompt_len=4, gen=2, device="cpu")
    with pytest.raises(ValueError, match="features batch"):
        ttrain.train_loop("mnist-mlp", 1, 2, 8, device="cpu")
