"""The port's dense decoder and its serving entry point against the JAX
reference, on qwen2.5-3b's smoke variant (2 layers, d_model 256, 4 query
heads over 2 KV heads, head_dim 64, vocab 512, fp32), with weights carried
across by ``convert``.

Tolerances: init 1e-5 (the port draws normals through torch.erfinv, a few
ulps from XLA's); prefill logits and caches, and decode steps after it,
2e-5: the flash tolerance, since the online softmax sums in another order
than the reference's ``dot_attention``; greedy tokens exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.launch import serve as jserve
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttr

JCFG = JARCHS["qwen2.5-3b"].smoke()
TCFG = get_config("qwen2.5-3b").smoke()
B = 2
TOL = 2e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _close(got, want, tol=TOL, what=""):
    got = convert.tensor_to_numpy(got) if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.fixture(scope="module")
def weights():
    """The reference's smoke weights, as jax arrays and as CPU tensors."""
    jp = jtr.init(jax.random.PRNGKey(0), JCFG)
    return jp, convert.params_from_numpy(_np_tree(jp), device="cpu")


def _tokens(seed, s):
    return np.random.default_rng(seed).integers(0, JCFG.vocab_size, (B, s),
                                                dtype=np.int32)


@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_reference(smoke):
    t, j = get_config("qwen2.5-3b"), JARCHS["qwen2.5-3b"]
    if smoke:
        t, j = t.smoke(), j.smoke()
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.resolved_head_dim == j.resolved_head_dim


def test_init_matches_reference(weights):
    jp, _ = weights
    tp = ttr.init(rnd.PRNGKey(0, device="cpu"), TCFG, device="cpu")
    got, want = dict(_leaves(tp)), dict(_leaves(_np_tree(jp)))
    assert sorted(got) == sorted(want)
    for name in want:
        assert tuple(got[name].shape) == want[name].shape, name
        _close(got[name], want[name], 1e-5, name)


def test_norm_and_rope_match_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 9, 4, 64)).astype(np.float32)
    pos = rng.integers(0, 500, (1, 9)).astype(np.int32)
    tables = tlayers.rope_tables(torch.from_numpy(pos), 64, 1e6)
    _close(tlayers.apply_rope(torch.from_numpy(x), *tables),
           jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    h = rng.standard_normal((B, 9, 256)).astype(np.float32)
    sc = (rng.standard_normal(256) * 0.1).astype(np.float32)
    _close(tlayers.norm({"scale": torch.from_numpy(sc)}, torch.from_numpy(h), TCFG),
           jlayers.norm({"scale": jnp.asarray(sc)}, jnp.asarray(h), JCFG), 1e-6)


def test_attention_decode_matches_reference(weights):
    """One layer's decode attention against a cache with 13 filled rows."""
    jp, tp = weights
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 1, 256)).astype(np.float32)
    ck = rng.standard_normal((B, 20, 2, 64)).astype(np.float32)
    cv = rng.standard_normal((B, 20, 2, 64)).astype(np.float32)
    pos = 13
    jattn = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    want, wk, wv = jlayers.attention_decode(jattn, jnp.asarray(x), jnp.asarray(ck),
                                            jnp.asarray(cv), jnp.int32(pos), JCFG)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    rope_cs = tlayers.rope_tables(torch.full((1, 1), pos), 64, TCFG.rope_theta)
    got, gk, gv = tlayers.attention_decode(tlayers.take(tp["layers"], 0)["attn"],
                                           torch.from_numpy(x), tk, tv, pos,
                                           rope_cs, TCFG)
    assert gk is tk and gv is tv                       # written in place
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)


def test_prefill_matches_reference(weights):
    jp, tp = weights
    toks = _tokens(3, 24)
    jl, jc = jtr.prefill(jp, {"tokens": jnp.asarray(toks)}, JCFG)
    tl, tc = ttr.prefill(tp, {"tokens": torch.from_numpy(toks)}, TCFG)
    assert tuple(tl.shape) == jl.shape == (B, 1, JCFG.vocab_size)
    _close(tl, jl, what="logits")
    for k in ("k", "v"):
        assert tuple(tc[k].shape) == jc[k].shape
        _close(tc[k], jc[k], what=k)


def test_decode_steps_after_prefill_match_reference(weights):
    """Three decode steps from the reference's prefill cache, carried into a
    preallocated port cache with room for them."""
    jp, tp = weights
    s = 24
    toks = _tokens(4, s + 3)
    _, jc = jtr.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])}, JCFG)
    tc = convert.cache_from_numpy(_np_tree(jc), max_seq=s + 3, device="cpu")
    jc = jserve.grow_cache(jc, 3)
    for i in range(3):
        tok = toks[:, s + i:s + i + 1]
        jl, jc = jtr.decode_step(jp, jc, jnp.asarray(tok), jnp.int32(s + i), JCFG)
        tl, tc2 = ttr.decode_step(tp, tc, torch.from_numpy(tok), s + i, TCFG)
        assert tc2 is tc
        _close(tl, jl, what=f"logits at step {i}")
    for k in ("k", "v"):
        _close(tc[k], jc[k], what=k)


def test_prefill_into_preallocated_cache(weights):
    """Prefill writes rows 0..S-1 of a larger cache in place, the same rows
    a prompt-sized cache gets, and leaves the rest zero."""
    _, tp = weights
    toks = torch.from_numpy(_tokens(5, 17))
    big = ttr.init_cache(TCFG, B, 25, device="cpu")
    l1, c1 = ttr.prefill(tp, {"tokens": toks}, TCFG, cache=big)
    l2, c2 = ttr.prefill(tp, {"tokens": toks}, TCFG)
    assert c1 is big and c2["k"].shape[2] == 17
    assert torch.equal(l1, l2)
    for k in ("k", "v"):
        assert torch.equal(c1[k][:, :, :17], c2[k])
        assert not c1[k][:, :, 17:].any()


def test_prefill_then_decode_consistency():
    """decode_step after prefill reproduces the full forward's last logits
    over the extended sequence (tests/test_models_smoke.py:78's check; in
    fp32 the two differ by summation order only, so 2e-5, not its 5e-2)."""
    key = rnd.PRNGKey(1, device="cpu")
    tp = ttr.init(key, TCFG, device="cpu")
    s = 32
    toks = rnd.randint(key, (B, s + 1), 0, TCFG.vocab_size)
    cache = ttr.init_cache(TCFG, B, s + 4, device="cpu")
    _, cache = ttr.prefill(tp, {"tokens": toks[:, :s]}, TCFG, cache=cache)
    logits_d, _ = ttr.decode_step(tp, cache, toks[:, s:s + 1], s, TCFG)
    logits_f, _ = ttr.prefill(tp, {"tokens": toks}, TCFG)
    torch.testing.assert_close(logits_d[:, -1], logits_f[:, -1], atol=TOL, rtol=TOL)


def test_generate_matches_reference():
    """Greedy generation through the port's entry point gives the tokens of
    the reference's own ``generate`` and of a JAX prefill + decode_step loop
    on the port's weights; the prompt tokens are bit-equal."""
    gen, plen = 8, 16
    seqs, stats = tserve.generate("qwen2.5-3b", smoke=True, batch=B,
                                  prompt_len=plen, gen=gen, seed=0, device="cpu")
    assert seqs.shape == (B, gen) and seqs.dtype == torch.int32
    assert stats["tokens_per_s"] > 0 and stats["prefill_ms"] > 0

    key = rnd.PRNGKey(0, device="cpu")
    jkey = jax.random.PRNGKey(0)
    jtoks = jax.random.randint(jax.random.fold_in(jkey, 1), (B, plen), 0,
                               JCFG.vocab_size)
    ttoks = rnd.randint(rnd.fold_in(key, 1), (B, plen), 0, TCFG.vocab_size)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))

    jp = jax.tree.map(jnp.asarray, convert.params_to_numpy(
        ttr.init(key, TCFG, device="cpu")))
    logits, cache = jtr.prefill(jp, {"tokens": jtoks}, JCFG)
    cache = jserve.grow_cache(cache, gen)
    tok = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
    out = [tok]
    for i in range(gen - 1):
        logits, cache = jtr.decode_step(jp, cache, tok, jnp.int32(plen + i), JCFG)
        tok = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
        out.append(tok)
    np.testing.assert_array_equal(seqs.numpy(), np.concatenate(out, axis=1))

    jseqs, _ = jserve.generate("qwen2.5-3b", smoke=True, batch=B,
                               prompt_len=plen, gen=gen, seed=0)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(jseqs))


def test_kernels_are_not_launched_on_the_cpu():
    from repro_torch.kernels import flash_attention, rmsnorm
    before = (rmsnorm.rmsnorm.launches, flash_attention.flash_attention.launches)
    tserve.generate("qwen2.5-3b", smoke=True, batch=1, prompt_len=4, gen=2,
                    device="cpu")
    assert (rmsnorm.rmsnorm.launches,
            flash_attention.flash_attention.launches) == before


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.generate("qwen2.5-3b", smoke=True, batch=1, prompt_len=4, gen=2)


@pytest.mark.parametrize("change", [
    dict(n_experts=4, experts_per_token=2, moe_d_ff=128),
    dict(family="moe"),
    dict(family="vlm", num_prefix_tokens=8),
    dict(activation="gelu"),
    dict(activation="geglu"),
])
def test_other_families_are_refused(change):
    """The families and MLPs once refused here run and give the
    reference's prefill logits: the MoE layer (every config with experts)
    and the family name "moe", the VLM (with 8 prefix embeddings before the
    tokens), GELU (two matrices) and GeGLU. Only an unknown activation is
    refused."""
    cfg = dataclasses.replace(TCFG, **change)
    jcfg = dataclasses.replace(JCFG, **change)
    jp = jtr.init(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_numpy(_np_tree(jp), device="cpu")
    assert ("moe" in tp["layers"]) == bool(cfg.n_experts)
    assert ("wg" in tp["layers"].get("mlp", {"wg": 0})) == (cfg.activation != "gelu")
    toks = _tokens(6, 12)
    batch = {"tokens": toks}
    if cfg.num_prefix_tokens:
        batch["prefix_embeddings"] = np.random.default_rng(7).standard_normal(
            (B, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)
    jl, jc = jtr.prefill(jp, jax.tree.map(jnp.asarray, batch), jcfg)
    tl, tc = tapi.get_model(cfg).prefill(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    _close(tl, jl, what="logits")
    _close(tc["k"], jc["k"], what="cache k")
    with pytest.raises(ValueError, match="activation"):
        tlayers.mlp_init(rnd.PRNGKey(0, device="cpu"), 8, 16, "relu", torch.float32)


def test_get_model_refuses_other_families():
    """Family ``audio`` gets the encoder-decoder's functions; the
    transformer itself refuses it, naming the module that serves it."""
    from repro_torch.models import encdec
    assert tapi.get_model(TCFG).decode_step is ttr.decode_step
    m = tapi.get_model(dataclasses.replace(TCFG, family="audio"))
    assert (m.init, m.loss_fn, m.prefill, m.decode_step, m.init_cache) == (
        encdec.init, encdec.loss_fn, encdec.prefill, encdec.decode_step,
        encdec.init_cache)
    assert get_config("seamless-m4t-medium").family == "audio"
    with pytest.raises(NotImplementedError, match="models/encdec.py"):
        ttr.init(rnd.PRNGKey(0, device="cpu"),
                 dataclasses.replace(TCFG, family="audio"), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trips_nested_params_and_caches(dtype):
    cfg = dataclasses.replace(JCFG, dtype=dtype)
    jp = _np_tree(jtr.init(jax.random.PRNGKey(2), cfg))
    back = convert.params_to_numpy(convert.params_from_numpy(jp, device="cpu"))
    want, got = dict(_leaves(jp)), dict(_leaves(back))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], np.asarray(want[name], np.float32))
    tp = convert.params_from_numpy(jp, device="cpu")
    assert tp["layers"]["attn"]["wq"].dtype == ttr.DTYPES[dtype]

    jc = _np_tree(jtr.init_cache(cfg, B, 6))
    jc = {k: np.asarray(np.random.default_rng(3).standard_normal(v.shape),
                        v.dtype) for k, v in jc.items()}
    tc = convert.cache_from_numpy(jc, max_seq=10, device="cpu")
    assert tc["k"].shape == (2, B, 10, 2, 64) and not tc["k"][:, :, 6:].any()
    back = convert.cache_to_numpy(tc, length=6)
    for k in jc:
        np.testing.assert_array_equal(back[k], np.asarray(jc[k], np.float32))
    with pytest.raises(ValueError, match="max_seq"):
        convert.cache_from_numpy(jc, max_seq=3, device="cpu")
