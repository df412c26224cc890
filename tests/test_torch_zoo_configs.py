"""The port's copies of the reference's decoder configs with head dim <= 128
(qwen3-moe-30b-a3b, arctic-480b, glm4-9b, glm4-9b-swa, deepseek-67b)
against ``repro.configs``, and the two features besides the MoE that they
add, on the CPU at the smoke size, weights carried across by ``convert``:
glm4-9b-swa's sliding window (16 at the smoke size; prompt 32) and
deepseek-67b's untied ``unembed``.

Tolerances: init 1e-5 (torch.erfinv against XLA's, a few ulps); prefill
and decode logits and caches 2e-5 (the flash tolerance: the online softmax
sums in another order than the reference's ``dot_attention``);
prefill-then-decode consistency 2e-5, as qwen2.5-3b's; ``loss_fn`` rtol
1e-5 and its gradient atol 1e-5; the two decode views of the windowed
cache exactly; greedy tokens exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.launch import serve as jserve
from repro.models import transformer as jtr
from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.core.tree import leaves
from repro_torch.launch import serve as tserve
from repro_torch.launch.dryrun import param_shapes
from repro_torch.models import api as tapi
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttr

NEW = ["qwen3-moe-30b-a3b", "arctic-480b", "glm4-9b", "glm4-9b-swa",
       "deepseek-67b"]
HEAD_DIM_256 = ["gemma-7b", "paligemma-3b"]
# the parameter counts at full size that the README and PERF.md quote
N_PARAMS = {"qwen3-moe-30b-a3b": 30_220_945_408, "glm4-9b": 8_779_194_368,
            "glm4-9b-swa": 8_779_194_368, "deepseek-67b": 67_425_001_472,
            "arctic-480b": 476_620_899_328, "gemma-7b": 8_537_680_896,
            "paligemma-3b": 2_508_662_784, "seamless-m4t-medium": 614_739_968}
B = 2
TOL = 2e-5


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


def _tokens(seed, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, s), dtype=np.int32)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", NEW + HEAD_DIM_256 + ["mnist-mlp"])
def test_config_matches_reference(arch, smoke):
    """Field by field, at full size and at the smoke size (whose cuts are
    the reference's: paligemma-3b keeps 8 prefix tokens, head dim 64)."""
    t, j = get_config(arch), JARCHS[arch]
    if smoke:
        t, j = t.smoke(), j.smoke()
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.resolved_head_dim == j.resolved_head_dim
    assert arch not in NEW or t.resolved_head_dim <= 128


@pytest.mark.parametrize("arch", NEW + HEAD_DIM_256)
def test_full_size_shapes_match_reference(arch):
    """The port's init at full size on the meta device
    (``dryrun.param_shapes``: nothing drawn) gives the reference's shapes
    (``jax.eval_shape`` of its init), leaf by leaf, and the counts
    quoted."""
    got = param_shapes(tapi.get_model(get_config(arch)), get_config(arch))
    want = jax.eval_shape(lambda k: jtr.init(k, JARCHS[arch]),
                          jax.random.PRNGKey(0))
    assert [tuple(t.shape) for t in leaves(got)] == \
        [x.shape for x in jax.tree.leaves(want)]
    assert sum(t.numel() for t in leaves(got)) == N_PARAMS[arch]


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-1.2b",
                                  "seamless-m4t-medium"])
def test_other_archs_are_refused_naming_their_item(arch):
    """The SSM, hybrid and encoder-decoder archs, which the port once
    refused, resolve to the reference's configs, field by field; no arch of
    the reference is refused any more. The encoder-decoder's init at full
    size (on the meta device, ``dryrun.param_shapes``) has the parameters
    quoted."""
    assert arch in JARCHS and sorted(ARCHS) == sorted(JARCHS)
    t, j = get_config(arch), JARCHS[arch]
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    if arch == "seamless-m4t-medium":
        got = param_shapes(tapi.get_model(t), t)
        assert sum(x.numel() for x in leaves(got)) == N_PARAMS[arch]


# ---------------------------------------------------------------------------
# glm4-9b-swa: the sliding window
# ---------------------------------------------------------------------------

SWA = "glm4-9b-swa"


@pytest.fixture(scope="module")
def swa():
    jcfg, tcfg = JARCHS[SWA].smoke(), get_config(SWA).smoke()
    assert tcfg.sliding_window == 16 and tcfg.qkv_bias
    jp = jtr.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, convert.params_from_numpy(_np_tree(jp), "cpu")


def test_swa_init_matches_reference(swa):
    _, tcfg, jp, _ = swa
    tp = ttr.init(rnd.PRNGKey(0, device="cpu"), tcfg, device="cpu")
    got, want = dict(_named(tp)), dict(_named(_np_tree(jp)))
    assert sorted(got) == sorted(want)
    for name in want:
        _close(got[name], want[name], 1e-5, name)


def test_swa_prefill_and_decode_match_reference(swa):
    """A 32-token prompt (twice the window), then three decode steps from
    the reference's prefill cache."""
    jcfg, tcfg, jp, tp = swa
    s = 32
    toks = _tokens(1, s + 3)
    jl, jc = jtr.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])}, jcfg)
    tl, tc = ttr.prefill(tp, {"tokens": torch.from_numpy(toks[:, :s])}, tcfg)
    _close(tl, jl, what="prefill logits")
    for k in ("k", "v"):
        _close(tc[k], jc[k], what=k)
    tc = convert.cache_from_numpy(_np_tree(jc), max_seq=s + 3, device="cpu")
    jc = jserve.grow_cache(jc, 3)
    for i in range(3):
        tok = toks[:, s + i:s + i + 1]
        jl, jc = jtr.decode_step(jp, jc, jnp.asarray(tok), jnp.int32(s + i), jcfg)
        tl, tc = ttr.decode_step(tp, tc, torch.from_numpy(tok), s + i, tcfg)
        _close(tl, jl, what=f"logits at step {i}")


def test_swa_prefill_then_decode_consistency(swa):
    """decode_step at position 32 after a 32-token prefill against the full
    forward over 33 tokens (tests/test_models_smoke.py:78's check, which
    holds glm4-9b-swa too); with the window off the same decode reads
    keys the windowed forward does not, and misses it by far more."""
    _, tcfg, _, tp = swa
    s = 32
    toks = torch.from_numpy(_tokens(2, s + 1))

    def last(cfg):
        cache = ttr.init_cache(cfg, B, s + 4, device="cpu")
        _, cache = ttr.prefill(tp, {"tokens": toks[:, :s]}, cfg, cache=cache)
        logits_d, _ = ttr.decode_step(tp, cache, toks[:, s:], s, cfg)
        logits_f, _ = ttr.prefill(tp, {"tokens": toks}, cfg)
        return logits_d[:, -1], logits_f[:, -1]

    decoded, full = last(tcfg)
    torch.testing.assert_close(decoded, full, atol=TOL, rtol=TOL)
    unwindowed, _ = last(dataclasses.replace(tcfg, sliding_window=0))
    assert (unwindowed - full).abs().max() > 100 * TOL


@pytest.mark.parametrize("pos", [5, 15, 16, 40])
def test_swa_decode_views_are_equal(swa, pos):
    """The decode attention over the cache rows 0..pos with the window, and
    over the rows max(0, pos-W+1)..pos (the view ``attention_decode``
    hands the kernel), give the same output."""
    _, tcfg, _, _ = swa
    w = tcfg.sliding_window
    rng = np.random.default_rng(pos)
    q = torch.from_numpy(rng.standard_normal((B, 1, 4, 64), dtype=np.float32))
    ck, cv = (torch.from_numpy(rng.standard_normal((B, 48, 2, 64), dtype=np.float32))
              for _ in range(2))
    lo = max(0, pos - w + 1)
    full = tlayers._flash(q, ck[:, :pos + 1], cv[:, :pos + 1], w)
    cut = tlayers._flash(q, ck[:, lo:pos + 1], cv[:, lo:pos + 1], w)
    assert torch.equal(full, cut)
    if pos >= w:
        assert not torch.equal(tlayers._flash(q, ck[:, :pos + 1],
                                              cv[:, :pos + 1], 0), cut)


def test_swa_loss_and_grad_match_jax(swa):
    """The windowed training attention (the flash Function with the window,
    its backward the windowed backward) against the reference's masked
    ``dot_attention``, at sequence 40 > the window."""
    jcfg, tcfg, jp, _ = swa
    toks = _tokens(3, 41)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    jloss, jgrads = jax.value_and_grad(jtr.loss_fn)(
        jp, jax.tree.map(jnp.asarray, batch), jcfg)
    tp = convert.params_from_numpy(_np_tree(jp), "cpu")
    for t in leaves(tp):
        t.requires_grad_()
    loss = ttr.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = dict(_named(_np_tree(jgrads)))
    got = {k: v.grad for k, v in _named(tp)}
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], 1e-5, k)


def test_swa_generate_matches_reference():
    gen, plen = 8, 24
    seqs, _ = tserve.generate(SWA, smoke=True, batch=B, prompt_len=plen, gen=gen,
                              seed=0, device="cpu")
    jseqs, _ = jserve.generate(SWA, smoke=True, batch=B, prompt_len=plen, gen=gen,
                               seed=0)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(jseqs))


# ---------------------------------------------------------------------------
# deepseek-67b: untied embeddings
# ---------------------------------------------------------------------------

DS = "deepseek-67b"


@pytest.fixture(scope="module")
def deepseek():
    jcfg, tcfg = JARCHS[DS].smoke(), get_config(DS).smoke()
    assert not tcfg.tie_embeddings
    return jcfg, tcfg, jtr.init(jax.random.PRNGKey(0), jcfg)


def test_unembed_draw_matches_reference(deepseek):
    """init draws ``unembed`` (D, V) from the third key of split(key, 3),
    as the reference does; a tied config has none."""
    _, tcfg, jp = deepseek
    tp = ttr.init(rnd.PRNGKey(0, device="cpu"), tcfg, device="cpu")
    assert tuple(tp["unembed"].shape) == (tcfg.d_model, tcfg.vocab_size)
    got, want = dict(_named(tp)), dict(_named(_np_tree(jp)))
    assert sorted(got) == sorted(want)
    for name in want:
        _close(got[name], want[name], 1e-5, name)
    tied = ttr.init(rnd.PRNGKey(0, device="cpu"),
                    dataclasses.replace(tcfg, tie_embeddings=True), device="cpu")
    assert "unembed" not in tied


def test_untied_logits_match_reference(deepseek):
    """Prefill and a decode step's logits through ``unembed``, and the loss
    and the unembed's gradient."""
    jcfg, tcfg, jp = deepseek
    tp = convert.params_from_numpy(_np_tree(jp), "cpu")
    s = 20
    toks = _tokens(4, s + 1)
    jl, jc = jtr.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])}, jcfg)
    tl, tc = ttr.prefill(tp, {"tokens": torch.from_numpy(toks[:, :s])}, tcfg,
                         cache=ttr.init_cache(tcfg, B, s + 1, device="cpu"))
    _close(tl, jl, what="prefill logits")
    jl, _ = jtr.decode_step(jp, jserve.grow_cache(jc, 1),
                            jnp.asarray(toks[:, s:]), jnp.int32(s), jcfg)
    tl, _ = ttr.decode_step(tp, tc, torch.from_numpy(toks[:, s:]), s, tcfg)
    _close(tl, jl, what="decode logits")
    tied = ttr.logits_fn(tp, torch.ones(1, 1, tcfg.d_model),
                         dataclasses.replace(tcfg, tie_embeddings=True))
    assert not torch.allclose(tied, ttr.logits_fn(tp, torch.ones(1, 1, tcfg.d_model),
                                                  tcfg))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    jloss, jgrads = jax.value_and_grad(jtr.loss_fn)(
        jp, jax.tree.map(jnp.asarray, batch), jcfg)
    tp["unembed"].requires_grad_()
    loss = ttr.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    _close(tp["unembed"].grad, jgrads["unembed"], 1e-5, "unembed grad")


def test_glm4_prefill_matches_reference():
    """glm4-9b's smoke variant (GQA 4/2 with QKV bias, the full-size 16
    query heads per KV head cut to 2): prefill logits and caches."""
    jcfg, tcfg = JARCHS["glm4-9b"].smoke(), get_config("glm4-9b").smoke()
    jp = jtr.init(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_numpy(_np_tree(jp), "cpu")
    toks = _tokens(5, 24)
    jl, jc = jtr.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, tc = ttr.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    _close(tl, jl, what="logits")
    for k in ("k", "v"):
        _close(tc[k], jc[k], what=k)


# ---------------------------------------------------------------------------
# convert: the nested trees of the new leaves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "arctic-480b", DS])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trips_moe_and_unembed_leaves(arch, dtype):
    """params_from_numpy / params_to_numpy and the SSCA state carry the
    3-D expert leaves, the router, arctic's nested dense MLP and the
    unembedding, in the reference's leaf order."""
    cfg = dataclasses.replace(JARCHS[arch].smoke(), dtype=dtype)
    jp = _np_tree(jtr.init(jax.random.PRNGKey(2), cfg))
    tp = convert.params_from_numpy(jp, device="cpu")
    back = convert.params_to_numpy(tp)
    want, got = dict(_named(jp)), dict(_named(back))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], np.asarray(want[name], np.float32))
    assert [tuple(t.shape) for t in leaves(tp)] == [x.shape for x in jax.tree.leaves(jp)]
    if cfg.n_experts:
        assert tp["layers"]["moe"]["wi"].dim() == 4         # (L, E, D, F)
    else:
        assert tp["unembed"].dtype == ttr.DTYPES[dtype]
    state = convert.ssca_state_from_numpy(jp, jp, 3, device="cpu")
    out = convert.ssca_state_to_numpy(state)
    for tree in (out["params"], out["g"]):
        assert all(np.array_equal(dict(_named(tree))[k], np.asarray(want[k], np.float32))
                   for k in want)


@pytest.mark.parametrize("arch", ["glm4-9b", "glm4-9b-swa", "qwen3-moe-30b-a3b",
                                  "deepseek-67b"])
def test_full_size_decode_takes_the_split_kernel(arch):
    """At batch 8 after a 512-token prompt, bf16 decode of the full-size
    configs stays on the split kernel: glm4-9b's 32 query heads over 2 KV
    heads are 16 rows a group, the kernel's limit (SPLIT_ROWS)."""
    from repro_torch.kernels import flash_attention as fa
    cfg = get_config(arch)
    rows = cfg.n_heads // cfg.n_kv_heads
    assert rows <= fa.SPLIT_ROWS
    assert fa.decode_splits(torch.bfloat16, 8, cfg.n_heads, cfg.n_kv_heads, 1,
                            543) > 0
    assert fa.decode_splits(torch.float32, 8, cfg.n_heads, cfg.n_kv_heads, 1,
                            543) == 0
