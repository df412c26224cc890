"""Head dims off the kernels' tile widths: qwen2.5-3b's smoke variant (2
layers, d_model 256, 4 query heads over 2 KV heads, vocab 512, fp32) with
``head_dim`` 24, 80 and 100 (the reference's ``ModelConfig`` override;
80 is pythia-2.8b's, phi-2's and OPT-2.7b's), held against the JAX package
on the CPU; and the flash wrappers' meta branch (the dry run's) at head
dims 1 to 320 with the decode kernel's splits at the padded widths.

On the card the tiled kernels run such a head dim at the smallest of
their widths that holds it and the others take the kernels of any width
(tests/test_torch_gpu.py holds both against the plain version); here the
wrappers take the plain version, so these tests hold the model's shapes
and arithmetic at those head dims against the reference's. Tolerances are
tests/test_torch_transformer.py's and test_torch_train.py's: prefill and
decode logits 2e-5, loss rtol 1e-5, gradients and params after 3 steps
atol 1e-5.
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
from repro.models import transformer as jtr
from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.configs.base import FLConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import optimizer as topt
from repro_torch.core import rounds as trounds
from repro_torch.core.tree import leaves
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from repro_torch.models import transformer as ttr

HEAD_DIMS = (24, 80, 100)
FL_KW = dict(a1=0.9, a2=0.5, alpha_rho=0.1, alpha_gamma=0.6, tau=0.2,
             l2_lambda=1e-5, cost_limit=3.0)
B, S = 2, 16
TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _configs(d):
    return (dataclasses.replace(JARCHS["qwen2.5-3b"].smoke(), head_dim=d),
            dataclasses.replace(get_config("qwen2.5-3b").smoke(), head_dim=d))


@pytest.fixture(scope="module", params=HEAD_DIMS)
def model(request):
    """(head dim, reference config, port config, the reference's weights as
    jax arrays and as numpy)."""
    jcfg, tcfg = _configs(request.param)
    jp = jtr.init(jax.random.PRNGKey(0), jcfg)
    return request.param, jcfg, tcfg, jp, jax.tree.map(np.asarray, jp)


def _named(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _named(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _tokens(seed, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, s), dtype=np.int32)


def test_head_dim_reaches_the_attention(model):
    d, _, tcfg, _, npp = model
    assert tcfg.resolved_head_dim == d
    assert npp["layers"]["attn"]["wq"].shape[-1] == tcfg.n_heads * d


def test_head_dim_loss_and_grad_match_jax(model):
    _, jcfg, tcfg, jp, npp = model
    toks = _tokens(0, S + 1, jcfg.vocab_size)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    jloss, jgrads = jax.value_and_grad(jtr.loss_fn)(
        jp, jax.tree.map(jnp.asarray, batch), jcfg)
    tp = convert.params_from_numpy(npp, "cpu")
    for t in leaves(tp):
        t.requires_grad_()
    loss = tapi.get_model(tcfg).loss_fn(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    got = dict(_named(_grads(tp)))
    want = dict(_named(jax.tree.map(np.asarray, jgrads)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)


def _grads(tree):
    return {k: _grads(v) if isinstance(v, dict) else v.grad.numpy()
            for k, v in tree.items()}


def test_head_dim_prefill_then_decode_match_jax(model):
    """Prefill of 24 tokens (logits and caches), then three decode steps
    from the reference's prefill cache in a preallocated port cache."""
    _, jcfg, tcfg, jp, npp = model
    tp = convert.params_from_numpy(npp, "cpu")
    s = 24
    toks = _tokens(4, s + 3, jcfg.vocab_size)
    jl, jc = jtr.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])}, jcfg)
    tl, tc = ttr.prefill(tp, {"tokens": torch.from_numpy(toks[:, :s])}, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=TOL,
                                   atol=TOL)
    tc = convert.cache_from_numpy(jax.tree.map(np.asarray, jc), max_seq=s + 3,
                                  device="cpu")
    jc = jserve.grow_cache(jc, 3)
    for i in range(3):
        tok = toks[:, s + i:s + i + 1]
        jl, jc = jtr.decode_step(jp, jc, jnp.asarray(tok), jnp.int32(s + i), jcfg)
        tl, tc = ttr.decode_step(tp, tc, torch.from_numpy(tok), s + i, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL,
                                   err_msg=f"step {i}")


def test_head_dim_trajectory_matches_jax(model):
    """3 steps of make_scanned_step from the same weights, tokens and round
    inputs: losses rtol 1e-5, params atol 1e-5 after step 3."""
    _, jcfg, tcfg, jp, npp = model
    steps = 3
    jkey = jax.random.fold_in(jax.random.PRNGKey(0), 1)
    jtoks = jsyn.token_dataset(jkey, jcfg.vocab_size, 2000)
    ttoks = tsyn.token_dataset(convert.key_from_numpy(np.asarray(jkey), "cpu"),
                               tcfg.vocab_size, 2000)
    jfl, tfl = JFLConfig(**FL_KW), FLConfig(**FL_KW)
    jstep = jtrain.make_scanned_step(jget_model(jcfg), jcfg, jfl, jtoks, B, S)
    tstep = ttrain.make_scanned_step(tapi.get_model(tcfg), tcfg, tfl, ttoks, B, S)
    jin = jrounds.make_inputs(jfl, 1, steps, jax.random.PRNGKey(9))
    tin = trounds.make_inputs(tfl, 1, steps, rnd.PRNGKey(9, device="cpu"))
    jstate, jms = jrounds.loop_rounds(jstep, jopt.ssca_init(jp), jin)
    tstate, tms = trounds.ENGINES["scan"](tstep, topt.ssca_init(
        convert.params_from_numpy(npp, "cpu")), tin)
    np.testing.assert_allclose(tms["loss"].numpy(), np.asarray(jms["loss"]), rtol=1e-5)
    got = dict(_named(convert.params_to_numpy(tstate.params)))
    want = dict(_named(jax.tree.map(np.asarray, jstate.params)))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("d", [1, 80, 100, 192, 320])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_meta_takes_any_head_dim(d, dtype):
    """The wrappers' meta branch at any head dim: the forward's output laid
    out as q (a transposed q gives a transposed output), the logsumexp, and
    the backward's gradients, shapes and dtypes as the kernels write them."""
    q = torch.empty(2, 9, 8, d, dtype=dtype, device="meta").transpose(1, 2)
    k = torch.empty(2, 2, 33, d, dtype=dtype, device="meta")
    out, lse = fa.flash_attention(q, k, k, return_lse=True)
    assert out.shape == q.shape and out.dtype == dtype
    assert d == 1 or out.stride() == q.stride()     # at d = 1 any layout is dense
    assert lse.shape == (2, 8, 9) and lse.dtype == torch.float32
    dq, dk, dv = fa.flash_attention_bwd(q, k, k, out, lse, out)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
    assert all(t.device.type == "meta" and t.dtype == dtype for t in (dq, dk, dv))


def test_flash_meta_refuses_a_head_dim_past_the_limit():
    q = torch.empty(1, 2, 4, fa.MAX_HEAD_DIM + 1, device="meta")
    with pytest.raises(ValueError, match=f"head dim {fa.MAX_HEAD_DIM + 1}"):
        fa.flash_attention(q, q, q)


@pytest.mark.parametrize("d,bf16_width,f32_width,cap", [
    (1, 0, 0, 0), (16, 32, 32, 16), (24, 32, 32, 16), (48, 64, 64, 16),
    (80, 128, 128, 16), (96, 128, 128, 16), (100, 0, 128, 0), (112, 128, 128, 16),
    (160, 256, 256, 9), (192, 256, 256, 9), (256, 256, 256, 9), (320, 0, 0, 0)])
def test_padded_widths_and_decode_splits(d, bf16_width, f32_width, cap):
    """The width each head dim runs at (0: the kernels of any width, for a
    row that is not whole 16-byte vectors or a head dim past 256), the
    decode kernel's split cap at that width, and its splits at qwen2.5-3b's
    serve decode (8 x 2 groups over 543 keys): 9, or 0 where the decode
    kernel does not take the call (fp32, or a width of 0)."""
    assert fa.padded_width(d, torch.bfloat16) == bf16_width
    assert fa.padded_width(d, torch.float32) == f32_width
    assert fa.padded_width(d, torch.bfloat16, aligned=False) == 0
    assert fa.split_cap(d) == cap
    if cap:
        assert fa.split_smem_bytes(d, cap) <= fa.SMEM_OPT_IN_MAX - 1024
    assert fa.decode_splits(torch.bfloat16, 8, 16, 2, 1, 543, d=d) == (9 if cap else 0)
    assert fa.decode_splits(torch.float32, 8, 16, 2, 1, 543, d=d) == 0
    assert fa.decode_splits(torch.bfloat16, 8, 16, 2, 1, 543, d=d, aligned=False) == 0
