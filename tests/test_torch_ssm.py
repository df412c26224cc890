"""The port's sequence mixers (``repro_torch.models.ssm``) against the JAX
reference (``repro.models.ssm``) on the CPU: chunked gated linear attention
and its decode step, the depthwise causal conv helpers, and the Mamba2,
mLSTM and sLSTM blocks (init, the chunked block with and without its
returned state, the one-token decode). Inputs come from numpy seeds and
weights are carried across by ``convert``.

Tolerances, absolute plus relative: 2e-5 in fp32, the zoo's gate (the
einsums sum in another order than XLA's); against an fp64 step-by-step
recurrence 2e-5 of the output's largest magnitude. Init within 1e-5 of the
reference's draws (torch's erfinv against XLA's, a few ulps), and bit-equal
with the normal draw taken from jax.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.configs.registry import get_config
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm

TOL = 2e-5
B = 2


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


def _close_trees(got, want, tol=TOL):
    got, want = dict(_named(got)), dict(_named(_np_tree(want)))
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], tol, what=k)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _configs(arch):
    """(reference, port) smoke configs."""
    return JARCHS[arch].smoke(), get_config(arch).smoke()


# ---------------------------------------------------------------------------
# chunked gated linear attention
# ---------------------------------------------------------------------------


def _gla_inputs(s, seed, dk=8, dv=9, h=3):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, h, s, dk)).astype(np.float32)
    k = rng.standard_normal((B, h, s, dk)).astype(np.float32)
    v = rng.standard_normal((B, h, s, dv)).astype(np.float32)
    log_a = (-0.3 * np.abs(rng.standard_normal((B, h, s)))).astype(np.float32)
    state = rng.standard_normal((B, h, dk, dv)).astype(np.float32)
    return q, k, v, log_a, state


def _recurrence(q, k, v, log_a, state=None):
    """H_t = a_t H_{t-1} + k_tᵀ v_t, y_t = q_t H_t, step by step in fp64."""
    b, h, s, dk = q.shape
    hs = np.zeros((b, h, dk, v.shape[-1])) if state is None else state.astype(np.float64)
    ys = []
    for t in range(s):
        hs = (np.exp(log_a[:, :, t].astype(np.float64))[..., None, None] * hs
              + np.einsum("bhk,bhv->bhkv", k[:, :, t].astype(np.float64), v[:, :, t]))
        ys.append(np.einsum("bhk,bhkv->bhv", q[:, :, t].astype(np.float64), hs))
    return np.stack(ys, axis=2), hs


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [24, 100])
@pytest.mark.parametrize("chunk", [1, 3, 8, 64])
def test_chunked_gla_matches_reference_and_recurrence(chunk, s, with_state):
    """Every chunk size, S a multiple of the chunk and not (a padded tail;
    chunk 64 at S = 24 takes c = S), with and without an initial state; Dv
    odd, as mLSTM's hd + 1."""
    q, k, v, log_a, state = _gla_inputs(s, chunk * 1000 + s)
    init = state if with_state else None
    jy, jst = jax.jit(jssm.chunked_gla, static_argnums=4)(
        *map(jnp.asarray, (q, k, v, log_a)), chunk,
        None if init is None else jnp.asarray(init))
    ty, tst = tssm.chunked_gla(*map(_t, (q, k, v, log_a)), chunk,
                               None if init is None else _t(init))
    assert ty.dtype == torch.float32 and tst.dtype == torch.float32
    assert ty.shape == (B, 3, s, 9) and tst.shape == (B, 3, 8, 9)
    _close(ty, jy, what="y")
    _close(tst, jst, what="final state")
    ry, rst = _recurrence(q, k, v, log_a, init)
    np.testing.assert_allclose(ty.numpy(), ry, rtol=0, atol=TOL * np.abs(ry).max())
    np.testing.assert_allclose(tst.numpy(), rst, rtol=0, atol=TOL * np.abs(rst).max())


def test_chunked_gla_keeps_v_dtype_and_an_fp32_state():
    """bf16 in, bf16 out; the state fp32, and within bf16 rounding of the
    fp32 computation."""
    q, k, v, log_a, _ = _gla_inputs(40, 5)
    args = [_t(a).to(torch.bfloat16) for a in (q, k, v)] + [_t(log_a)]
    y, st = tssm.chunked_gla(*args, 16)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    y32, st32 = tssm.chunked_gla(*[a.float() for a in args], 16)
    _close(y.float(), y32.numpy(), tol=2e-2)
    _close(st, st32.numpy())


def test_gla_decode_step_matches_reference_and_continues_the_chunked_state():
    q, k, v, log_a, state = _gla_inputs(13, 7)
    jy, jst = jssm.gla_decode_step(*map(jnp.asarray, (state, q[:, :, 0], k[:, :, 0],
                                                      v[:, :, 0], log_a[:, :, 0])))
    ty, tst = tssm.gla_decode_step(*map(_t, (state, q[:, :, 0], k[:, :, 0],
                                             v[:, :, 0], log_a[:, :, 0])))
    _close(ty, jy, what="y")
    _close(tst, jst, what="state")
    # chunked over 10, then 3 steps == chunked over 13
    _, st = tssm.chunked_gla(*map(_t, (q[:, :, :10], k[:, :, :10], v[:, :, :10],
                                       log_a[:, :, :10])), 4)
    for t in range(10, 13):
        y, st = tssm.gla_decode_step(st, *map(_t, (q[:, :, t], k[:, :, t], v[:, :, t],
                                                   log_a[:, :, t])))
    full, fst = tssm.chunked_gla(*map(_t, (q, k, v, log_a)), 4)
    _close(y, full[:, :, -1].numpy(), what="last output")
    _close(st, fst.numpy(), what="state")


# ---------------------------------------------------------------------------
# conv helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [2, 3, 11])
def test_conv_helpers_match_reference(s):
    """``_causal_conv``, ``_conv_decode`` and ``_conv_tail`` (S below, at
    and above the W-1 = 3 rows of the buffer), and decoding after the tail
    continues the causal conv."""
    rng = np.random.default_rng(s)
    c, width = 6, 4
    p = {"w": rng.standard_normal((width, c)).astype(np.float32),
         "b": rng.standard_normal((c,)).astype(np.float32)}
    x = rng.standard_normal((B, s + 1, c)).astype(np.float32)
    jp, tp = jax.tree.map(jnp.asarray, p), convert.params_from_numpy(p, "cpu")
    _close(tssm._causal_conv(tp, _t(x)), jssm._causal_conv(jp, jnp.asarray(x)))
    jt = jssm._conv_tail(jnp.asarray(x[:, :s]), width)
    tt = tssm._conv_tail(_t(x[:, :s]), width)
    assert tt.shape == (B, width - 1, c)
    _close(tt, jt, tol=0)
    jy, jb = jssm._conv_decode(jp, jt, jnp.asarray(x[:, s]))
    ty, tb = tssm._conv_decode(tp, tt, _t(x[:, s]))
    _close(ty, jy, what="decode y")
    _close(tb, jb, tol=0, what="decode buffer")
    _close(ty, tssm._causal_conv(tp, _t(x))[:, s].numpy(), what="decode vs conv")


def test_conv_init_matches_reference():
    key = jax.random.PRNGKey(4)
    want = jssm._conv1d_init(key, 4, 10, jnp.float32)
    got = tssm._conv1d_init(convert.key_from_numpy(np.asarray(key), "cpu"), 4, 10,
                            torch.float32)
    _close_trees(got, want, tol=1e-5)


# ---------------------------------------------------------------------------
# the blocks: Mamba2 (zamba2), mLSTM and sLSTM (xlstm)
# ---------------------------------------------------------------------------

BLOCKS = {  # name: (arch, init, block, init_state, decode)
    "mamba2": ("zamba2-1.2b", "mamba2_init", "mamba2_block", "mamba2_init_state",
               "mamba2_decode"),
    "mlstm": ("xlstm-1.3b", "mlstm_init", "mlstm_block", "mlstm_init_state",
              "mlstm_decode"),
    "slstm": ("xlstm-1.3b", "slstm_init", "slstm_block", "slstm_init_state",
              "slstm_decode"),
}


def _jax_normal(key, shape):
    """jax's normal draw from the port's key, as a tensor."""
    k = jnp.asarray(convert.key_to_numpy(key))
    return torch.from_numpy(np.array(jax.random.normal(k, tuple(shape))))


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_init_matches_reference(name, monkeypatch):
    """Within 1e-5 of the reference's draws; bit-equal with the normal draw
    taken from jax (keys, shapes, fan-ins, scales and casts all equal)."""
    arch, init = BLOCKS[name][:2]
    jcfg, tcfg = _configs(arch)
    key = jax.random.PRNGKey(3)
    want = getattr(jssm, init)(key, jcfg, jnp.float32)
    tkey = convert.key_from_numpy(np.asarray(key), "cpu")
    _close_trees(getattr(tssm, init)(tkey, tcfg, torch.float32), want, tol=1e-5)
    monkeypatch.setattr(rnd, "normal", _jax_normal)
    _close_trees(getattr(tssm, init)(tkey, tcfg, torch.float32), want, tol=0)


def _block_params(name, jcfg, seed):
    """The block's params (reference init from ``seed``), with the zero
    norms and biases filled with noise so every term shows."""
    rng = np.random.default_rng(seed)
    p = _np_tree(getattr(jssm, BLOCKS[name][1])(jax.random.PRNGKey(seed), jcfg,
                                                 jnp.float32))

    def fill(path, a):
        name = jax.tree_util.keystr(path)
        if "scale" in name or "'b'" in name:
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if "a_log" in name:
            return (0.5 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(fill, p)


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_state_and_decode_match_reference(name):
    """The chunked block over S = 40 (chunk 32: a padded tail) with and
    without ``return_state``, then 3 decode steps from its state; outputs
    and states at 2e-5. The port's decode from the port's state then
    matches its own block over S + 3 (the last output)."""
    arch = BLOCKS[name][0]
    jcfg, tcfg = _configs(arch)
    _, _, block, init_state, decode = BLOCKS[name]
    p = _block_params(name, jcfg, 11)
    jp, tp = jax.tree.map(jnp.asarray, p), convert.params_from_numpy(p, "cpu")
    s = 40
    x = np.random.default_rng(12).standard_normal((B, s + 3, jcfg.d_model)).astype(np.float32)
    jblock = jax.jit(getattr(jssm, block), static_argnums=(2, 3))
    jdecode = jax.jit(getattr(jssm, decode), static_argnums=3)
    jout, jst = jblock(jp, jnp.asarray(x[:, :s]), jcfg, True)
    tout, tst = getattr(tssm, block)(tp, _t(x[:, :s]), tcfg, return_state=True)
    _close(tout, jout, what="block output")
    _close_trees(tst, jst)
    _close(getattr(tssm, block)(tp, _t(x[:, :s]), tcfg), jout, what="without state")
    zero = getattr(tssm, init_state)(tcfg, B)
    want_zero = (getattr(jssm, init_state)(jcfg, B) if name == "slstm"
                 else getattr(jssm, init_state)(jcfg, B, jnp.float32))
    _close_trees(zero, want_zero, tol=0)
    assert all(t.dtype == torch.float32 for k, t in _named(zero) if k != "conv")
    for t in range(s, s + 3):
        jy, jst = jdecode(jp, jst, jnp.asarray(x[:, t]), jcfg)
        ty, tst = getattr(tssm, decode)(tp, tst, _t(x[:, t]), tcfg)
        _close(ty, jy, what=f"decode {t}")
        _close_trees(tst, jst)
    full = getattr(tssm, block)(tp, _t(x), tcfg)
    _close(ty, full[:, -1].numpy(), what="decode vs the block over S + 3")


def test_mamba2_repeats_dt_per_head_not_tiled():
    """``dt.repeat(ph)`` in jnp repeats each head's dt over its ph channels:
    with distinct per-head dt the block differs from a tiled dt, and the
    port matches the reference (ssm_heads 4, ph 128 at the smoke size)."""
    jcfg, tcfg = _configs("zamba2-1.2b")
    p = _block_params("mamba2", jcfg, 21)
    p["dt_bias"] = np.array([-2.0, -0.5, 0.5, 2.0], np.float32)
    x = np.random.default_rng(22).standard_normal((B, 9, jcfg.d_model)).astype(np.float32)
    tp = convert.params_from_numpy(p, "cpu")
    want = jax.jit(jssm.mamba2_block, static_argnums=2)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg)
    _close(tssm.mamba2_block(tp, _t(x), tcfg), want)
    log_a, v = tssm._mamba2_gates(tp, torch.zeros(1, 4), torch.ones(1, 512), 128)
    dt = torch.nn.functional.softplus(tp["dt_bias"])
    assert torch.equal(v.view(4, 128), dt[:, None].expand(4, 128))


def test_bf16_blocks_keep_fp32_states():
    """A bf16 model's activations stay bf16 and its recurrent states fp32
    (the conv tails take the activations' dtype), as the reference's."""
    for name in sorted(BLOCKS):
        arch, init, block = BLOCKS[name][:3]
        _, tcfg = _configs(arch)
        tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
        p = getattr(tssm, init)(rnd.PRNGKey(5, device="cpu"), tcfg, torch.bfloat16)
        x = torch.randn(B, 10, tcfg.d_model, generator=torch.Generator().manual_seed(0))
        out, st = getattr(tssm, block)(p, x.to(torch.bfloat16), tcfg, return_state=True)
        assert out.dtype == torch.bfloat16
        for k, t in _named(st):
            assert t.dtype == (torch.bfloat16 if k == "conv" else torch.float32), (name, k)
        assert torch.isfinite(out.float()).all()
    assert tlayers.take([1, 2], 1) == 2
