"""The port's backward plain versions (``kernels/ref.py``) and the autograd
Functions of the rmsnorm and flash-attention wrappers, on the CPU, against
the JAX reference's custom VJPs: ``repro.models.layers._rms_fused`` (and the
autodiff of ``rmsnorm``) and ``chunked_attention`` (``_cattn``, the
recompute flash backward), with K/V broadcast to the query heads for the
reference and its dk, dv summed over each group.

Tolerances (absolute plus relative): rmsnorm 1e-5 in fp32, 2e-2 in bf16
(the JAX kernel test's); flash 2e-5 in fp32 (another summation order than
the reference's blocked scan); the forward logsumexp 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as trms

EPS = 1e-6


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, tol, what=""):
    got = _np(got) if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _rms_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    sc = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, sc, dy


@pytest.mark.parametrize("shape", [(2, 7, 64), (3, 100), (4, 256)])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_rmsnorm_bwd_ref_matches_jax_vjp(shape, dtype, tol):
    x, sc, dy = _rms_inputs(shape)
    jdt = jnp.dtype(dtype)
    jx, jsc, jdy = (jnp.asarray(a, jdt) for a in (x, sc, dy))
    tdt = getattr(torch, dtype)
    tx, tsc, tdy = (torch.from_numpy(a).to(tdt) for a in (x, sc, dy))
    dx, dscale = ref.rmsnorm_bwd_ref(tx, tsc, tdy, EPS)
    assert dx.dtype == tdt and dscale.dtype == tdt
    fused = jax.vjp(lambda a, s: jlayers._rms_fused(a, s, EPS), jx, jsc)[1](jdy)
    _close(dx, fused[0].astype(jnp.float32), tol, "dx vs _rms_fused")
    _close(dscale, fused[1].astype(jnp.float32), tol, "dscale vs _rms_fused")
    if dtype == "float32":          # the reference's autodiff path is fp32 only
        plain = jax.vjp(lambda a, s: jlayers.rmsnorm({"scale": s}, a, EPS),
                        jx, jsc)[1](jdy)
        _close(dx, plain[0], tol, "dx vs autodiff of rmsnorm")
        _close(dscale, plain[1], tol, "dscale vs autodiff of rmsnorm")


def test_rmsnorm_function_on_cpu_gives_the_plain_gradient():
    x, sc, dy = (torch.from_numpy(a) for a in _rms_inputs((5, 3, 64), 1))
    x.requires_grad_()
    sc.requires_grad_()
    trms.rmsnorm_bwd.launches = 0
    trms.RMSNorm.apply(x, sc, EPS).backward(dy)
    dx, dscale = ref.rmsnorm_bwd_ref(x.detach(), sc.detach(), dy, EPS)
    assert torch.equal(x.grad, dx) and torch.equal(sc.grad, dscale)
    assert trms.rmsnorm_bwd.launches == 0          # the CPU launches nothing


def _attn_inputs(b, h, kv, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, kv, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, kv, sk, d)).astype(np.float32)
    do = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    return q, k, v, do


def _jax_cattn(q, k, v, causal, window, block=16):
    """chunked_attention in the port's (B, H, S, D) layout, K/V broadcast to
    the H query heads, the causal mask right-aligned when Sq < Sk."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    rep = h // kv
    kb = jnp.repeat(jnp.asarray(k), rep, axis=1)
    vb = jnp.repeat(jnp.asarray(v), rep, axis=1)
    q_pos = jnp.arange(sq, dtype=jnp.int32)[None, :] + (sk - sq)
    k_pos = jnp.arange(sk, dtype=jnp.int32)[None, :]

    def f(qq, kk, vv):
        out = jlayers.chunked_attention(
            qq.transpose(0, 2, 1, 3), kk.transpose(0, 2, 1, 3),
            vv.transpose(0, 2, 1, 3), q_pos, k_pos, causal=causal,
            window=window, block=block)
        return out.transpose(0, 2, 1, 3)

    return f, jnp.asarray(q), kb, vb


ATTN_CASES = [  # b, h, kv, sq, sk, d, causal, window
    (2, 4, 2, 16, 16, 32, True, 0),
    (1, 4, 4, 37, 37, 64, True, 0),       # ragged, rep 1
    (2, 8, 1, 24, 24, 32, False, 0),      # rep 8, no mask
    (1, 4, 2, 40, 40, 32, True, 7),       # a window
    (1, 2, 1, 29, 45, 32, True, 0),       # Sq < Sk, right-aligned
    (1, 2, 2, 33, 33, 64, False, 10),     # a window without causality
]


@pytest.mark.parametrize("b,h,kv,sq,sk,d,causal,window", ATTN_CASES)
def test_flash_bwd_ref_matches_cattn_vjp(b, h, kv, sq, sk, d, causal, window):
    q, k, v, do = _attn_inputs(b, h, kv, sq, sk, d)
    f, jq, jk, jv = _jax_cattn(q, k, v, causal, window)
    jo, vjp = jax.vjp(f, jq, jk, jv)
    jdq, jdk, jdv = vjp(jnp.asarray(do))
    rep = h // kv
    jdk = np.asarray(jdk).reshape(b, kv, rep, sk, d).sum(axis=2)
    jdv = np.asarray(jdv).reshape(b, kv, rep, sk, d).sum(axis=2)

    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = ref.flash_attention_fwd_ref(tq, tk, tv, causal=causal,
                                         window=window, return_lse=True)
    _close(o, jo, 2e-5, "forward")
    dq, dk, dv = ref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo,
                                             causal=causal, window=window)
    _close(dq, jdq, 2e-5, "dq")
    _close(dk, jdk, 2e-5, "dk")
    _close(dv, jdv, 2e-5, "dv")


def test_flash_bwd_ref_at_saturated_logits_stays_within_the_rowsum_rounding():
    """Logits up to ~4e4 (q, k of scale 100): each row's softmax is one-hot
    in fp32, and the exact dq, dk are ~1e-35. The reference's softmax VJP
    (autodiff of ``dot_attention``) gives that, its row sum of P·dP
    cancelling exactly. The flash formulation's delta = rowsum(dO·O) does
    not cancel exactly, since O comes from the online softmax: the port's
    dq and dk read up to ~1.5e-4 there, each element within the first-order
    rounding of that delta, scale · max_j |k_jc| · 2(D + 4)·2^-24 ·
    Σ_c |dO_ic|·max_j |v_jc| (dk the same with q and the rows' sums). dv
    and the output stay within 2e-5 of the reference's."""
    b, h, s, d = 1, 2, 24, 16
    rng = np.random.default_rng(0)
    q, k = ((100 * rng.standard_normal((b, h, s, d))).astype(np.float32)
            for _ in range(2))
    v, do = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(2))
    mask = jlayers.make_attention_mask(jnp.arange(s)[None], jnp.arange(s)[None])

    def f(qq, kk, vv):
        return jlayers.dot_attention(*(a.transpose(0, 2, 1, 3) for a in (qq, kk, vv)),
                                     mask, kv_heads_repeat=1).transpose(0, 2, 1, 3)

    jo, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    jdq, jdk, jdv = map(np.asarray, vjp(jnp.asarray(do)))
    assert np.abs(jdq).max() < 1e-30 and np.abs(jdk).max() < 1e-30
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = ref.flash_attention_fwd_ref(tq, tk, tv, return_lse=True)
    dq, dk, dv = ref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo)
    _close(o, jo, 2e-5, "forward")
    _close(dv, jdv, 2e-5, "dv")
    scale, u = d ** -0.5, 2.0 ** -24
    row = 2 * (d + 4) * u * (np.abs(do) @ np.abs(v).max(axis=2, keepdims=True)
                             .transpose(0, 1, 3, 2))          # (b, h, s, 1)
    causal = np.tril(np.ones((s, s), bool))
    dq_bound = scale * row * np.abs(k).max(axis=2, keepdims=True)
    dk_bound = scale * np.einsum("ij,bhic->bhjc", causal, row * np.abs(q))
    assert np.all(np.abs(_np(dq) - jdq) <= dq_bound), "dq"
    assert np.all(np.abs(_np(dk) - jdk) <= dk_bound), "dk"


def test_flash_bwd_ref_gives_zero_for_rows_that_see_no_key():
    """Sq > Sk, causal: the first Sq - Sk rows see no key (lse = -inf); their
    dq is 0 and they add nothing to dk, dv (the backward's counterpart of
    the forward's l == 0 guard)."""
    q, k, v, do = (torch.from_numpy(a) for a in _attn_inputs(1, 4, 2, 24, 8, 32, 2))
    o, lse = ref.flash_attention_fwd_ref(q, k, v, return_lse=True)
    assert torch.isneginf(lse[:, :, :16]).all() and torch.isfinite(lse[:, :, 16:]).all()
    dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, o, lse, do)
    assert torch.isfinite(dq).all() and not dq[:, :, :16].any()
    _, dk2, dv2 = ref.flash_attention_bwd_ref(q[:, :, 16:], k, v, o[:, :, 16:],
                                              lse[:, :, 16:], do[:, :, 16:])
    torch.testing.assert_close(dk, dk2, rtol=0, atol=0)
    torch.testing.assert_close(dv, dv2, rtol=0, atol=0)


@pytest.mark.parametrize("b,h,kv,sq,sk,d,causal,window", ATTN_CASES[:4])
def test_flash_fwd_lse_matches_cattn_fwd_scan(b, h, kv, sq, sk, d, causal, window):
    q, k, v, _ = _attn_inputs(b, h, kv, sq, sk, d, seed=3)
    rep, blk = h // kv, 16
    n = -(-sk // blk)
    pad = n * blk - sk
    kb = np.pad(np.repeat(k, rep, axis=1), ((0, 0), (0, 0), (0, pad), (0, 0)))
    vb = np.pad(np.repeat(v, rep, axis=1), ((0, 0), (0, 0), (0, pad), (0, 0)))
    kb = jnp.asarray(kb.reshape(b, h, n, blk, d).transpose(2, 0, 1, 3, 4))
    vb = jnp.asarray(vb.reshape(b, h, n, blk, d).transpose(2, 0, 1, 3, 4))
    kp = np.pad(np.arange(sk, dtype=np.int32), (0, pad), constant_values=2**30)
    kp = jnp.asarray(kp.reshape(n, 1, blk))
    qp = jnp.asarray(np.arange(sq, dtype=np.int32)[None, :, None] + (sk - sq))
    _, jlse = jlayers._cattn_fwd_scan(jnp.asarray(q), kb, vb, kp, qp,
                                      1.0 / np.sqrt(d), causal, window, 0)
    _, lse = ref.flash_attention_fwd_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                         causal=causal, window=window,
                                         return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    _close(lse, jlse, 2e-5, "lse")


def test_flash_function_on_cpu_gives_the_plain_gradient():
    q, k, v, do = (torch.from_numpy(a) for a in _attn_inputs(2, 4, 2, 19, 19, 32, 4))
    for t in (q, k, v):
        t.requires_grad_()
    tflash.flash_attention_bwd.launches = tflash.flash_attention.launches = 0
    out = tflash.FlashAttention.apply(q, k, v, True, 5)
    out.backward(do)
    o, lse = ref.flash_attention_fwd_ref(q.detach(), k.detach(), v.detach(),
                                         window=5, return_lse=True)
    assert torch.equal(out.detach(), o)
    want = ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), o,
                                       lse, do, window=5)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        assert torch.equal(got, w)
    assert tflash.flash_attention.launches == tflash.flash_attention_bwd.launches == 0


def test_flash_lse_kernel_args_take_the_prefill_kernel():
    """A call that asks for the logsumexp never takes the decode kernel
    (which refuses it): its split count is 0 even at decode shapes, and the
    lse pointer follows the strides."""
    q = torch.zeros(8, 16, 1, 128, dtype=torch.bfloat16)
    k = torch.zeros(8, 2, 543, 128, dtype=torch.bfloat16)
    lse = torch.zeros(8, 16, 1)
    args = tflash.kernel_args(q, k, k, torch.empty_like(q), lse=lse)
    assert args[-1] == 0 and args[5] == lse.data_ptr()
    assert tflash.kernel_args(q, k, k, torch.empty_like(q))[-1] == 9


# The H100's counts of clusters of c dk/dv blocks held at once
# (flash_attention.flash_bwd_capacity, the same at every head dim; PERF.md).
H100_CAPACITY = {2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}


@pytest.mark.parametrize("b,h,kv,sk,want", [
    (8, 16, 2, 512, 2),      # qwen2.5-3b's train shape: 64 pairs of key tiles
    (8, 8, 1, 512, 3),       # paligemma-3b's: rep 8 in 3 chunks
    (8, 32, 4, 512, 1),      # train_moe's: 128 pairs, more than 66 clusters of 2
    (1, 32, 2, 1100, 5),     # glm4-9b-swa's: 18 pairs
    (2, 4, 4, 61, 1),        # rep 1
    (1, 6, 1, 64, 6),        # one key tile, rep 6
])
def test_bwd_chunks_take_the_most_clusters_the_card_holds(b, h, kv, sk, want):
    chunks = tflash.bwd_chunks(b, h, kv, sk, H100_CAPACITY.__getitem__)
    assert chunks == want
    pairs = (-(-sk // 64) + 1) // 2
    rep = h // kv
    assert 1 <= chunks <= min(rep, 8)
    if chunks > 1:
        assert pairs * kv * b <= H100_CAPACITY[chunks]
    for c in range(chunks + 1, min(rep, 8) + 1):
        assert pairs * kv * b > H100_CAPACITY[c]


@pytest.mark.parametrize("sk", [1, 64, 65, 133, 512, 1000])
@pytest.mark.parametrize("rep,chunks", [(1, 1), (8, 2), (8, 3), (6, 4), (7, 7), (8, 8)])
def test_dkdv_work_split_covers_every_key_head_and_row_once(sk, rep, chunks):
    """The dk/dv kernel's index arithmetic: block (pair p, chunk c) walks key
    tiles p and n-1-p (the middle one once) for heads rep·c/C .. rep·(c+1)/C
    - 1; after its tiles, row ρ of the 2·64 partial rows (dK's, then dV's)
    belongs to block ((ρ+1)·C - 1) // 128, whose rows start at r·128 // C.
    Every (key tile, head) pair is walked once, and every row has one owner
    whose receive buffer (C copies of ceil(128 / C) rows) holds it."""
    n_kt = -(-sk // 64)
    pairs = (n_kt + 1) // 2
    seen = []
    for p in range(pairs):
        tiles = [p] if n_kt - 1 - p <= p else [p, n_kt - 1 - p]
        for c in range(chunks):
            for hh in range(rep * c // chunks, rep * (c + 1) // chunks):
                seen += [(t, hh) for t in tiles]
    assert sorted(seen) == [(t, hh) for t in range(n_kt) for hh in range(rep)]
    first = [r * 128 // chunks for r in range(chunks + 1)]
    rows_max = -(-128 // chunks)
    for rho in range(128):
        owner = ((rho + 1) * chunks - 1) // 128
        assert first[owner] <= rho < first[owner + 1]
        assert rho - first[owner] < rows_max


@pytest.mark.parametrize("rows,d,itemsize,aligned,capacity,want", [
    (4096, 2048, 2, True, 45, ("rows", 360, 45)),     # the train shape on an H100
    (4096, 2048, 4, True, 30, ("rows", 240, 30)),     # fp32: 2 vectors a thread
    (37, 512, 2, True, 45, ("rows", 40, 5)),          # at most one block a row
    (0, 2048, 2, True, 45, ("rows", 8, 1)),
    (37, 512, 2, False, 45, ("general", 10, 10)),     # unaligned operands
    (5, 100, 2, True, 45, ("general", 2, 2)),         # not whole 16-byte vectors
    (3, 3000, 4, True, 20, ("rows", 8, 1)),           # 750 vectors: 3 a thread
    (8, 8200, 2, True, 20, ("general", 2, 2)),        # more than 1,024 vectors
    (4096, 2048, 2, True, 0, ("rows", 8, 1)),         # a card without the count: one cluster
])
def test_rmsnorm_bwd_plan(rows, d, itemsize, aligned, capacity, want):
    assert trms.bwd_plan(rows, d, itemsize, aligned, capacity) == want
