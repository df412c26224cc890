"""The port's rmsnorm and flash-attention modules on the CPU: each wrapper's
plain version against the JAX reference's Pallas kernel in interpret mode
and its jnp oracle (kernels/ref.py), on the same numpy inputs.

Tolerances are the JAX kernel tests' (tests/test_kernels.py): rmsnorm 1e-6
in fp32 and 2e-2 in bf16; flash attention 2e-5 in fp32 (the online softmax
sums in another order than the one-shot softmax) and 3e-2 in bf16. The CUDA
kernels themselves are held against these plain versions on the card, by
chip_smoke.py and tests/test_torch_gpu.py.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.rmsnorm import rmsnorm_pallas
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import rmsnorm as trms

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(a, dtype):
    """One numpy fp32 array -> (jax array, torch tensor) in dtype."""
    return jnp.asarray(a).astype(JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", [(4, 128), (3, 7, 256), (1, 1024), (2, 37, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_jax(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    sc = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    jx, tx = _both(x, dtype)
    got = trms.plain(tx, torch.from_numpy(sc))
    assert got.dtype == TDT[dtype] and got.shape == tx.shape
    tol = 1e-6 if dtype == "float32" else 2e-2
    for want in (rmsnorm_pallas(jx, jnp.asarray(sc), interpret=True, block_rows=16),
                 jref.rmsnorm_ref(jx, jnp.asarray(sc))):
        _close(got, want, tol)


def test_rmsnorm_wrapper_on_cpu_is_plain_and_launches_nothing():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((5, 96)).astype(np.float32))
    sc = torch.from_numpy(rng.standard_normal(96).astype(np.float32))
    before = trms.rmsnorm.launches
    assert torch.equal(trms.rmsnorm(x, sc, 1e-5), trms.plain(x, sc, 1e-5))
    assert trms.rmsnorm.launches == before


def _qkv(b, h, kv, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, kv, sk, d)).astype(np.float32),
            rng.standard_normal((b, kv, sk, d)).astype(np.float32))


@pytest.mark.parametrize("b,h,kv,sq,sk,d", [
    (1, 4, 4, 128, 128, 64),       # MHA square
    (2, 8, 2, 128, 128, 64),       # GQA
    (1, 8, 1, 64, 256, 128),       # MQA, right-aligned decode-ish window
    (1, 4, 4, 256, 256, 32),
    (1, 4, 2, 128, 128, 256),      # head dim 256 (gemma-7b, paligemma-3b)
    (1, 8, 1, 64, 192, 256),       # ... MQA, right-aligned
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 96), (False, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas(b, h, kv, sq, sk, d, causal, window, dtype):
    q, k, v = _qkv(b, h, kv, sq, sk, d, seed=sq + sk + d)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    got = tflash.plain(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == TDT[dtype] and got.shape == tq.shape
    tol = 2e-5 if dtype == "float32" else 3e-2
    _close(got, flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                       block_q=64, block_k=64, interpret=True), tol)


@pytest.mark.parametrize("b,h,kv,sq,sk,d", [
    (2, 4, 2, 1, 37, 64),          # one decode row against 37 cache rows
    (2, 4, 2, 61, 61, 64),         # a ragged prompt
    (1, 16, 2, 1, 37, 128),        # GQA rep 8 at decode
    (1, 16, 2, 45, 45, 128),       # GQA rep 8 at prefill
    (1, 16, 2, 7, 50, 32),         # a ragged chunk right-aligned in its keys
])
@pytest.mark.parametrize("window", [0, 20])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_ref_at_ragged_lengths(b, h, kv, sq, sk, d, window,
                                                   dtype):
    q, k, v = _qkv(b, h, kv, sq, sk, d, seed=7 * sq + sk)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    got = tflash.plain(tq, tk, tv, causal=True, window=window)
    want = jref.flash_attention_ref(jq, jk, jv, causal=True, window=window)
    _close(got, want, 2e-5 if dtype == "float32" else 3e-2)


def test_flash_plain_blocks_fully_masked_tiles():
    """tests/test_kernels.py:65's case: a window that masks whole K tiles."""
    q, k, v = _qkv(1, 2, 2, 256, 256, 32, seed=3)
    got = tflash.plain(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                       window=32)
    assert torch.isfinite(got).all()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    for want in (flash_attention_pallas(jq, jk, jv, causal=True, window=32,
                                        block_q=64, block_k=64, interpret=True),
                 jref.flash_attention_ref(jq, jk, jv, causal=True, window=32)):
        _close(got, want, 2e-5)


def test_flash_plain_fully_masked_rows_are_zero_as_in_pallas():
    """Sq > Sk with a right-aligned causal mask: the first Sq-Sk rows see no
    key. The Pallas kernel gives 0 there (l == 0 -> 1); so does the port
    (the reference's jnp oracle gives NaN)."""
    q, k, v = _qkv(1, 4, 2, 128, 64, 64, seed=11)
    got = tflash.plain(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    assert torch.isfinite(got).all()
    assert torch.equal(got[:, :, :64], torch.zeros_like(got[:, :, :64]))
    want = flash_attention_pallas(*(jnp.asarray(a) for a in (q, k, v)),
                                  causal=True, block_q=64, block_k=64,
                                  interpret=True)
    _close(got, want, 2e-5)


def test_flash_wrapper_on_cpu_is_plain_and_takes_views():
    """On the CPU the wrapper is the plain version, also on the strided
    views decode hands it (the first pos+1 rows of a (B, S, KV, D) cache)."""
    rng = np.random.default_rng(4)
    cache = torch.from_numpy(rng.standard_normal((2, 40, 2, 64)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 64)).astype(np.float32))
    kview = cache.permute(0, 2, 1, 3)[:, :, :23]
    before = tflash.flash_attention.launches
    got = tflash.flash_attention(q.transpose(1, 2), kview, kview)
    want = tflash.plain(q.transpose(1, 2).contiguous(), kview.contiguous(),
                        kview.contiguous())
    # einsum over a strided view may sum in another order: 1e-6
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    assert tflash.flash_attention.launches == before


def test_wrappers_refuse_other_devices(monkeypatch):
    """A tensor on neither the CPU, a CUDA device nor the meta device is
    refused; a meta tensor (the dry run's) gets the kernel's empty output,
    never the plain version's."""
    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="unsupported device"):
        trms.rmsnorm(other, other)
    with pytest.raises(ValueError, match="unsupported device"):
        tflash.flash_attention(other, other, other)

    def never(*a, **k):
        raise AssertionError("the plain version ran on the meta device")

    monkeypatch.setattr(trms, "plain", never)
    monkeypatch.setattr(tflash, "plain", never)
    x = torch.zeros(2, 64, device="meta")
    y = trms.rmsnorm(x, torch.zeros(64, device="meta"))
    assert (y.shape, y.device.type) == ((2, 64), "meta")
    q = torch.zeros(1, 2, 4, 32, device="meta")
    o = tflash.flash_attention(q, q, q)
    assert (o.shape, o.device.type) == ((1, 2, 4, 32), "meta")
