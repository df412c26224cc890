"""The bf16 decode kernel's math on the CPU: keys cut into splits, a partial
(m, l, acc) per split, merged with weights exp(m_s - M) where an empty split
weighs 0 (``kernels/ref.py::flash_attention_split_ref``), against the JAX
reference's Pallas kernel in interpret mode and against the port's one-shot
``flash_attention_ref``, on the same numpy inputs; and the wrapper's choice
of path and split count. The CUDA kernel itself is held
against the plain version on the card (tests/test_torch_gpu.py,
chip_smoke.py).

Tolerances: 2e-5 in fp32 (the splits sum in another order than the one-shot
softmax) and 3e-2 in bf16, the JAX kernel tests'.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels.ref import flash_attention_ref, flash_attention_split_ref

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 3e-2}

# b, h, kv, sq, sk, d, window, Pallas block_q, block_k (they must divide)
CASES = {
    "decode_rep8": (2, 16, 2, 1, 543, 128, 0, 1, 181),
    "decode_window20": (2, 16, 2, 1, 543, 128, 20, 1, 181),   # splits see no key
    "decode_rep1_d64": (1, 4, 4, 1, 300, 64, 0, 1, 100),
    "chunk7_d32": (1, 16, 2, 7, 50, 32, 0, 7, 50),
    "rows_see_no_key": (1, 4, 2, 128, 64, 64, 0, 64, 64),
}


def _inputs(name):
    b, h, kv, sq, sk, d = CASES[name][:6]
    rng = np.random.default_rng(sum(CASES[name]))
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, kv, sk, d)).astype(np.float32),
            rng.standard_normal((b, kv, sk, d)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _pallas(name, dtype):
    window, bq, bk = CASES[name][6:]
    q, k, v = (jnp.asarray(a).astype(JDT[dtype]) for a in _inputs(name))
    out = flash_attention_pallas(q, k, v, causal=True, window=window, block_q=bq,
                                 block_k=bk, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("splits", [1, 2, 9, "sk"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_merge_matches_pallas_and_ref(name, splits, dtype):
    sk, window = CASES[name][4], CASES[name][6]
    q, k, v = (torch.from_numpy(a).to(TDT[dtype]) for a in _inputs(name))
    got = flash_attention_split_ref(q, k, v, causal=True, window=window,
                                    splits=sk if splits == "sk" else splits)
    assert got.dtype == TDT[dtype] and got.shape == q.shape
    assert torch.isfinite(got).all()
    _close(got, _pallas(name, dtype), TOL[dtype])
    _close(got, flash_attention_ref(q, k, v, causal=True, window=window).float(),
           TOL[dtype])


@pytest.mark.parametrize("splits", [1, 2, 9, 543])
def test_split_merge_matches_jnp_oracle(splits):
    """Against the JAX package's jnp oracle too, at the serve path's decode
    shape with a window that leaves most splits empty."""
    q, k, v = _inputs("decode_window20")
    got = flash_attention_split_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal=True, window=20, splits=splits)
    want = jref.flash_attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                    causal=True, window=20)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("splits", [1, 2, 9, 64])
def test_split_merge_fully_masked_rows_are_zero(splits):
    """Rows with no visible key in any split give 0, not NaN: every split's
    m is -inf, so every weight is 0 and the merged l is 0."""
    q, k, v = (torch.from_numpy(a) for a in _inputs("rows_see_no_key"))
    got = flash_attention_split_ref(q, k, v, causal=True, splits=splits)
    assert torch.equal(got[:, :, :64], torch.zeros_like(got[:, :, :64]))
    assert got[:, :, 64:].abs().sum() > 0


@pytest.mark.parametrize("dtype,b,h,kv,sq,sk,want", [
    (torch.bfloat16, 8, 16, 2, 1, 543, 9),     # the serve path's decode
    (torch.bfloat16, 1, 16, 2, 1, 37, 1),      # one 64-key tile: no merge
    (torch.bfloat16, 1, 2, 2, 1, 4096, 16),    # few groups: the largest cluster
    (torch.bfloat16, 8, 16, 2, 1, 512, 8),     # one tile a split
    (torch.bfloat16, 8, 16, 2, 1, 8192, 16),   # many tiles a split
    (torch.bfloat16, 1, 4, 2, 8, 100, 2),      # 16 rows per group: still decode
    (torch.bfloat16, 1, 4, 2, 9, 100, 0),      # 18 rows: the tensor-core kernel
    (torch.bfloat16, 8, 16, 2, 512, 512, 0),   # prefill
    (torch.float32, 8, 16, 2, 1, 543, 0),      # fp32 keeps its own kernel
])
def test_decode_splits_picks_the_path(dtype, b, h, kv, sq, sk, want):
    assert tflash.decode_splits(dtype, b, h, kv, sq, sk) == want


def test_kernel_args_pass_the_decode_splits():
    """The C entry's arguments end in the path's split count: 9 at the serve
    path's decode (a 543-row view of a 544-row cache), 0 at prefill."""
    q = torch.zeros(8, 16, 1, 128, dtype=torch.bfloat16)
    k = torch.zeros(8, 544, 2, 128, dtype=torch.bfloat16).transpose(1, 2)[:, :, :543]
    args = tflash.kernel_args(q, k, k, torch.empty_like(q))
    assert args[-1] == 9 and args[-2] == 1
    assert tuple(args[4])[3:6] == (544 * 2 * 128, 128, 2 * 128)
    qp = torch.zeros(2, 16, 64, 128, dtype=torch.bfloat16)
    args = tflash.kernel_args(qp, k[:2, :, :64], k[:2, :, :64], torch.empty_like(qp))
    assert args[-2:] == (1, 0)
