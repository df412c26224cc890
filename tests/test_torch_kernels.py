"""The port's kernel modules on the CPU: each wrapper's plain version
against the JAX reference's oracle (kernels/ref.py) and against its Pallas
kernel run in interpret mode, on the same numpy inputs.

Tolerances are the JAX kernel tests' (tests/test_kernels.py): ssca_update
1e-5 in fp32 and 2e-2 in bf16 (one bf16 ulp at |w| ~ 4); the quantizer is
bit-exact (assert_array_equal) on the same random bits. The CUDA kernels
themselves are held against these plain versions on the card, by
chip_smoke.py and tests/test_torch_gpu.py.
"""
import ctypes
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.quantize import stochastic_quantize_pallas
from repro.kernels.ssca_update import ssca_update_pallas
from repro_torch.kernels import build, quantize, ssca_update
from repro_torch.kernels import ref as tref

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _ssca_inputs(n, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


@pytest.mark.parametrize("n", [17, 1000, 4096, 70000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssca_update_plain_matches_jax(n, dtype):
    w, buf, g = _ssca_inputs(n)
    rho, gamma, tau, lam = 0.7, 0.25, 0.2, 1e-4
    jw, jb = jnp.asarray(w).astype(JDT[dtype]), jnp.asarray(buf)
    jg = jnp.asarray(g).astype(JDT[dtype])
    tw = torch.from_numpy(w).to(TDT[dtype])
    tg = torch.from_numpy(g).to(TDT[dtype])
    got_w, got_b = ssca_update.plain(tw, torch.from_numpy(buf), tg, rho,
                                     gamma, tau, lam)
    assert got_w.dtype == TDT[dtype] and got_b.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 2e-2
    for want_w, want_b in (
            jref.ssca_update_ref(jw, jb, jg, rho, gamma, tau, lam),
            ssca_update_pallas(jw, jb, jg, rho, gamma, tau, lam, block=8192,
                               interpret=True)):
        np.testing.assert_allclose(got_w.float().numpy(),
                                   np.asarray(want_w, np.float32),
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b),
                                   rtol=1e-5, atol=1e-5)


def test_ssca_update_wrapper_on_cpu_is_in_place_plain():
    w, buf, g = (torch.from_numpy(a) for a in _ssca_inputs(300, seed=3))
    want_w, want_b = ssca_update.plain(w, buf, g, 0.4, 0.1, 0.05, 1e-5)
    before = ssca_update.ssca_update_.launches
    out_w, out_b = ssca_update.ssca_update_(w, buf, g, torch.tensor(0.4),
                                            torch.tensor(0.1), 0.05, 1e-5)
    assert out_w is w and out_b is buf
    assert torch.equal(w, want_w) and torch.equal(buf, want_b)
    assert ssca_update.ssca_update_.launches == before   # no kernel on CPU


def test_ssca_update_refuses_schedules_it_would_have_to_convert():
    """ρ/γ are floats or 0-d fp32 tensors on w's device; the wrapper never
    converts another dtype, device or shape (on the card it hands the
    kernel their data pointers)."""
    w, buf, g = (torch.from_numpy(a) for a in _ssca_inputs(64, seed=4))
    for rho, err in ((torch.tensor(0.5, dtype=torch.float64), TypeError),
                     (torch.tensor(0.5, device="meta"), ValueError),
                     (torch.tensor([0.5]), ValueError), ("0.5", TypeError)):
        with pytest.raises(err, match="rho"):
            ssca_update.ssca_update_(w, buf, g, rho, 0.1, 0.05, 1e-5)
    with pytest.raises(TypeError, match="gamma"):
        ssca_update.ssca_update_(w, buf, g, 0.5, torch.tensor(0.1).half(),
                                 0.05, 1e-5)


def _covered(lay, n):
    """How often the kernel's indexing (csrc/ssca_update.cu) touches each of
    [0, n) under layout ``lay``: vector v = (pass·blocks + block)·THREADS +
    thread of each pass, then the scalar tail in block 0."""
    nvec = lay.tail_start // lay.vec
    threads = ssca_update.THREADS
    passes = max(1, -(-nvec // (lay.blocks * threads)))
    v = ((np.arange(passes)[:, None, None] * lay.blocks
          + np.arange(lay.blocks)[None, :, None]) * threads
         + np.arange(threads)[None, None, :]).ravel()
    v = v[v < nvec]
    body = (v[:, None] * lay.vec + np.arange(lay.vec)).ravel()
    tail = lay.tail_start + np.arange(min(threads, n - lay.tail_start))
    return np.bincount(np.concatenate([body, tail]), minlength=n)


@pytest.mark.parametrize("sizes", [range(1, 1101), [101_632], [2**20 + 3]],
                         ids=["1-1100", "101632", "2^20+3"])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssca_layout_covers_every_element_once(dtype, aligned, sizes):
    """For n = 1..1100, the main path's 101,632 and 2^20+3 (grid-strided),
    16-byte vectors with a scalar tail, or scalars when unaligned."""
    want_vec = 16 // dtype.itemsize if aligned else 1
    for n in sizes:
        lay = ssca_update.launch_layout(n, dtype, aligned, sms=132)
        assert lay.vec == want_vec and 0 <= n - lay.tail_start < lay.vec
        assert lay.tail_start % lay.vec == 0 and lay.blocks >= 1
        counts = _covered(lay, n)
        assert counts.shape == (n,) and (counts == 1).all(), n


def test_ssca_layout_picks_vectors_from_the_pointers():
    """Operands at an offset of one element are not 16-byte aligned and go
    through the scalar path; the main path's layout is one wave of 132 SMs
    and one pass over its 25,408 float4 vectors."""
    flat = torch.zeros(101_632 + 4)
    w, buf, g = flat[:101_632], torch.zeros(101_632), torch.zeros(101_632)
    lay = ssca_update.layout_for(w, buf, g, sms=132)
    assert lay.vec == 4 and lay.tail_start == 101_632
    assert lay.blocks <= 132 * (ssca_update.THREADS_PER_SM // ssca_update.THREADS)
    assert lay.blocks * ssca_update.THREADS * lay.vec >= 101_632
    assert ssca_update.layout_for(flat[1:101_633], buf, g, sms=132).vec == 1
    assert ssca_update.layout_for(w, buf, flat[1:101_633], sms=132).vec == 1
    bf = torch.zeros(20, dtype=torch.bfloat16)
    assert ssca_update.layout_for(bf[:19], torch.zeros(19), bf[:19]).vec == 8


def _fma(a, b, c):
    """fp32 fused multiply-add: exact in float64 for fp32 a·b, one rounding
    to fp32 (a second, float64 rounding of the sum is below fp32's ulp
    except in rare ties)."""
    return (a.double() * b.double() + c.double()).float()


def test_ssca_kernel_operation_order_within_tolerance():
    """The kernel's arithmetic, in its order (two FMAs, two multiplies,
    −γ/(2τ) formed once), against the plain version at 2^20+3 elements:
    within 1e-5 in fp32 and on buf, 2e-2 in bf16 (absolute plus relative),
    as the source header says."""
    n = 2**20 + 3
    rng = np.random.default_rng(6)
    w, buf, g = (torch.from_numpy(rng.standard_normal(n).astype(np.float32))
                 for _ in range(3))
    rho, gamma, tau, lam = (torch.tensor(v) for v in (0.7, 0.25, 0.2, 1e-4))
    c, step = 2 * lam - 2 * tau, -gamma / (2 * tau)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        wd, gd = w.to(dtype).float(), g.to(dtype).float()
        nb = _fma(1 - rho, buf, rho * _fma(c, wd, gd))
        nw = _fma(1 - gamma, wd, step * nb).to(dtype)
        want_w, want_b = ssca_update.plain(w.to(dtype), buf, g.to(dtype), rho,
                                           gamma, 0.2, 1e-4)
        torch.testing.assert_close(nw.float(), want_w.float(), atol=tol,
                                   rtol=tol)
        torch.testing.assert_close(nb, want_b, atol=1e-5, rtol=1e-5)


def _quant_inputs(rows, n, seed=5):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, n)) * 3.0).astype(np.float32)
    x[0, : min(n, 300)] = 0.0                 # an all-zero (or short) chunk
    chunks = -(-n // 256)
    bits = rng.integers(0, 2**32, (rows, chunks * 256), dtype=np.uint64)
    return x, bits.astype(np.uint32)


def _int32_pattern(bits_u32):
    return torch.from_numpy(bits_u32.view(np.int32).copy())


@pytest.mark.parametrize("n", [17, 1000, 4096, 70000])
@pytest.mark.parametrize("qmax", [127, 7])
def test_quantize_plain_bit_equal_to_jax(n, qmax):
    x, bits = _quant_inputs(1, n)
    got = quantize.plain(torch.from_numpy(x[0]), _int32_pattern(bits[0]), qmax)
    jx, jb = jnp.asarray(x[0]), jnp.asarray(bits[0])
    for want in (jref.stochastic_quantize_ref(jx, jb, qmax, 256),
                 stochastic_quantize_pallas(jx, qmax, 256, bits=jb,
                                            block_rows=8, interpret=True)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[0].dtype == torch.int8 and got[1].dtype == torch.float32


@pytest.mark.parametrize("rows,n", [(4, 1000), (10, 2560), (3, 17)])
def test_quantize_stacked_bit_equal_to_jax_rows(rows, n):
    """The stacked (I, P) form equals the reference applied row by row, and
    the wrapper on CPU tensors is the plain version."""
    x, bits = _quant_inputs(rows, n, seed=rows)
    got = quantize.stochastic_quantize(torch.from_numpy(x),
                                       _int32_pattern(bits), 127)
    assert got[0].shape == (rows, -(-n // 256) * 256)
    assert got[1].shape == (rows, -(-n // 256)) and got[2].shape == (rows, n)
    for r in range(rows):
        want = jref.stochastic_quantize_ref(jnp.asarray(x[r]),
                                            jnp.asarray(bits[r]), 127, 256)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a[r].numpy(), np.asarray(b))
    # int64 bits (the raw threefry values) give the same result
    again = tref.stochastic_quantize_ref(torch.from_numpy(x),
                                         torch.from_numpy(bits.astype(np.int64)),
                                         127)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("chunk", [1, 100, 2048])
@pytest.mark.parametrize("name", ["int8", "int4"])
def test_codec_any_chunk_bit_equal_to_the_reference_wire(chunk, name):
    """``make_codec(name, chunk=)`` in both packages, 3 clients of 2,500
    (a ragged last chunk at 100 and 2,048) on the same keys: the port's
    keyed quantize gives the reference codec's wire values, scales and
    decoded uploads bit for bit; its bits-operand entry (the plain version
    on the CPU) gives the reference's oracle on the same bits."""
    import jax
    from repro.comm import codecs as jcodecs
    from repro_torch import convert
    from repro_torch.comm import codecs as tcodecs
    rng = np.random.default_rng(chunk)
    x = (rng.standard_normal((3, 2500)) * 3.0).astype(np.float32)
    x[0, :150] = 0.0
    jkeys = jax.random.split(jax.random.PRNGKey(chunk), 3)
    tkeys = convert.key_from_numpy(np.asarray(jkeys), "cpu")
    jc, tc = jcodecs.make_codec(name, chunk=chunk), tcodecs.make_codec(name, chunk=chunk)
    tenc, txhat = tc.roundtrip(torch.from_numpy(x), tkeys)
    for r in range(3):
        jenc, jxhat = jc.roundtrip(jnp.asarray(x[r]), jkeys[r])
        np.testing.assert_array_equal(tenc.values[r].numpy(), np.asarray(jenc.values))
        np.testing.assert_array_equal(tenc.scales[r].numpy(), np.asarray(jenc.scales))
        np.testing.assert_array_equal(txhat[r].numpy(), np.asarray(jxhat))
    bits = rng.integers(0, 2**32, (3, -(-2500 // chunk) * chunk),
                        dtype=np.uint64).astype(np.uint32)
    got = quantize.stochastic_quantize(torch.from_numpy(x), _int32_pattern(bits),
                                       tc.qmax, chunk)
    for r in range(3):
        want = jref.stochastic_quantize_ref(jnp.asarray(x[r]), jnp.asarray(bits[r]),
                                            tc.qmax, chunk)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a[r].numpy(), np.asarray(b))


@pytest.mark.parametrize("chunk", [1, 100, 256, 2048])
def test_meta_quantize_and_dp_noise_take_any_chunk_and_row_count(chunk):
    """The wrappers' meta branch (the dry run's): 70,000 rows, past the
    grid's y limit, at any chunk: outputs of the kernel's shapes."""
    from repro_torch.kernels import dp_noise
    rows, p = 70_000, 300
    x = torch.empty(rows, p, device="meta")
    c = -(-p // chunk)
    bits = torch.empty(rows, c * chunk, dtype=torch.int32, device="meta")
    keys = torch.empty(rows, 2, dtype=torch.int64, device="meta")
    for v, s, xhat in (quantize.stochastic_quantize(x, bits, 127, chunk),
                       quantize.stochastic_quantize_keyed(x, keys, 127, chunk)):
        assert (v.shape, s.shape, xhat.shape) == ((rows, c * chunk), (rows, c), (rows, p))
        assert v.dtype == torch.int8 and v.device.type == "meta"
    f = torch.empty(rows, device="meta")
    out, sq = dp_noise.dp_noise(x, keys, f, f, 1.0)
    assert out.shape == (rows, p) and sq.shape == (rows,)


def test_wrappers_refuse_other_devices(monkeypatch):
    """A tensor on neither the CPU, a CUDA device nor the meta device is
    refused, never computed with the plain version; a meta tensor (the dry
    run's) gets the kernel's empty outputs, never the plain version's."""
    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="unsupported device"):
        ssca_update.ssca_update_(other, other, other, 0.5, 0.5, 0.1, 0.0)
    with pytest.raises(ValueError, match="unsupported device"):
        quantize.stochastic_quantize(other, other, 127)

    def never(*a, **k):
        raise AssertionError("the plain version ran on the meta device")

    monkeypatch.setattr(ssca_update, "plain", never)
    monkeypatch.setattr(quantize, "plain", never)
    w = torch.zeros(8, device="meta")
    assert ssca_update.ssca_update_(w, w, w, 0.5, 0.5, 0.1, 0.0) == (w, w)
    v, s, xhat = quantize.stochastic_quantize(
        torch.zeros(2, 8, device="meta"),
        torch.zeros(2, 256, dtype=torch.int32, device="meta"), 127)
    assert (v.shape, s.shape, xhat.shape) == ((2, 256), (2, 1), (2, 8))
    assert v.device.type == "meta" and v.dtype == torch.int8


def test_build_bindings_pass_pointers_as_void_p():
    """Every C entry returns an int error code; every pointer argument (and
    the stream) is c_void_p so ctypes never truncates it to 32 bits; the
    nvcc flags target sm_90a and never include --use_fast_math."""
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert not any("fast_math" in f for f in build.NVCC_FLAGS)
    for name, entries in build.SIGNATURES.items():
        assert (build.CSRC / f"{name}.cu").exists()
        src = (build.CSRC / f"{name}.cu").read_text()
        for entry, argtypes in entries.items():
            assert f'extern "C" int {entry}(' in src
            assert argtypes[-1] is ctypes.c_void_p          # the stream
            assert "cudaGetLastError" in src
        assert build._target(name).name.startswith(f"lib{name}-")
