"""The port's CUDA kernels on the card (marker ``gpu``): built with nvcc for
sm_90a at first use, launched through their wrappers and held against their
plain versions on the same CUDA tensors. Without a CUDA device every test
here skips. This file imports no jax, so it also runs on a machine that has
only PyTorch:

    python -m pytest tests/test_torch_gpu.py -m gpu -q

Tolerances: ssca_update 1e-5 in fp32 and 2e-2 in bf16 (the kernel's FMAs
round once where the plain version rounds twice); the quantizer is bit-exact;
rmsnorm 1e-5 in fp32 (another summation order, CUDA's 2-ulp rsqrtf) and
2e-2 in bf16; flash attention 2e-5 in fp32 and 3e-2 in bf16, the JAX
kernel tests' (the online softmax sums in another order). The backward
kernels are held to the same tolerances; rmsnorm's dscale, a sum over 4096
rows whose terms cancel, to them relative to the sum of its terms'
magnitudes in fp32, since the kernel sums in another order than the plain
version. The cohort draw is bit-exact, and the cohort engine on the card
is held to the CPU at 1e-4 on the params (fp32 sums in another order),
with the drawn ids equal. The keyed quantize entry is bit-equal to the
bits-operand entry fed ``random.bits`` of the same keys, at every offset;
the DP-noise kernel is held to its plain version on the card at 1e-6
relative plus σ·2e-6 absolute (erfinvf against torch.erfinv: a few ulps),
its noise norm at rtol 1e-5.
"""
import pytest
import torch

from repro_torch import random as rnd
from repro_torch.comm import codecs
from repro_torch.configs.base import FLConfig
from repro_torch import convert
from repro_torch.core import algorithms, baselines, fed, optimizer, surrogate
from repro_torch.data.synthetic import classification_dataset
from repro_torch.core import privacy
from repro_torch.kernels import (cohort_sample, dp_noise, flash_attention,
                                 quantize, rmsnorm, ssca_update)
from repro_torch.kernels.ref import _visible
from repro_torch.launch import serve
from repro_torch.launch import train
from repro_torch.models import mlp

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# every ragged end of the 16-byte vectors (4 fp32, 8 bf16), the main paths'
# 576 (cohort), 50,816 (heterogeneous grid) and 101,632, and a grid-strided
# 2^20+3
SSCA_SIZES = [1, 3, 4, 7, 8, 9, 17, 576, 1000, 4096, 50_816, 70000, 101_632,
              2**20 + 3]


def _ssca_operands(cuda, n, dtype, offset, seed):
    """w, buf, grad at an element offset into larger buffers (offset 1: not
    16-byte aligned, the kernel's scalar path), and ρ, γ as entry 3 of (6,)
    schedule arrays whose entries all differ (as run_rounds passes them)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def draw(dt):
        return torch.randn(n + offset, generator=gen, device=cuda).to(dt)[offset:]

    rho = torch.linspace(0.5, 0.9, 6, device=cuda)
    gamma = torch.linspace(0.1, 0.35, 6, device=cuda)
    return draw(dtype), draw(torch.float32), draw(dtype), rho[3], gamma[3]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", SSCA_SIZES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssca_update_kernel_matches_plain(cuda, n, dtype, offset):
    w, buf, g, rho, gamma = _ssca_operands(cuda, n, dtype, offset, n + offset)
    assert (w.data_ptr() % 16 == 0) == (offset == 0)
    want_w, want_b = ssca_update.plain(w, buf, g, rho, gamma, 0.2, 1e-4)
    before = ssca_update.ssca_update_.launches
    got_w, got_b = ssca_update.ssca_update_(w, buf, g, rho, gamma, 0.2, 1e-4)
    torch.cuda.synchronize()
    assert got_w is w and ssca_update.ssca_update_.launches == before + 1
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got_w.float(), want_w.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(got_b, want_b, atol=1e-5, rtol=1e-5)


def test_ssca_update_is_one_kernel_per_call(cuda):
    """With ρ/γ 0-d fp32 views on the card, a call launches the kernel and
    nothing else (the profiler's CUDA events: no copy, no stack)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    w, buf, g, rho, gamma = _ssca_operands(cuda, 101_632, torch.float32, 0, 1)
    ssca_update.ssca_update_(w, buf, g, rho, gamma, 0.05, 1e-5)   # builds
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ssca_update.ssca_update_(w, buf, g, rho, gamma, 0.05, 1e-5)
        torch.cuda.synchronize()
    device = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(device) == 1 and "ssca_update_kernel" in device[0], device


def test_ssca_update_refuses_other_schedule_dtypes_and_devices(cuda):
    w, buf, g, rho, gamma = _ssca_operands(cuda, 1000, torch.float32, 0, 2)
    with pytest.raises(TypeError, match="rho"):
        ssca_update.ssca_update_(w, buf, g, rho.double(), gamma, 0.2, 1e-4)
    with pytest.raises(ValueError, match="rho"):
        ssca_update.ssca_update_(w, buf, g, rho.cpu(), gamma, 0.2, 1e-4)
    with pytest.raises(ValueError, match="gamma"):
        ssca_update.ssca_update_(w, buf, g, rho, gamma.cpu(), 0.2, 1e-4)


@pytest.mark.parametrize("rows,p", [(1, 17), (3, 1000), (2, 70000), (10, 101_632)])
@pytest.mark.parametrize("qmax", [127, 7])
def test_quantize_kernel_bit_exact(cuda, rows, p, qmax):
    gen = torch.Generator(device=cuda).manual_seed(p + qmax)
    x = torch.randn(rows, p, generator=gen, device=cuda) * 3.0
    x[:, :min(p, 256)] = 0.0
    bits = torch.randint(-2**31, 2**31, (rows, -(-p // 256) * 256),
                         generator=gen, device=cuda, dtype=torch.int64).to(torch.int32)
    want = quantize.plain(x, bits, qmax)
    got = quantize.stochastic_quantize(x, bits, qmax)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_quantize_kernel_rejects_bad_operands(cuda):
    x = torch.zeros(2, 300, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        quantize.stochastic_quantize(x, torch.zeros(2, 512, dtype=torch.int64,
                                                    device=cuda), 127)
    with pytest.raises(ValueError, match="bits per row"):
        quantize.stochastic_quantize(x, torch.zeros(2, 256, dtype=torch.int32,
                                                    device=cuda), 127)


def test_codec_roundtrip_is_one_launch_for_all_clients(cuda):
    """One launch of the keyed quantize kernel for all clients (the codecs
    draw their bits in the kernel); the bits-operand entry is not used."""
    keys = fed.client_keys(rnd.PRNGKey(3, device=cuda), torch.arange(10, device=cuda))
    x = torch.randn(10, 5000, device=cuda)
    before = (quantize.stochastic_quantize_keyed.launches,
              quantize.stochastic_quantize.launches)
    enc, xhat = codecs.make_codec("int8").roundtrip(x, keys)
    assert (quantize.stochastic_quantize_keyed.launches,
            quantize.stochastic_quantize.launches) == (before[0] + 1, before[1])
    enc_cpu, xhat_cpu = codecs.make_codec("int8").roundtrip(x.cpu(), keys.cpu())
    assert torch.equal(enc.values.cpu(), enc_cpu.values)
    assert torch.equal(xhat.cpu(), xhat_cpu)


@pytest.mark.parametrize("rows,p,offset", [(1, 17, 0), (3, 1000, 0),
                                           (10, 101_632, 0), (256, 576, 0),
                                           (256, 6, 0), (1, 70_000, 512),
                                           (2, 4096, 2**32 - 1024)])
@pytest.mark.parametrize("qmax", [127, 7])
def test_keyed_quantize_is_the_bits_operand_kernel(cuda, rows, p, offset, qmax):
    """Keyed on the card == the bits-operand kernel on random.bits of the
    same keys at the same counters == the CPU's plain version, bit for bit
    (an offset past 2^32 exercises the counter's high word)."""
    gen = torch.Generator(device=cuda).manual_seed(p + qmax)
    x = torch.randn(rows, p, generator=gen, device=cuda) * 3.0
    x[0, :min(p, 5)] = 0.0
    keys = rnd.split(rnd.PRNGKey(p, device=cuda), rows)
    num = -(-p // 256) * 256
    b = rnd._bits_range(keys, offset, num)
    bits = (b - ((b >> 31) << 32)).to(torch.int32)
    want = quantize.stochastic_quantize(x, bits, qmax)
    got = quantize.stochastic_quantize_keyed(x, keys, qmax, 256, offset)
    cpu = quantize.stochastic_quantize_keyed(x.cpu(), keys.cpu(), qmax, 256,
                                             offset)
    torch.cuda.synchronize()
    for a, w, c in zip(got, want, cpu):
        assert a.dtype == w.dtype and torch.equal(a, w) and torch.equal(a.cpu(), c)


def test_keyed_quantize_rejects_bad_operands(cuda):
    x = torch.zeros(2, 300, device=cuda)
    keys = rnd.split(rnd.PRNGKey(0, device=cuda), 2)
    with pytest.raises(TypeError, match="key"):
        quantize.stochastic_quantize_keyed(x, keys[:1], 127)
    with pytest.raises(ValueError, match="offset"):
        quantize.stochastic_quantize_keyed(x, keys, 127, 256, 100)
    with pytest.raises(ValueError, match="keys on"):
        quantize.stochastic_quantize_keyed(x, keys.cpu(), 127)


@pytest.mark.parametrize("rows,n,offset", [(1, 1, 0), (1, 2049, 0),
                                           (10, 101_632, 0), (256, 576, 0),
                                           (1, 1 << 20, 1 << 25),
                                           (3, 5000, 2**32 - 256)])
def test_dp_noise_kernel_matches_plain(cuda, rows, n, offset):
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(rows, n, generator=gen, device=cuda)
    keys = rnd.split(rnd.PRNGKey(n, device=cuda), rows)
    f = torch.rand(rows, generator=gen, device=cuda)
    s = 1.0 / torch.randint(1, 40, (rows,), generator=gen, device=cuda).float()
    sigma = 0.7
    got, sq = dp_noise.dp_noise(x, keys, f, s, sigma, offset)
    want, wsq = dp_noise.plain(x, keys, f, s, sigma, offset)
    err = (got - want).abs()
    tol = 1e-6 * want.abs() + sigma * 2e-6 / s[:, None]
    assert bool((err <= tol).all()), err.max().item()
    torch.testing.assert_close(sq, wsq, rtol=1e-5, atol=0)
    again, _ = dp_noise.dp_noise(x, keys, f, s, sigma, offset)
    assert torch.equal(again, got)
    inplace = x.clone()
    res, sq2 = dp_noise.dp_noise(inplace, keys, f, s, sigma, offset, out=inplace)
    assert res.data_ptr() == inplace.data_ptr() and torch.equal(inplace, got)
    assert torch.equal(sq2, sq)


def test_dp_noise_kernel_normals_are_standard(cuda):
    """x = 0, s = f = σ = 1: the output is the normals themselves; mean and
    variance within 5σ of 0 and 1 over 2^24 draws."""
    n = 1 << 24
    x = torch.zeros(1, n, device=cuda)
    one = torch.ones(1, device=cuda)
    z, sq = dp_noise.dp_noise(x, rnd.PRNGKey(5, device=cuda)[None], one, one, 1.0)
    assert abs(z.mean().item()) <= 5 / n ** 0.5
    assert abs(z.var().item() - 1.0) <= 5 * (2 / n) ** 0.5
    assert abs(sq.item() / n - 1.0) <= 5 * (2 / n) ** 0.5


def test_dp_noise_rejects_bad_operands(cuda):
    x = torch.zeros(2, 300, device=cuda)
    keys = rnd.split(rnd.PRNGKey(0, device=cuda), 2)
    f = torch.ones(2, device=cuda)
    with pytest.raises(TypeError, match="factor"):
        dp_noise.dp_noise(x, keys, f.double(), f, 1.0)
    with pytest.raises(TypeError, match="keys"):
        dp_noise.dp_noise(x, keys[:1], f, f, 1.0)
    with pytest.raises(TypeError, match="float32"):
        dp_noise.dp_noise(x.double(), keys, f, f, 1.0)


def test_clip_and_noise_card_matches_cpu(cuda):
    x = torch.randn(6, 3000, device=cuda) * 0.1
    keys = rnd.split(rnd.PRNGKey(2, device=cuda), 6)
    dp = privacy.DPConfig(epsilon=8.0, clip_norm=1.0)
    s = torch.full((6,), 0.25, device=cuda)
    got, st = privacy.clip_and_noise(x, keys, dp, s)
    want, wst = privacy.clip_and_noise(x.cpu(), keys.cpu(), dp, s.cpu())
    sigma = privacy.sigma_of(dp)
    assert (got.cpu() - want).abs().max().item() <= 1e-5 + sigma * 2e-6 * 4
    assert torch.equal(st["clipped"].cpu(), wst["clipped"])
    torch.testing.assert_close(st["noise_sq"].cpu(), wst["noise_sq"], rtol=1e-5,
                               atol=0)


def test_train_comm_smoke_card_matches_cpu_and_counts_launches(cuda, monkeypatch):
    """Three steps of the smoke model with int8 uploads and DP (ε = 8) in
    pieces of 2^18 elements, on the card and on the CPU: losses rtol 1e-3
    (a rounding decision may move by one level), the DP metrics rtol 1e-5;
    per step one dp_noise and one keyed quantize launch a piece."""
    steps, piece = 3, 1 << 18
    monkeypatch.setattr(train, "COMM_PIECE", piece)
    dp = privacy.DPConfig(epsilon=8.0)
    before = (dp_noise.dp_noise.launches,
              quantize.stochastic_quantize_keyed.launches)
    state, card = train.train_loop("qwen2.5-3b", steps, 2, 64, smoke=True,
                                   log_every=1, device=cuda, codec="int8", dp=dp)
    pieces = -(-state.ef.numel() // piece)
    assert (dp_noise.dp_noise.launches - before[0],
            quantize.stochastic_quantize_keyed.launches - before[1]) == (
                steps * pieces, steps * pieces)
    _, cpu = train.train_loop("qwen2.5-3b", steps, 2, 64, smoke=True, log_every=1,
                              device="cpu", codec="int8", dp=dp)
    for a, b0 in zip(card, cpu):
        assert abs(a["loss"] - b0["loss"]) <= 1e-3 * abs(b0["loss"])
        for k in ("dp_epsilon", "dp_clip_frac", "dp_noise_norm"):
            assert abs(a[k] - b0[k]) <= 1e-5 * abs(b0[k]), k


def test_algorithm1_card_matches_cpu(cuda):
    """A few rounds at a small width on the card and on the CPU from the
    same params, data and keys (fp32 sums in another order: atol 1e-5)."""
    (z, y, _), _ = classification_dataset(rnd.PRNGKey(0, device=cuda), n=400,
                                          num_features=32, test_n=10)
    data = fed.partition_samples(z, y, 4)
    p0 = mlp.init(rnd.PRNGKey(1, device=cuda), 32, 16, 10)
    fl = FLConfig(num_clients=4, batch_size=20, a1=0.3, a2=0.3, tau=0.05)
    for name in (None, "int8"):
        before = ssca_update.ssca_update_.launches
        card = algorithms.algorithm1(mlp.per_sample_loss, p0, data, fl, rounds=6,
                                     key=rnd.PRNGKey(2, device=cuda),
                                     codec=codecs.make_codec(name))
        assert ssca_update.ssca_update_.launches == before + 6
        cpu = algorithms.algorithm1(mlp.per_sample_loss,
                                    {k: v.cpu() for k, v in p0.items()},
                                    data.to("cpu"), fl, rounds=6,
                                    key=rnd.PRNGKey(2, device="cpu"),
                                    codec=codecs.make_codec(name), device="cpu")
        torch.testing.assert_close(card.history["round_loss_est"].cpu(),
                                   cpu.history["round_loss_est"], atol=1e-5, rtol=1e-4)
        if name is None:
            for k in card.params:
                torch.testing.assert_close(card.params[k].cpu(), cpu.params[k],
                                           atol=1e-5, rtol=1e-5)


# then every rows x width of the one-pass kernel (a multiple of 16 bytes, up
# to 16 vectors a lane) and the general one (d = 100 in bf16, 4096 in fp32),
# at one row, decode's 8, a ragged 37 and prefill's 4096 (4 rows a block)
RMS_SHAPES = [(4, 128), (3, 7, 256), (2, 37, 512), (5, 100), (3, 3000), (8, 2048),
              (4096, 2048)]
RMS_SHAPES += [(r, d) for r in (1, 8, 37, 4096) for d in (100, 512, 2048, 3000, 4096)
               if (r, d) not in RMS_SHAPES]


@pytest.mark.parametrize("shape", RMS_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype):
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    sc = (torch.randn(shape[-1], generator=gen, device=cuda) * 0.1).to(dtype)
    before = rmsnorm.rmsnorm.launches
    got = rmsnorm.rmsnorm(x, sc, 1e-6)
    torch.cuda.synchronize()
    assert rmsnorm.rmsnorm.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), rmsnorm.plain(x, sc, 1e-6).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_takes_unaligned_rows(cuda, dtype):
    """A contiguous x that starts 2 or 4 bytes past a 16-byte boundary takes
    the general kernel, with the same result."""
    rows, d = 37, 512
    flat = torch.randn(rows * d + 1, device=cuda).to(dtype)
    x = flat[1:].view(rows, d)
    assert x.data_ptr() % 16
    sc = (torch.randn(d, device=cuda) * 0.1).to(dtype)
    got = rmsnorm.rmsnorm(x, sc, 1e-6)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), rmsnorm.plain(x, sc, 1e-6).float(),
                               atol=tol, rtol=tol)


def test_rmsnorm_kernel_rejects_bad_operands(cuda):
    x = torch.randn(37, 512, device=cuda).to(torch.bfloat16)
    with pytest.raises(TypeError, match="dtype"):
        rmsnorm.rmsnorm(x, torch.zeros(512, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm.rmsnorm(x.T, torch.zeros(37, device=cuda, dtype=x.dtype))


def _attn_inputs(cuda, b, h, kv, sq, sk, d, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=cuda).to(dtype)
            for shape in ((b, h, sq, d), (b, kv, sk, d), (b, kv, sk, d))]


@pytest.mark.parametrize("b,h,kv,sq,sk,d", [
    (1, 4, 4, 128, 128, 64),       # tests/test_kernels.py's cases
    (2, 8, 2, 128, 128, 64),
    (1, 8, 1, 64, 256, 128),
    (1, 4, 4, 256, 256, 32),
    (2, 4, 2, 1, 37, 64),          # ragged: decode against 37 rows
    (2, 4, 2, 61, 61, 64),         # ragged prompt
    (1, 16, 2, 1, 37, 128),        # GQA rep 8 at decode
    (2, 16, 2, 45, 45, 128),       # GQA rep 8 at prefill
    (1, 16, 2, 7, 50, 128),        # short query right-aligned in its keys
    (2, 16, 2, 512, 512, 128),     # the serve path's prefill, batch cut to 2
    (1, 32, 2, 1, 543, 128),       # glm4-9b: GQA rep 16 at decode
    (2, 32, 2, 61, 61, 128),       # GQA rep 16 at prefill
    (2, 32, 2, 512, 512, 128),     # glm4-9b's serve prefill, batch cut to 2
    (2, 32, 4, 1, 65, 128),        # qwen3-moe: 32 heads over 4 at decode
    (2, 32, 4, 61, 61, 128),       # and at prefill
    (2, 16, 16, 2048, 2048, 64),   # seamless-m4t's encoder (frames), batch cut to 2
    (2, 16, 16, 512, 2048, 64),    # its cross-attention at prefill: Sq != Sk
    (2, 16, 16, 1, 2048, 64),      # and at decode
    (2, 16, 16, 61, 244, 64),      # ragged cross-attention (61 tokens, 244 frames)
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 20), (False, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, b, h, kv, sq, sk, d, causal, window, dtype):
    q, k, v = _attn_inputs(cuda, b, h, kv, sq, sk, d, dtype, sq * 131 + sk + d)
    before = flash_attention.flash_attention.launches
    got = flash_attention.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    want = flash_attention.plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("pos", [0, 31, 32, 100, 543])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_reads_strided_cache_views(cuda, pos, dtype):
    """Decode's operands: q a transposed (B, 1, H, D) projection, k and v
    the first pos+1 rows of a (B, S_max, KV, D) cache as permuted views;
    the output comes back in q's layout."""
    gen = torch.Generator(device=cuda).manual_seed(pos)
    ck = torch.randn(3, 544, 2, 128, generator=gen, device=cuda).to(dtype)
    cv = torch.randn(3, 544, 2, 128, generator=gen, device=cuda).to(dtype)
    q = torch.randn(3, 1, 16, 128, generator=gen, device=cuda).to(dtype)
    kview = ck.permute(0, 2, 1, 3)[:, :, :pos + 1]
    vview = cv.permute(0, 2, 1, 3)[:, :, :pos + 1]
    got = flash_attention.flash_attention(q.transpose(1, 2), kview, vview)
    assert got.transpose(1, 2).is_contiguous()
    want = flash_attention.plain(q.transpose(1, 2).contiguous(), kview.contiguous(),
                                 vview.contiguous())
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("sq,sk,window", [(128, 64, 0), (70, 33, 0), (256, 256, 32)])
def test_flash_kernel_fully_masked_rows_are_zero(cuda, sq, sk, window):
    """Rows with no visible key (Sq > Sk under the right-aligned causal
    mask) give 0, and windows that mask whole tiles give no NaN."""
    q, k, v = _attn_inputs(cuda, 1, 4, 2, sq, sk, 64, torch.float32, sq + sk)
    got = flash_attention.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    if sq > sk:
        assert not got[:, :, :sq - sk].any()
    want = flash_attention.plain(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("sq", [1, 7, 61, 64, 65, 127, 512])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("rep", [1, 2, 8])
def test_flash_bf16_paths_match_plain(cuda, sq, d, rep):
    """bf16 on the tensor-core prefill kernel (more than 16 query rows per
    KV head) and on the split decode kernel (at most 16): Sq around the
    64-row q tile, right-aligned in Sk = Sq + 37 keys. One launch a call."""
    kv, sk = 2, sq + 37
    q, k, v = _attn_inputs(cuda, 2, kv * rep, kv, sq, sk, d, torch.bfloat16,
                           sq * 1009 + d * 31 + rep)
    splits = flash_attention.decode_splits(q.dtype, 2, kv * rep, kv, sq, sk)
    assert (splits > 0) == (rep * sq <= flash_attention.SPLIT_ROWS)
    before = flash_attention.flash_attention.launches
    got = flash_attention.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.launches == before + 1
    want = flash_attention.plain(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("b,h,kv,sq,sk,d,window", [
    (8, 16, 2, 1, 543, 128, 20),     # decode: 8 of 9 splits see no key
    (2, 2, 2, 1, 543, 64, 100),      # rep 1, head dim 64
    (2, 4, 2, 7, 300, 32, 10),       # a 7-row chunk against a short window
    (2, 16, 2, 512, 512, 128, 64),   # prefill: the window skips whole tiles
    (1, 4, 4, 256, 256, 32, 32),
    (1, 8, 1, 200, 333, 64, 150),    # MQA, ragged, right-aligned
])
def test_flash_bf16_windows_match_plain(cuda, b, h, kv, sq, sk, d, window):
    q, k, v = _attn_inputs(cuda, b, h, kv, sq, sk, d, torch.bfloat16, sk + window)
    got = flash_attention.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    want = flash_attention.plain(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("sq,sk", [(61, 61), (61, 200), (512, 512)])
def test_flash_bf16_prefill_reads_transposed_views(cuda, sq, sk):
    """The model's prefill operands: q a transposed (B, S, H, D) projection,
    k and v the first Sk rows of (B, S_max, KV, D) caches; the output comes
    back in q's layout."""
    gen = torch.Generator(device=cuda).manual_seed(sq + sk)
    q = torch.randn(2, sq, 16, 128, generator=gen, device=cuda).to(torch.bfloat16)
    ck = torch.randn(2, sk + 9, 2, 128, generator=gen, device=cuda).to(torch.bfloat16)
    cv = torch.randn(2, sk + 9, 2, 128, generator=gen, device=cuda).to(torch.bfloat16)
    kview = ck.permute(0, 2, 1, 3)[:, :, :sk]
    vview = cv.permute(0, 2, 1, 3)[:, :, :sk]
    got = flash_attention.flash_attention(q.transpose(1, 2), kview, vview)
    assert got.transpose(1, 2).is_contiguous()
    want = flash_attention.plain(q.transpose(1, 2).contiguous(), kview.contiguous(),
                                 vview.contiguous())
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("h,sq,sk,window", [(4, 128, 64, 0), (4, 70, 33, 0),
                                            (4, 256, 256, 32), (4, 7, 3, 0),
                                            (2, 9, 2, 0)])
def test_flash_bf16_fully_masked_rows_are_zero(cuda, h, sq, sk, window):
    """bf16 rows with no visible key give 0 on both bf16 kernels (7 and 9
    rows against 3 and 2 keys take the split decode kernel)."""
    q, k, v = _attn_inputs(cuda, 1, h, 2, sq, sk, 64, torch.bfloat16, sq * sk)
    got = flash_attention.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    if sq > sk:
        assert not got[:, :, :sq - sk].any()
    want = flash_attention.plain(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("b,sk,splits", [(8, 543, 9), (1, 37, 1), (8, 512, 8),
                                         (1, 4096, 16)])
def test_flash_decode_clusters_merge_and_repeat(cuda, b, sk, splits):
    """The split decode kernel at cluster sizes 1, 8 (the portable most), 9
    (the serve path's) and 16 (the largest): back-to-back launches give
    the same output, the plain version's."""
    q, k, v = _attn_inputs(cuda, b, 16, 2, 1, sk, 128, torch.bfloat16, sk + b)
    assert flash_attention.decode_splits(q.dtype, b, 16, 2, 1, sk) == splits
    outs = [flash_attention.flash_attention(q, k, v) for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    want = flash_attention.plain(q, k, v)
    torch.testing.assert_close(outs[0].float(), want.float(), atol=3e-2, rtol=3e-2)


FWD_256_PREFIX_CASES = [  # b, h, kv, sq, sk, d, prefix, window
    (2, 16, 16, 512, 512, 256, 0, 0),     # gemma-7b's prefill, batch cut to 2
    (2, 16, 16, 1, 543, 256, 0, 0),       # its decode
    (2, 8, 1, 768, 768, 256, 256, 0),     # paligemma-3b's prefill with its prefix
    (2, 8, 1, 1, 799, 256, 0, 0),         # its decode (no prefix: all behind)
    (1, 8, 1, 261, 261, 256, 100, 0),     # a ragged prefix
    (2, 8, 1, 45, 45, 256, 0, 0),         # ragged, past the split kernel's 16 rows
    (2, 4, 2, 200, 200, 64, 70, 20),      # a prefix inside and past a window
    (1, 4, 4, 1, 300, 32, 40, 30),        # a decode row sees the prefix past its window
    (1, 4, 2, 90, 130, 128, 100, 0),      # right-aligned rows beside a prefix
]


@pytest.mark.parametrize("b,h,kv,sq,sk,d,prefix,window", FWD_256_PREFIX_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_head_dim_256_and_prefix_match_plain(cuda, b, h, kv, sq, sk, d, prefix,
                                                   window, dtype):
    """Head dim 256 on every forward path (bf16 prefill, bf16 split decode,
    fp32) and the prefix-LM block (a prefix call never takes the split
    kernel). One launch a call; the output against the plain version, and
    against the plain version without the prefix for a control."""
    q, k, v = _attn_inputs(cuda, b, h, kv, sq, sk, d, dtype, sq * 17 + sk + prefix)
    before = flash_attention.flash_attention.launches
    got = flash_attention.flash_attention(q, k, v, causal=True, window=window,
                                          prefix_len=prefix)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.launches == before + 1
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    want = flash_attention.plain(q, k, v, causal=True, window=window, prefix_len=prefix)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if not torch.equal(_visible(sq, sk, True, window, "cpu", prefix),
                       _visible(sq, sk, True, window, "cpu")):   # the prefix shows
        without = flash_attention.plain(q, k, v, causal=True, window=window)
        assert not torch.allclose(got.float(), without.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("b,kv,sk,splits", [(8, 16, 543, 3), (8, 1, 799, 9),
                                            (1, 1, 4096, 9), (2, 1, 100, 2)])
def test_flash_decode_at_head_dim_256_within_the_smem_cap(cuda, b, kv, sk, splits):
    """The split decode kernel at head dim 256: its splits capped at 9,
    whose tiles and merge buffer fit a block's 227 KB; repeatable and the
    plain version's."""
    assert flash_attention.split_cap(256) == 9
    assert flash_attention.split_smem_bytes(256, 9) <= flash_attention.SMEM_OPT_IN_MAX
    h = 16 if kv == 16 else 8
    q, k, v = _attn_inputs(cuda, b, h, kv, 1, sk, 256, torch.bfloat16, sk + b)
    assert flash_attention.decode_splits(q.dtype, b, h, kv, 1, sk, d=256) == splits
    outs = [flash_attention.flash_attention(q, k, v) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    want = flash_attention.plain(q, k, v)
    torch.testing.assert_close(outs[0].float(), want.float(), atol=3e-2, rtol=3e-2)


def test_flash_kernel_rejects_bad_operands(cuda):
    q = torch.zeros(1, 4, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention(q, q, q)
    q = torch.zeros(1, 4, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="query heads"):
        flash_attention.flash_attention(q, q[:, :3], q[:, :3])
    with pytest.raises(TypeError, match="dtype"):
        flash_attention.flash_attention(q, q.half(), q.half())
    kt = torch.zeros(1, 4, 64, 8, device=cuda).transpose(2, 3)   # stride(-1) = 8
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention(q, kt, kt)
    ragged = torch.zeros(1, 4, 8 * 64 + 1, device=cuda)[:, :, 1:].view(1, 4, 8, 64)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention.flash_attention(ragged, q, q)


def test_serve_smoke_card_matches_cpu_and_counts_launches(cuda):
    """qwen2.5-3b's smoke variant served on the card and on the CPU: the
    same tokens; 2·L+1 rmsnorm and L flash launches per forward."""
    gen, n_layers = 6, 2
    r0, f0 = rmsnorm.rmsnorm.launches, flash_attention.flash_attention.launches
    card, stats = serve.generate("qwen2.5-3b", smoke=True, batch=2, prompt_len=21,
                                 gen=gen, device=cuda)
    forwards = gen                       # one prefill, gen - 1 decode steps
    assert rmsnorm.rmsnorm.launches - r0 == (2 * n_layers + 1) * forwards
    assert flash_attention.flash_attention.launches - f0 == n_layers * forwards
    cpu, _ = serve.generate("qwen2.5-3b", smoke=True, batch=2, prompt_len=21,
                            gen=gen, device="cpu")
    assert torch.equal(card.cpu(), cpu) and stats["tokens_per_s"] > 0


# ---------------------------------------------------------------------------
# backward kernels (the training slice)
# ---------------------------------------------------------------------------


def _close_sum(got, want, scale, tol, what=""):
    """|got - want| <= tol·(1 + scale) elementwise, where scale bounds the
    magnitude of the terms summed into each entry."""
    err = (got.float() - want.float()).abs()
    bad = err > tol * (1 + scale.float())
    assert not bad.any(), f"{what}: max |diff| {err.max().item()}"


def _rms_bwd_inputs(cuda, shape, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    sc = (torch.randn(shape[-1], generator=gen, device=cuda) * 0.1).to(dtype)
    dy = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    return x, sc, dy


RMS_BWD_SHAPES = [(1, 2048), (4, 128), (3, 7, 256), (2, 37, 512), (5, 100), (3, 3000),
                  (8, 2048), (4096, 2048), (1000, 4096), (1056, 2048)]


@pytest.mark.parametrize("shape", RMS_BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_kernel_matches_plain(cuda, shape, dtype):
    x, sc, dy = _rms_bwd_inputs(cuda, shape, dtype, sum(shape))
    before = rmsnorm.rmsnorm_bwd.launches
    dx, dscale = rmsnorm.rmsnorm_bwd(x, sc, dy, 1e-6)
    torch.cuda.synchronize()
    assert rmsnorm.rmsnorm_bwd.launches == before + 1
    assert dx.dtype == dtype and dx.shape == x.shape and dscale.shape == sc.shape
    want_dx, want_ds = rmsnorm.plain_bwd(x, sc, dy, 1e-6)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(dx.float(), want_dx.float(), atol=tol, rtol=tol)
    x32 = x.float().reshape(-1, shape[-1])
    r = torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + 1e-6)
    terms = (x32 * dy.float().reshape(-1, shape[-1]) * r).abs().sum(0)
    _close_sum(dscale, want_ds, terms if dtype == torch.float32 else want_ds.abs(),
               tol, "dscale")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_takes_unaligned_rows(cuda, dtype):
    rows, d = 37, 512
    flat = torch.randn(2, rows * d + 1, device=cuda).to(dtype)
    x, dy = flat[0, 1:].view(rows, d), flat[1, 1:].view(rows, d)
    assert x.data_ptr() % 16
    sc = (torch.randn(d, device=cuda) * 0.1).to(dtype)
    dx, _ = rmsnorm.rmsnorm_bwd(x, sc, dy, 1e-6)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(dx.float(), rmsnorm.plain_bwd(x, sc, dy, 1e-6)[0].float(),
                               atol=tol, rtol=tol)


# One torch.profiler session over one rmsnorm_bwd call and then one
# flash_attention_bwd call (bf16, the train path's shapes), in a fresh
# process: on the H100 a second profiler session in one process recorded
# no CUDA events, and test_ssca_update_is_one_kernel_per_call holds the
# first. Prints the CUDA kernels in the order they started.
_PROFILE_BWD = """
import json, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import flash_attention as fa, rmsnorm as rms
g = torch.Generator(device="cuda").manual_seed(5)
def rn(*s):
    return torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)
x, dy, sc = rn(4096, 2048), rn(4096, 2048), rn(2048) * 0.1
q, k, v, do = rn(8, 16, 512, 128), rn(8, 2, 512, 128), rn(8, 2, 512, 128), rn(8, 16, 512, 128)
o, lse = fa.flash_attention(q, k, v, return_lse=True)
rms.rmsnorm_bwd(x, sc, dy)
fa.flash_attention_bwd(q, k, v, o, lse, do)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    rms.rmsnorm_bwd(x, sc, dy)
    torch.cuda.synchronize()
    fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
ev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
            key=lambda e: e.time_range.start)
print(json.dumps([e.name for e in ev]))
"""


@pytest.fixture(scope="module")
def bwd_kernel_names():
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", _PROFILE_BWD], capture_output=True,
                         text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": str(src)})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_rmsnorm_bwd_is_two_kernels_and_deterministic(cuda, bwd_kernel_names):
    """A call at the train path's shape is the row kernel (dx and each
    cluster's column sums) then the dscale kernel, nothing else (under
    torch.profiler), and two calls give the same bits (no atomics)."""
    names = bwd_kernel_names[:2]
    assert "rmsnorm_bwd_rows_kernel" in names[0] and "rmsnorm_bwd_cols_kernel" in names[1], \
        bwd_kernel_names
    x, sc, dy = _rms_bwd_inputs(cuda, (4096, 2048), torch.bfloat16, 5)
    first = rmsnorm.rmsnorm_bwd(x, sc, dy)
    again = rmsnorm.rmsnorm_bwd(x, sc, dy)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


def test_rmsnorm_bwd_rejects_bad_operands(cuda):
    x, sc, dy = _rms_bwd_inputs(cuda, (64, 256), torch.float32, 6)
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm.rmsnorm_bwd(x, sc, dy.T.contiguous().T)
    with pytest.raises(ValueError, match="dy"):
        rmsnorm.rmsnorm_bwd(x, sc, dy.to(torch.bfloat16))


def _attn_bwd(cuda, b, h, kv, sq, sk, d, dtype, causal, window, seed, prefix_len=0):
    q, k, v = _attn_inputs(cuda, b, h, kv, sq, sk, d, dtype, seed)
    gen = torch.Generator(device=cuda).manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=gen, device=cuda).to(dtype)
    o, lse = flash_attention.flash_attention(q, k, v, causal=causal, window=window,
                                             prefix_len=prefix_len, return_lse=True)
    return q, k, v, o, lse, do


BF16_BWD_REL_NORM = 1e-2           # as chip_smoke.py's
BWD_CASES = [  # b, h, kv, sq, sk, d
    (2, 4, 4, 61, 61, 64),          # ragged, rep 1
    (2, 8, 4, 200, 200, 128),       # ragged, rep 2
    (2, 16, 2, 200, 200, 128),      # rep 8
    (1, 16, 2, 64, 256, 128),       # a short query right-aligned in its keys
    (1, 4, 2, 128, 64, 64),         # rows that see no key
    (1, 4, 4, 96, 96, 32),
    (2, 16, 2, 512, 512, 128),      # the train path's shape, batch cut to 2
    (2, 8, 2, 77, 133, 64),         # lengths off the 64-row tiles; an odd key tile unpaired
    (9, 16, 2, 200, 200, 128),      # rep 8 in 3 head chunks on an H100 (bwd_chunks), 3 not dividing 8
    (1, 16, 2, 1000, 1000, 128),    # a long sequence: 8 pairs of key tiles
    (2, 16, 16, 2048, 2048, 64),    # seamless-m4t's encoder at its train shape, batch cut to 2
    (2, 16, 16, 512, 2048, 64),     # its cross-attention: 512 tokens over 2,048 frames
    (2, 16, 16, 61, 244, 64),       # ragged cross-attention
]


@pytest.mark.parametrize("b,h,kv,sq,sk,d", BWD_CASES)
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 20), (False, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_matches_plain(cuda, b, h, kv, sq, sk, d, causal, window, dtype):
    _check_flash_bwd(cuda, b, h, kv, sq, sk, d, causal, window, dtype)


@pytest.mark.parametrize("sq,window", [(512, 20), (1100, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_windowed_at_glm4_ratio_matches_plain(cuda, sq, window, dtype):
    """glm4-9b-swa's training attention: 32 query heads over 2 KV heads (16
    a group), head dim 128, a sliding window shorter than the sequence."""
    _check_flash_bwd(cuda, 1, 32, 2, sq, sq, 128, True, window, dtype)


def _check_flash_bwd(cuda, b, h, kv, sq, sk, d, causal, window, dtype, prefix_len=0):
    q, k, v, o, lse, do = _attn_bwd(cuda, b, h, kv, sq, sk, d, dtype, causal, window,
                                    sq * 7 + sk + d, prefix_len)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    want_o, want_lse = flash_attention.plain(q, k, v, causal=causal, window=window,
                                             prefix_len=prefix_len, return_lse=True)
    seen = torch.isfinite(want_lse)
    assert torch.isneginf(lse[~seen]).all()
    torch.testing.assert_close(lse[seen], want_lse[seen], atol=2e-5, rtol=2e-5)
    before = flash_attention.flash_attention_bwd.launches
    dq, dk, dv = flash_attention.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                                     window=window, prefix_len=prefix_len)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention_bwd.launches == before + 1
    want = flash_attention.plain_bwd(q, k, v, o, lse, do, causal=causal, window=window,
                                     prefix_len=prefix_len)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.dtype == dtype and got.shape == w.shape, name
        assert torch.isfinite(got).all(), name
        _close_sum(got, w, w.abs(), tol, name)
        if dtype == torch.bfloat16:
            # elementwise 3e-2 is over half a typical |dq| at the train shape
            rel = ((got.float() - w.float()).norm() / w.float().norm()).item()
            assert rel <= BF16_BWD_REL_NORM, f"{name}: |diff| / |want| {rel}"


# head dim 256 (gemma-7b, paligemma-3b) and the prefix-LM block: b, h, kv,
# sq, sk, d, prefix, window
BWD_256_PREFIX_CASES = [
    (2, 8, 1, 512, 512, 256, 0, 0),       # paligemma-3b's train shape, batch cut to 2
    (2, 16, 16, 200, 200, 256, 0, 0),     # gemma-7b's heads, ragged
    (2, 8, 1, 768, 768, 256, 256, 0),     # paligemma-3b with its 256-token prefix
    (1, 8, 1, 261, 261, 256, 100, 0),     # a prefix that is not a multiple of a tile
    (1, 4, 2, 200, 200, 64, 70, 20),      # a prefix inside and past a window
    (1, 4, 2, 130, 130, 128, 130, 0),     # every key in the prefix
    (2, 8, 1, 333, 333, 256, 77, 0),      # rep 8 at head dim 256, a ragged prefix
]


@pytest.mark.parametrize("b,h,kv,sq,sk,d,prefix,window", BWD_256_PREFIX_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_head_dim_256_and_prefix_match_plain(cuda, b, h, kv, sq, sk, d, prefix,
                                                       window, dtype):
    _check_flash_bwd(cuda, b, h, kv, sq, sk, d, True, window, dtype, prefix)


def test_flash_bwd_is_two_kernels_dq_first_and_deterministic(cuda, bwd_kernel_names):
    """A call is the dq kernel then the dk/dv kernel, nothing else (under
    torch.profiler, after the rmsnorm_bwd call's two), and two calls give
    the same bits."""
    names = bwd_kernel_names[2:]
    assert len(names) == 2 and "flash_bwd_dq_wg_kernel" in names[0] \
        and "flash_bwd_dkdv_wg_kernel" in names[1], bwd_kernel_names
    args = _attn_bwd(cuda, 2, 16, 2, 512, 512, 128, torch.bfloat16, True, 0, 11)
    first = flash_attention.flash_attention_bwd(*args)
    again = flash_attention.flash_attention_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_flash_decode_split_path_refuses_lse(cuda):
    """The C entry refuses an lse with the decode kernel's splits; the
    wrapper never asks for it (a call with return_lse takes the prefill
    kernel, and agrees with the plain version)."""
    from repro_torch.kernels import build
    q, k, v = _attn_inputs(cuda, 8, 16, 2, 1, 543, 128, torch.bfloat16, 3)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], device=cuda)
    args = list(flash_attention.kernel_args(q, k, v, out))
    assert args[-1] == 9
    args[5] = lse.data_ptr()
    code = build.library("flash_attention").flash_attention(
        *args, torch.cuda.current_stream().cuda_stream)
    assert code != 0
    got, got_lse = flash_attention.flash_attention(q, k, v, return_lse=True)
    want, want_lse = flash_attention.plain(q, k, v, return_lse=True)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(got_lse, want_lse, atol=2e-5, rtol=2e-5)


def test_flash_bwd_rejects_bad_operands(cuda):
    q, k, v, o, lse, do = _attn_bwd(cuda, 1, 4, 2, 64, 64, 64, torch.float32, True, 0, 4)
    odd = torch.zeros(1, 4, 64, 64, 2, device=cuda)[..., 0]        # stride(-1) = 2
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention_bwd(q, k, v, o, lse, odd)
    with pytest.raises(ValueError, match="lse"):
        flash_attention.flash_attention_bwd(q, k, v, o, lse.double(), do)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention.flash_attention_bwd(q, k, v, o, lse, do.to(torch.bfloat16))


def test_train_smoke_card_matches_cpu_and_counts_launches(cuda):
    """Three SSCA steps of qwen2.5-3b's smoke variant (fp32, no remat) on the
    card and on the CPU: the same losses; per step 2·L+1 rmsnorm forwards
    and backwards, L flash forwards and backwards, one ssca_update."""
    steps, n_layers = 3, 2
    counted = (rmsnorm.rmsnorm, rmsnorm.rmsnorm_bwd, flash_attention.flash_attention,
               flash_attention.flash_attention_bwd, ssca_update.ssca_update_)
    before = [f.launches for f in counted]
    _, card = train.train_loop("qwen2.5-3b", steps, 2, 64, smoke=True, log_every=1,
                               device=cuda)
    per_step = [(f.launches - b0) / steps for f, b0 in zip(counted, before)]
    assert per_step == [2 * n_layers + 1, 2 * n_layers + 1, n_layers, n_layers, 1]
    _, cpu = train.train_loop("qwen2.5-3b", steps, 2, 64, smoke=True, log_every=1,
                              device="cpu")
    for a, b0 in zip(card, cpu):
        assert abs(a["loss"] - b0["loss"]) <= 1e-5 * abs(b0["loss"])


def _paper_small(cuda):
    """The paper suite's inputs at a small width (P=32, J=16, L=10, I=4,
    B=20) on the card, with the feature params built as
    examples/paper_experiments.py builds them."""
    (z, y, _), _ = classification_dataset(rnd.PRNGKey(0, device=cuda), n=400,
                                          num_features=32, test_n=10, noise=4.0,
                                          device=cuda)
    p0 = mlp.init(rnd.PRNGKey(1, device=cuda), 32, 16, 10, device=cuda)
    fp0 = convert.feature_params_from_numpy(p0["w0"].cpu().numpy(),
                                            p0["w1"].cpu().numpy(), 4, cuda)
    fl_u = FLConfig(num_clients=4, batch_size=20, a1=0.3, a2=0.3, tau=0.05)
    fl_c = FLConfig(num_clients=4, batch_size=20, a1=0.9, a2=0.5, tau=0.2,
                    constrained=True, cost_limit=2.2, penalty_c=1e5)
    return (fed.partition_samples(z, y, 4), fed.partition_features(z, y, 4), p0,
            fp0, fl_u, fl_c)


def _paper_run(name, inputs, rounds, device):
    data, fdata, p0, fp0, fl_u, fl_c = inputs
    psl, head, ch = mlp.per_sample_loss, mlp.per_sample_loss_from_h, mlp.client_h
    key = rnd.PRNGKey(7, device=device)
    if name == "alg2":
        return algorithms.algorithm2(psl, p0, data, fl_c, rounds, key, device=device)
    if name == "alg2_general":
        return algorithms.algorithm2_general(psl, psl, p0, data, fl_c, rounds, key,
                                             device=device)
    if name in ("alg3", "alg3_int8"):
        return algorithms.algorithm3(head, ch, fp0, fdata, fl_u, rounds, key,
                                     codec=codecs.make_codec(
                                         "int8" if name == "alg3_int8" else None),
                                     device=device)
    if name == "alg4":
        return algorithms.algorithm4(head, ch, fp0, fdata, fl_c, rounds, key,
                                     device=device)
    cfg = (baselines.SGDConfig(lr_alpha=0.0, momentum=0.1, local_steps=5, local_batch=4)
           if name == "sgdm" else baselines.SGDConfig(local_batch=20))
    return baselines.sample_sgd(psl, p0, data, cfg, rounds, key,
                                momentum=name == "sgdm", device=device)


@pytest.mark.parametrize("name", ["alg2", "alg2_general", "alg3", "alg3_int8",
                                  "alg4", "fedsgd", "sgdm"])
def test_paper_suite_card_matches_cpu(cuda, name):
    """Six rounds of each run of the paper's suite at a small width on the card
    and on the CPU from the same params, data and keys: the params and every
    per-round series within 1e-5 (ν rtol 2e-4 in Lemma 1's interior, as the
    CPU parity tests hold it); one ssca_update launch a round for Algorithm
    3, two keyed quantize launches (head and block streams) with int8."""
    rounds = 6
    inputs = _paper_small(cuda)
    before = (ssca_update.ssca_update_.launches,
              quantize.stochastic_quantize_keyed.launches)
    card = _paper_run(name, inputs, rounds, None)
    torch.cuda.synchronize()
    launched = (ssca_update.ssca_update_.launches - before[0],
                quantize.stochastic_quantize_keyed.launches - before[1])
    assert launched == ((rounds if name.startswith("alg3") else 0),
                        (2 * rounds if name == "alg3_int8" else 0))
    data, fdata, p0, fp0, fl_u, fl_c = inputs
    on_cpu = (data.to("cpu"), fdata.to("cpu"), {k: v.cpu() for k, v in p0.items()},
              {k: v.cpu() for k, v in fp0.items()}, fl_u, fl_c)
    cpu = _paper_run(name, on_cpu, rounds, "cpu")
    assert set(card.history) == set(cpu.history)
    for k, v in cpu.history.items():
        rtol = 2e-4 if k == "round_nu" else 1e-5
        torch.testing.assert_close(card.history[k].cpu(), v, atol=1e-5, rtol=rtol)
    if name != "alg3_int8":         # a flipped rounding decision moves a step
        for k in card.params:
            torch.testing.assert_close(card.params[k].cpu(), cpu.params[k],
                                       atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_constrained_step_chunked_on_card_matches_one_chunk(cuda, dtype, monkeypatch):
    """The Lemma-1 update at 3·2^20+5 elements in 2^20-element chunks and in
    one chunk: only the order of the fp32 sums differs. The gradient's scale
    puts ν near 100, where ν moves by half the relative gap of its inputs."""
    n = 3 * 2**20 + 5
    gen = torch.Generator(device=cuda).manual_seed(8)
    w0 = (torch.randn(n, generator=gen, device=cuda) * 0.1).to(dtype)
    grad = (torch.randn(n, generator=gen, device=cuda) * 1e-3).to(dtype)
    fl = FLConfig(tau=0.2, cost_limit=1.0, penalty_c=1e5)
    outs = []
    for size in (1 << 25, 1 << 20):
        monkeypatch.setattr(surrogate, "CHUNK", size)
        state = optimizer.ssca_constrained_init({"w": w0})
        for _ in range(3):
            state = optimizer.ssca_constrained_step(state, grad, torch.tensor(3.0, device=cuda), fl)
        outs.append(state)
    a, b = outs
    # in bf16 a 1-ulp ν difference can round a parameter to its neighbour,
    # which the next steps' surrogate carries
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(b.w_flat.float(), a.w_flat.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(b.g_flat, a.g_flat, atol=tol, rtol=tol)
    torch.testing.assert_close(b.nu, a.nu, atol=0, rtol=1e-5)


def test_constrained_train_smoke_card_matches_cpu(cuda):
    """Three constrained steps of qwen2.5-3b's smoke variant on the card and
    on the CPU: losses, ν and ‖ω‖² within rtol 1e-5; no ssca_update launch."""
    before = ssca_update.ssca_update_.launches
    _, card = train.train_loop("qwen2.5-3b", 3, 2, 64, smoke=True, log_every=1,
                               constrained=True, device=cuda)
    assert ssca_update.ssca_update_.launches == before
    _, cpu = train.train_loop("qwen2.5-3b", 3, 2, 64, smoke=True, log_every=1,
                              constrained=True, device="cpu")
    for a, b0 in zip(card, cpu):
        for k in ("loss", "nu", "l2"):
            assert abs(a[k] - b0[k]) <= 1e-5 * abs(b0[k]), (k, a[k], b0[k])


# ---------------------------------------------------------------------------
# the cohort engine
# ---------------------------------------------------------------------------

COHORT_GRID = [(10, 1), (10, 3), (10, 10), (48, 12), (48, 48), (1000, 256),
               (1_000_000, 1), (1_000_000, 256), (2**32 - 5, 64)]


@pytest.mark.parametrize("num_clients,cohort", COHORT_GRID)
def test_cohort_sample_kernel_bit_exact(cuda, num_clients, cohort):
    for seed in range(3):
        keys = rnd.bits(rnd.PRNGKey(seed + num_clients, device=cuda),
                        (fed.FEISTEL_ROUNDS,))
        want = cohort_sample.plain(keys.cpu(), num_clients, cohort,
                                   *cohort_sample.domain_bits(num_clients))
        before = cohort_sample.cohort_sample.launches
        got = cohort_sample.cohort_sample(keys, num_clients, cohort)
        torch.cuda.synchronize()
        assert cohort_sample.cohort_sample.launches == before + 1
        assert got.dtype == torch.int32 and got.device.type == "cuda"
        assert torch.equal(got.cpu(), want)
        assert got.unique().numel() == cohort


def test_cohort_sample_kernel_rejects_bad_operands(cuda):
    keys = torch.zeros(6, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="cohort"):
        cohort_sample.cohort_sample(keys, 10, 11)
    with pytest.raises(TypeError, match="round keys"):
        cohort_sample.cohort_sample(keys.float(), 10, 3)
    with pytest.raises(TypeError, match="round keys"):
        cohort_sample.cohort_sample(keys.reshape(2, 3), 10, 3)


@pytest.mark.parametrize("k", [1, 6, 255, 256, 257, 2541])
def test_chain_values_quantize_in_one_launch(cuda, k):
    """Chain's (rows, k) kept values: one launch, bit-exact with the plain
    version on the same keys."""
    x = torch.randn(256, 576 if k <= 576 else 50_816, device=cuda)
    codec = codecs.Chain(sparse=codecs.TopK(frac=k / x.shape[1]))
    assert codec.sparse.k(x.shape[1]) == k
    keys = fed.client_keys(rnd.PRNGKey(4, device=cuda),
                           torch.arange(256, device=cuda))
    before = quantize.stochastic_quantize_keyed.launches
    enc, xhat = codec.roundtrip(x, keys)
    torch.cuda.synchronize()
    assert quantize.stochastic_quantize_keyed.launches == before + 1
    cenc, cxhat = codec.roundtrip(x.cpu(), keys.cpu())
    assert torch.equal(enc.indices.cpu(), cenc.indices)
    assert torch.equal(enc.inner.values.cpu(), cenc.inner.values)
    assert torch.equal(enc.inner.scales.cpu(), cenc.inner.scales)
    assert torch.equal(xhat.cpu(), cxhat)


@pytest.mark.parametrize("codec_name", [None, "int8", "topk8"])
def test_cohort_engine_card_matches_cpu_and_does_not_sync(cuda, codec_name):
    """Algorithm 1 on the cohort engine, 4 rounds at I = 48, S = 12: the
    same ids and params within 1e-4 on the card and the CPU; one round on
    the card under sync-debug mode "error"; one cohort_sample launch a
    round."""
    from repro_torch.comm import error_feedback
    from repro_torch.core import rounds
    from repro_torch.data.synthetic import VirtualFedData

    fl = FLConfig(batch_size=6, a1=0.9, a2=0.5, alpha_rho=0.1, alpha_gamma=0.6,
                  tau=0.2, l2_lambda=1e-5)

    def run(device):
        key = rnd.PRNGKey(31, device=device)
        data = VirtualFedData(rnd.fold_in(key, 1), 48, n_min=6, n_max=14,
                              num_features=10, num_classes=3)
        p0 = mlp.init(rnd.fold_in(key, 2), 10, 8, 3, device=device)
        return algorithms.algorithm1(
            mlp.per_sample_loss, p0, data, fl, 4, rnd.fold_in(key, 3),
            participation=12, cohort=True, device=device,
            codec=codecs.make_codec(codec_name))

    before = cohort_sample.cohort_sample.launches
    card = run(cuda)
    assert cohort_sample.cohort_sample.launches == before + 4
    cpu = run("cpu")
    for k in cpu.params:
        torch.testing.assert_close(card.params[k].cpu(), cpu.params[k],
                                   atol=1e-4, rtol=0)
    key = rnd.PRNGKey(5, device=cuda)
    data = VirtualFedData(key, 1000, num_features=10, num_classes=3)
    codec = codecs.make_codec(codec_name)
    step = algorithms.make_algorithm1_step(mlp.per_sample_loss, data, fl,
                                           participation=16, codec=codec,
                                           cohort=True)
    state = optimizer.ssca_init(mlp.init(key, 10, 8, 3, device=cuda))
    if codec is not None:
        state = error_feedback.CommCarry(
            opt=state, ef=error_feedback.ef_store_init(1000, 104, device=cuda))
    inputs = rounds.make_inputs(fl, 1, 2, key)
    state, _ = step(state, inputs.round(0))          # builds, warms up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = step(state, inputs.round(1))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(m["loss_est"]).item()


def test_ef_store_host_offload_on_the_card(cuda):
    """ef_store_init(host_offload=True) on the card: the backing is pinned
    host memory, gather gives the cohort's rows on the card and scatter
    writes them back in place. Algorithm 1 with int8 + EF over 5 cohort
    rounds at I = 48, S = 12 ends bit-equal from the offloaded store and
    from one on the card, and an offloaded round syncs the host, as its
    docstring says."""
    from repro_torch.comm import error_feedback
    from repro_torch.core import rounds
    from repro_torch.data.synthetic import VirtualFedData

    store = error_feedback.ef_store_init(10, 3, host_offload=True, device=cuda)
    assert store.data.is_pinned() and not store.data.is_cuda
    ids = torch.tensor([7, 2], device=cuda)
    rows = torch.arange(6.0, device=cuda).reshape(2, 3)
    assert store.scatter(ids, rows) is store
    got = store.gather(ids)
    assert got.is_cuda and torch.equal(got, rows)
    assert int(store.data.any(dim=1).sum()) == 2

    fl = FLConfig(batch_size=6, a1=0.9, a2=0.5, alpha_rho=0.1, alpha_gamma=0.6,
                  tau=0.2, l2_lambda=1e-5)
    key = rnd.PRNGKey(7, device=cuda)
    data = VirtualFedData(rnd.fold_in(key, 1), 48, num_features=10,
                          num_classes=3)
    step = algorithms.make_algorithm1_step(
        mlp.per_sample_loss, data, fl, participation=12,
        codec=codecs.make_codec("int8"), cohort=True)
    p0 = mlp.init(rnd.fold_in(key, 2), 10, 8, 3, device=cuda)
    dim = sum(v.numel() for v in p0.values())
    inputs = rounds.make_inputs(fl, 1, 6, key)
    final = {}
    for offload in (False, True):
        state = error_feedback.CommCarry(
            opt=optimizer.ssca_init({k: v.clone() for k, v in p0.items()}),
            ef=error_feedback.ef_store_init(48, dim, host_offload=offload,
                                            device=cuda))
        for r in range(5):
            state, _ = step(state, inputs.round(r))
        final[offload] = state
    card, host = final[False], final[True]
    for k in card.opt.params:
        assert torch.equal(card.opt.params[k], host.opt.params[k]), k
    assert torch.equal(card.ef.data.cpu(), host.ef.data)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            step(host, inputs.round(5))
    finally:
        torch.cuda.set_sync_debug_mode("default")


# ---------------------------------------------------------------------------
# the MoE decoder, the sliding window and untied embeddings (smoke size)
# ---------------------------------------------------------------------------

ZOO_SMOKE = ["qwen3-moe-30b-a3b", "arctic-480b", "glm4-9b-swa", "deepseek-67b",
             "gemma-7b", "paligemma-3b"]


@pytest.mark.parametrize("arch", ZOO_SMOKE)
def test_zoo_serve_smoke_card_matches_cpu_and_counts_launches(cuda, arch):
    """The smoke variants served on the card and on the CPU from the same
    seed: the same tokens; 2·L+1 rmsnorm and L flash launches per forward
    (the MoE runs no kernel of its own). The prompt, 40 tokens, is longer
    than glm4-9b-swa's smoke window of 16."""
    gen, n_layers = 6, 2
    r0, f0 = rmsnorm.rmsnorm.launches, flash_attention.flash_attention.launches
    card, _ = serve.generate(arch, smoke=True, batch=2, prompt_len=40, gen=gen,
                             device=cuda)
    assert rmsnorm.rmsnorm.launches - r0 == (2 * n_layers + 1) * gen
    assert flash_attention.flash_attention.launches - f0 == n_layers * gen
    cpu, _ = serve.generate(arch, smoke=True, batch=2, prompt_len=40, gen=gen,
                            device="cpu")
    assert torch.equal(card.cpu(), cpu)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "arctic-480b", "glm4-9b-swa",
                                  "paligemma-3b"])
def test_zoo_train_smoke_card_matches_cpu_and_counts_launches(cuda, arch):
    """Three SSCA steps of the smoke variants (fp32, no remat) on the card
    and on the CPU, sequence 64 (past glm4-9b-swa's smoke window): the same
    losses (the MoE's with its aux) within rtol 1e-5; per step the dense
    model's launches."""
    steps, n_layers = 3, 2
    counted = (rmsnorm.rmsnorm, rmsnorm.rmsnorm_bwd, flash_attention.flash_attention,
               flash_attention.flash_attention_bwd, ssca_update.ssca_update_)
    before = [f.launches for f in counted]
    _, card = train.train_loop(arch, steps, 2, 64, smoke=True, log_every=1,
                               device=cuda)
    per_step = [(f.launches - b0) / steps for f, b0 in zip(counted, before)]
    assert per_step == [2 * n_layers + 1, 2 * n_layers + 1, n_layers, n_layers, 1]
    _, cpu = train.train_loop(arch, steps, 2, 64, smoke=True, log_every=1,
                              device="cpu")
    for a, b0 in zip(card, cpu):
        assert abs(a["loss"] - b0["loss"]) <= 1e-5 * abs(b0["loss"])


@pytest.mark.parametrize("arch,head_dim", [("paligemma-3b", 64), ("paligemma-3b", 256)])
def test_vlm_prefix_loss_card_matches_cpu_and_counts_launches(cuda, arch, head_dim):
    """paligemma-3b's smoke variant (and a cut of it at head dim 256: d_model
    512, 2 heads over 1 KV head) with 8 prefix embeddings before 24 tokens,
    fp32: the loss and its gradient on the card against the CPU (rtol 1e-5,
    atol 1e-5 on the gradient), with L flash and L flash_bwd launches (the
    prefix on every one)."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.core.tree import leaves
    from repro_torch.models import transformer
    cfg = get_config(arch).smoke()
    if head_dim == 256:
        cfg = dataclasses.replace(cfg, d_model=512, n_heads=2, head_dim=256)
    gen = torch.Generator().manual_seed(head_dim)
    toks = torch.randint(0, cfg.vocab_size, (2, 25), generator=gen, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "prefix_embeddings": torch.randn(2, cfg.num_prefix_tokens, cfg.d_model,
                                              generator=gen)}
    params = transformer.init(rnd.PRNGKey(0, device="cpu"), cfg, device="cpu")
    out = {}
    for dev in ("cpu", cuda):
        p = convert.params_from_numpy(convert.params_to_numpy(params), dev)
        for t in leaves(p):
            t.requires_grad_()
        f0 = flash_attention.flash_attention.launches
        b0 = flash_attention.flash_attention_bwd.launches
        loss = transformer.loss_fn(p, {k: v.to(dev) for k, v in batch.items()}, cfg)
        loss.backward()
        out[str(dev)] = (loss.item(), [t.grad.cpu() for t in leaves(p)],
                         flash_attention.flash_attention.launches - f0,
                         flash_attention.flash_attention_bwd.launches - b0)
    (cpu_loss, cpu_g, _, _), (card_loss, card_g, nf, nb) = out["cpu"], out[str(cuda)]
    assert (nf, nb) == (cfg.n_layers, cfg.n_layers)
    assert abs(card_loss - cpu_loss) <= 1e-5 * abs(cpu_loss)
    for a, b in zip(card_g, cpu_g):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
