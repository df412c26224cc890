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
kernel tests' (the online softmax sums in another order).
"""
import pytest
import torch

from repro_torch import random as rnd
from repro_torch.comm import codecs
from repro_torch.configs.base import FLConfig
from repro_torch.core import algorithms, fed
from repro_torch.data.synthetic import classification_dataset
from repro_torch.kernels import flash_attention, quantize, rmsnorm, ssca_update
from repro_torch.launch import serve
from repro_torch.models import mlp

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# every ragged end of the 16-byte vectors (4 fp32, 8 bf16), the main path's
# 101,632 and a grid-strided 2^20+3
SSCA_SIZES = [1, 3, 4, 7, 8, 9, 17, 1000, 4096, 70000, 101_632, 2**20 + 3]


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
    keys = fed.client_keys(rnd.PRNGKey(3, device=cuda), torch.arange(10, device=cuda))
    x = torch.randn(10, 5000, device=cuda)
    before = quantize.stochastic_quantize.launches
    enc, xhat = codecs.make_codec("int8").roundtrip(x, keys)
    assert quantize.stochastic_quantize.launches == before + 1
    enc_cpu, xhat_cpu = codecs.make_codec("int8").roundtrip(x.cpu(), keys.cpu())
    assert torch.equal(enc.values.cpu(), enc_cpu.values)
    assert torch.equal(xhat.cpu(), xhat_cpu)


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
