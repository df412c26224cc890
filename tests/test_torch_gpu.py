"""The port's CUDA kernels on the card (marker ``gpu``): built with nvcc for
sm_90a at first use, launched through their wrappers and held against their
plain versions on the same CUDA tensors. Without a CUDA device every test
here skips. This file imports no jax, so it also runs on a machine that has
only PyTorch:

    python -m pytest tests/test_torch_gpu.py -m gpu -q

Tolerances: ssca_update 1e-5 in fp32 and 2e-2 in bf16 (nvcc's FMAs round
once where the plain version rounds twice); the quantizer is bit-exact.
"""
import pytest
import torch

from repro_torch import random as rnd
from repro_torch.comm import codecs
from repro_torch.configs.base import FLConfig
from repro_torch.core import algorithms, fed
from repro_torch.data.synthetic import classification_dataset
from repro_torch.kernels import quantize, ssca_update
from repro_torch.models import mlp

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [17, 1000, 4096, 70000, 101_632])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssca_update_kernel_matches_plain(cuda, n, dtype):
    gen = torch.Generator(device=cuda).manual_seed(n)
    w = torch.randn(n, generator=gen, device=cuda).to(dtype)
    buf = torch.randn(n, generator=gen, device=cuda)
    g = torch.randn(n, generator=gen, device=cuda).to(dtype)
    want_w, want_b = ssca_update.plain(w, buf, g, 0.7, 0.25, 0.2, 1e-4)
    before = ssca_update.ssca_update_.launches
    got_w, got_b = ssca_update.ssca_update_(w, buf, g, torch.tensor(0.7, device=cuda),
                                            torch.tensor(0.25, device=cuda), 0.2, 1e-4)
    torch.cuda.synchronize()
    assert got_w is w and ssca_update.ssca_update_.launches == before + 1
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got_w.float(), want_w.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(got_b, want_b, atol=1e-5, rtol=1e-5)


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
