"""The roofline layer (``repro_torch.roofline``) against the reference's
``repro.roofline`` where it runs:

- ``count_params``/``active_params`` equal to the reference's on the same
  init trees (every ASSIGNED arch at the smoke size, a dense and an MoE
  arch at full size: the port's from init on the meta device, the
  reference's from ``jax.eval_shape``);
- ``roofline_terms``' three bottleneck cases on ``HW`` (H100 data-sheet
  constants);
- the cost counter on the reference's two ``test_infra.py`` cases: a
  loop-free two-matmul function (FLOPs at rtol 1e-6 of the reference's
  HLO count) and 12 looped (64, 64) matmuls (the reference's while
  multiplier; here every loop iteration is seen), on CPU and meta tensors;
- each kernel wrapper on the meta device (shapes and dtypes of the
  kernel's outputs, nothing computed) and under the counter on every
  device: one launch at its work formula's FLOPs and bytes, the plain
  version's own ops not counted again;
- the work formulas pinned to PERF.md's kernel table's bounds
  (``chip_smoke.py`` reads them), ``visible_pairs`` against a row-by-row
  count;
- a stand-in mesh's collectives: meta outputs, their bytes counted.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.models import get_model as jget_model
from repro.roofline import analysis as janalysis
from repro.roofline import hlo_cost
from repro_torch import random as rnd
from repro_torch.configs.registry import ASSIGNED, get_config
from repro_torch.kernels import cohort_sample as cs
from repro_torch.kernels import dp_noise as dpn
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import quantize as qz
from repro_torch.kernels import rmsnorm as rms
from repro_torch.kernels import ssca_update as ssca
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.dryrun import param_shapes
from repro_torch.models.api import get_model
from repro_torch.roofline import (HW, CostCounter, active_params, count_params,
                                  roofline_terms)
from repro_torch.roofline import cost
from repro_torch.roofline import kernels as work


@pytest.mark.parametrize("arch,full", [(a, False) for a in ASSIGNED]
                         + [("qwen2.5-3b", True), ("qwen3-moe-30b-a3b", True)])
def test_param_counts_match_reference(arch, full):
    cfg, jcfg = get_config(arch), JARCHS[arch]
    if not full:
        cfg, jcfg = cfg.smoke(), jcfg.smoke()
    params = param_shapes(get_model(cfg), cfg)
    jparams = jax.eval_shape(lambda: jget_model(jcfg).init(jax.random.PRNGKey(0), jcfg))
    assert count_params(params) == janalysis.count_params(jparams)
    assert active_params(cfg, params) == janalysis.active_params(jcfg, jparams)


def test_roofline_terms_bottleneck():
    hw = HW()
    t = roofline_terms({"flops": hw.peak_flops, "bytes": 1e9}, 0)
    assert t["bottleneck"] == "compute" and abs(t["compute_s"] - 1.0) < 1e-9
    t = roofline_terms({"flops": 1e9, "bytes": hw.hbm_bw}, 0)
    assert t["bottleneck"] == "memory" and abs(t["bound_s"] - 1.0) < 1e-9
    t = roofline_terms({"flops": 0, "bytes": 0}, hw.link_bw)
    assert t["bottleneck"] == "collective" and abs(t["collective_s"] - 1.0) < 1e-9
    # the reference's key for the bytes is read too
    assert roofline_terms({"flops": 0, "bytes accessed": hw.hbm_bw}, 0)["memory_s"] == 1.0
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw) == (989e12, 3.35e12, 450e9)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_counter_matches_reference_on_loop_free_module(device):
    def f(x, w1, w2):
        return jnp.sum(jnp.tanh(x @ w1) @ w2)

    shapes = [(64, 128), (128, 256), (256, 32)]
    compiled = jax.jit(f).lower(*[jax.ShapeDtypeStruct(s, jnp.float32)
                                  for s in shapes]).compile()
    want = hlo_cost.analyze(compiled.as_text())["flops"]
    args = [torch.randn(s, device=device) if device == "cpu" else
            torch.empty(s, device=device) for s in shapes]
    _, got = cost.count(lambda x, w1, w2: torch.sum(torch.tanh(x @ w1) @ w2), *args)
    assert abs(got["flops"] - want) / want < 1e-6
    assert got["flops"] == 2 * 64 * 128 * 256 + 2 * 64 * 256 * 32
    # operands and outputs of every op that moves data: the two products'
    # at least
    assert got["bytes"] >= 4 * (64 * 128 + 128 * 256 + 64 * 256 + 256 * 32 + 64 * 32)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_counter_sees_every_loop_iteration(device):
    def f(x, ws):
        return jax.lax.scan(lambda x, w: (jnp.tanh(x @ w), None), x, ws)[0].sum()

    compiled = jax.jit(f).lower(jax.ShapeDtypeStruct((64, 64), jnp.float32),
                                jax.ShapeDtypeStruct((12, 64, 64), jnp.float32)).compile()
    want = hlo_cost.analyze(compiled.as_text())["flops"]

    def g(x, ws):
        for w in ws:
            x = torch.tanh(x @ w)
        return x.sum()

    _, got = cost.count(g, torch.zeros(64, 64, device=device),
                        torch.zeros(12, 64, 64, device=device))
    assert got["flops"] == want == 12 * 2 * 64 ** 3


def test_counter_counts_the_backward():
    lin = torch.nn.Linear(64, 32)
    x = torch.randn(8, 64, requires_grad=True)
    with CostCounter() as c:
        lin(x).sum().backward()
    # forward, dx and dW products
    assert c.summary()["flops"] == 3 * 2 * 8 * 64 * 32


def _calls(device):
    """Each wrapper's call at a small shape, with its expected work and the
    shapes and dtypes of its outputs."""
    bf = torch.bfloat16
    mk = (lambda *s, dtype=torch.float32: torch.randn(*s).to(dtype).to(device)
          if device == "cpu" else torch.empty(*s, dtype=dtype, device=device))
    x, sc = mk(6, 64, dtype=bf), mk(64, dtype=bf)
    q, k, v = mk(2, 4, 8, 32, dtype=bf), mk(2, 2, 8, 32, dtype=bf), mk(2, 2, 8, 32, dtype=bf)
    o, lse = mk(2, 4, 8, 32, dtype=bf), mk(2, 4, 8)
    up = mk(3, 300)
    keys = rnd.split(rnd.PRNGKey(0, device=device), 3)
    w, buf, g = mk(100), mk(100), mk(100)
    f1 = torch.ones(3, device=device)
    round_keys = keys[:, 1].contiguous()
    return [
        ("rmsnorm", lambda: rms.rmsnorm(x, sc), work.rmsnorm(6, 64, 2),
         [((6, 64), bf)]),
        ("rmsnorm_bwd", lambda: rms.rmsnorm_bwd(x, sc, x), work.rmsnorm_bwd(6, 64, 2),
         [((6, 64), bf), ((64,), bf)]),
        ("flash_attention", lambda: fa.flash_attention(q, k, v, return_lse=True),
         work.flash_attention(2, 4, 2, 8, 8, 32, 2, lse=True),
         [((2, 4, 8, 32), bf), ((2, 4, 8), torch.float32)]),
        ("flash_attention_bwd", lambda: fa.flash_attention_bwd(q, k, v, o, lse, o),
         work.flash_attention_bwd(2, 4, 2, 8, 8, 32, 2),
         [((2, 4, 8, 32), bf), ((2, 2, 8, 32), bf), ((2, 2, 8, 32), bf)]),
        ("stochastic_quantize_keyed", lambda: qz.stochastic_quantize_keyed(up, keys, 127),
         work.quantize_keyed(3, 300),
         [((3, 512), torch.int8), ((3, 2), torch.float32), ((3, 300), torch.float32)]),
        ("dp_noise", lambda: dpn.dp_noise(up, keys, f1, f1, 0.5), work.dp_noise(3, 300),
         [((3, 300), torch.float32), ((3,), torch.float32)]),
        ("ssca_update", lambda: ssca.ssca_update_(w, buf, g, 0.5, 0.3, 0.2, 1e-5),
         work.ssca_update(100), [((100,), torch.float32), ((100,), torch.float32)]),
        ("cohort_sample", lambda: cs.cohort_sample(round_keys, 40, 8),
         work.cohort_sample(3, 8), [((8,), torch.int32)]),
    ]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_each_wrapper_counts_one_launch_at_its_formula(device):
    for name, call, want, outs in _calls(device):
        with CostCounter() as c:
            got = call()
        got = [got] if isinstance(got, torch.Tensor) else list(got)
        assert [(tuple(t.shape), t.dtype) for t in got] == outs, name
        assert all(t.device.type == device for t in got), name
        s = c.summary()
        assert s["kernels"] == {name: 1}, name
        # the plain version's ops are the kernel's: charged by the formula only
        assert (s["flops"], s["bytes"]) == (want.flops, want.bytes), name
        assert s["kernel_work"][name]["int_ops"] == want.int_ops, name
    assert not cost.ACTIVE and cost.INSIDE == [0]


def test_meta_wrappers_check_their_operands():
    q = torch.empty(2, 4, 8, 48, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="head dim 48"):
        fa.flash_attention(q, q[:, :2], q[:, :2])
    x = torch.empty(6, 64, device="meta")
    with pytest.raises(TypeError, match="share one dtype"):
        rms.rmsnorm(x, torch.empty(64, dtype=torch.bfloat16, device="meta"))


def test_work_formulas_pin_the_kernel_table_bounds():
    """PERF.md's kernel table (the bounds chip_smoke.py prints), in µs."""
    def us(w):
        return round(w.bound_ms()[0] * 1e3, 3)

    assert us(work.ssca_update(101_632)) == 0.607
    assert us(work.rmsnorm(4096, 2048, 2)) == 10.017
    assert us(work.flash_attention(8, 16, 2, 512, 512, 128, 2)) == 11.268
    assert us(work.flash_attention_bwd(8, 16, 2, 512, 512, 128, 2)) == 22.693
    assert work.ssca_update(101_632).bytes == 2_032_640
    assert work.flash_attention(8, 16, 2, 512, 512, 128, 2).bytes == 37_748_736
    assert work.stochastic_quantize(10, 101_632).bytes == 13_228_040


def _pairs_by_row(sq, sk, window=0, prefix=0, causal=True):
    """The row-by-row count the vectorized ``visible_pairs`` replaces."""
    if not causal:
        return sq * sk
    pairs = 0
    for i in range(sq):
        hi = min(sk, i + sk - sq + 1)
        lo = max(0, hi - window) if window else 0
        seen = max(0, hi - lo)
        pre = min(prefix, sk)
        pairs += max(hi, pre) if pre >= lo else seen + pre
    return pairs


@pytest.mark.parametrize("sq,sk,window,prefix,causal", [
    (512, 512, 0, 0, True), (1, 543, 0, 0, True), (64, 300, 16, 0, True),
    (768, 768, 0, 256, True), (100, 100, 8, 20, True), (7, 9, 0, 0, False),
    (512, 2048, 0, 0, False), (33, 64, 40, 5, True)])
def test_visible_pairs_matches_a_row_by_row_count(sq, sk, window, prefix, causal):
    assert work.visible_pairs(sq, sk, window, prefix, causal) == \
        _pairs_by_row(sq, sk, window, prefix, causal)


def test_stand_in_collectives_return_meta_outputs_and_count_bytes():
    mesh = mesh_lib.production_stand_in(multi_pod=True)
    assert mesh.shape == (2, 16, 16) and mesh_lib.axis_index(mesh, ("pod", "data")) == 0
    x = torch.empty(4, 8, device="meta")
    with CostCounter() as c:
        g = mesh_lib.all_gather_axes(x, mesh, ("pod", "data"), dim=1)
        r = mesh_lib.reduce_scatter_axes(torch.empty(32, 8, device="meta"), mesh,
                                         "model")
        a = mesh_lib.all_reduce_axes(x, mesh, "model")
    assert g.shape == (4, 256) and r.shape == (2, 8) and a is x
    coll = c.summary()["collectives"]
    # one all-gather an axis (data, then pod), one reduce-scatter, one all-reduce
    assert coll["all-gather"] == 4 * (4 * 128 + 4 * 256)
    assert coll["reduce-scatter"] == 4 * 16 and coll["all-reduce"] == 4 * 32
    with pytest.raises(ValueError, match="meta tensors"):
        mesh_lib.all_reduce_axes(torch.zeros(3), mesh, "model")
