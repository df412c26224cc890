"""The port's model, schedules, tree helpers and SSCA optimizer against the
JAX reference on the same numpy inputs.

Tolerances: the MLP's loss and gradients 1e-6 absolute / 1e-5 relative
(fp32 matmuls summed in another order); init draws through erfinv, 1e-5;
ssca_step 1e-6 per step (the same fp32 formula, one rounding apart at
most); Remark 2 inside the port 1e-5 over 8 steps, as the reference's own
equivalence test allows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFLConfig
from repro.core import optimizer as jopt
from repro.core import schedules as jsched
from repro.core import tree as jtree
from repro.models import mlp as jmlp
from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.configs.base import MNIST_MLP, FLConfig
from repro_torch.core import optimizer as topt
from repro_torch.core import schedules as tsched
from repro_torch.core import tree as ttree
from repro_torch.models import mlp as tmlp

FL_KW = dict(num_clients=4, batch_size=20, a1=0.3, a2=0.3, alpha_rho=0.1,
             alpha_gamma=0.6, tau=0.05, l2_lambda=1e-5)


def _params(seed=0, p=32, j=16, l=10):
    rng = np.random.default_rng(seed)
    return {"w0": (rng.standard_normal((l, j)) / 4).astype(np.float32),
            "w1": (rng.standard_normal((j, p)) / 6).astype(np.float32)}


def _batch(seed=1, b=24, p=32, l=10):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((b, p)).astype(np.float32)
    lab = rng.integers(0, l, b)
    return z, np.eye(l, dtype=np.float32)[lab], lab.astype(np.int32)


def _t(tree):
    return convert.params_from_numpy(tree, device="cpu")


def test_fl_config_and_paper_widths_match_reference():
    assert FLConfig() .__dict__ == JFLConfig().__dict__
    assert FLConfig(**FL_KW).__dict__ == JFLConfig(**FL_KW).__dict__
    assert MNIST_MLP.num_params == 784 * 128 + 128 * 10 == 101_632


def test_mlp_forward_loss_accuracy_match():
    p, (z, y, lab) = _params(), _batch()
    jp, tp = {k: jnp.asarray(v) for k, v in p.items()}, _t(p)
    tz, ty = torch.from_numpy(z), torch.from_numpy(y)
    np.testing.assert_allclose(tmlp.logits(tp, tz).numpy(),
                               np.asarray(jmlp.logits(jp, z)), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(tmlp.per_sample_loss(tp, tz, ty).numpy(),
                               np.asarray(jmlp.per_sample_loss(jp, z, y)),
                               atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(float(tmlp.mean_loss(tp, tz, ty)),
                               float(jmlp.mean_loss(jp, z, y)), rtol=1e-6)
    assert float(tmlp.accuracy(tp, tz, torch.from_numpy(lab))) == float(
        jmlp.accuracy(jp, z, lab))
    np.testing.assert_allclose(float(tmlp.l2_sq(tp)), float(jmlp.l2_sq(jp)),
                               rtol=1e-6)
    np.testing.assert_allclose(tmlp.swish(tz).numpy(),
                               np.asarray(jmlp.swish(z)), atol=1e-6)


def test_mlp_gradient_matches_jax_grad():
    p, (z, y, _) = _params(2), _batch(3)
    jg = jax.grad(lambda q: jnp.sum(jmlp.per_sample_loss(q, z, y)))(
        {k: jnp.asarray(v) for k, v in p.items()})
    tg = torch.func.grad(lambda q: torch.sum(tmlp.per_sample_loss(
        q, torch.from_numpy(z), torch.from_numpy(y))))(_t(p))
    for k in p:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   atol=1e-6, rtol=1e-5)


def test_mlp_broadcasts_over_a_client_axis():
    """The port's MLP takes a stacked (I, ...) client axis in one call."""
    p, (z, y, _) = _params(), _batch()
    tp = _t(p)
    stacked = {k: v.expand(3, *v.shape) for k, v in tp.items()}
    zz = torch.from_numpy(np.stack([z, z * 0.5, -z]))
    yy = torch.from_numpy(np.stack([y] * 3))
    got = tmlp.per_sample_loss(stacked, zz, yy)
    for i in range(3):
        torch.testing.assert_close(got[i], tmlp.per_sample_loss(tp, zz[i], yy[i]))


def test_mlp_init_matches_reference_draws():
    jp = jmlp.init(jax.random.PRNGKey(1), 40, 16, 10)
    tp = tmlp.init(rnd.PRNGKey(1, device="cpu"), 40, 16, 10, device="cpu")
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("a,alpha", [(0.3, 0.1), (0.9, 0.6), (2.0, 0.3)])
def test_schedules_match(a, alpha):
    t = np.arange(0, 300)
    np.testing.assert_allclose(tsched.rho(torch.from_numpy(t), a, alpha).numpy(),
                               np.asarray(jsched.rho(jnp.asarray(t), a, alpha)),
                               rtol=1e-6)
    np.testing.assert_allclose(
        tsched.gamma(torch.from_numpy(t), a, alpha).numpy(),
        np.asarray(jsched.gamma(jnp.asarray(t), a, alpha)), rtol=1e-6)
    for args in [(a, a, alpha, 0.6), (0.3, 0.3, 0.1, 0.1), (1.0, 1.0, 0.0, 1.5)]:
        assert tsched.check_conditions(*args) == jsched.check_conditions(*args)


def test_tree_helpers_match():
    x, y = _params(4), _params(5)
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    jy = {k: jnp.asarray(v) for k, v in y.items()}
    tx, ty = _t(x), _t(y)
    np.testing.assert_allclose(float(ttree.tree_dot(tx, ty)),
                               float(jtree.tree_dot(jx, jy)), rtol=1e-5)
    np.testing.assert_allclose(float(ttree.tree_l2sq(tx)),
                               float(jtree.tree_l2sq(jx)), rtol=1e-5)
    ax = ttree.tree_axpy(0.3, tx, -1.5, ty)
    jax_ax = jtree.tree_axpy(0.3, jx, -1.5, jy)
    for k in x:
        np.testing.assert_allclose(ax[k].numpy(), np.asarray(jax_ax[k]),
                                   rtol=1e-6, atol=1e-7)
    z = ttree.tree_zeros_like(tx, torch.float32)
    assert all(not v.any() and v.dtype == torch.float32 for v in z.values())
    assert [tuple(v.shape) for v in ttree.leaves(tx)] == [
        l.shape for l in jax.tree.leaves(jx)]


def _grads(steps, seed=7):
    rng = np.random.default_rng(seed)
    shapes = {k: v.shape for k, v in _params().items()}
    return [{k: rng.standard_normal(s).astype(np.float32) for k, s in
             shapes.items()} for _ in range(steps)]


def test_ssca_step_matches_reference():
    """Scheduled (rho_t=None) and given (ρ, γ) steps both agree."""
    fl_j, fl_t = JFLConfig(**FL_KW), FLConfig(**FL_KW)
    p = _params(6)
    js = jopt.ssca_init({k: jnp.asarray(v) for k, v in p.items()})
    ts = topt.ssca_init(_t(p))
    for i, g in enumerate(_grads(6)):
        if i < 3:
            js = jopt.ssca_step(js, {k: jnp.asarray(v) for k, v in g.items()},
                                fl_j)
            ts = topt.ssca_step(ts, _t(g), fl_t)
        else:
            r, gm = np.float32(0.2 + 0.1 * i), np.float32(0.5 / i)
            js = jopt.ssca_step(js, {k: jnp.asarray(v) for k, v in g.items()},
                                fl_j, rho_t=jnp.float32(r), gamma_t=jnp.float32(gm))
            ts = topt.ssca_step(ts, ttree.flatten(_t(g)), fl_t,
                                rho_t=torch.tensor(r), gamma_t=torch.tensor(gm))
        assert ts.t == int(js.t)
        for k in p:
            np.testing.assert_allclose(ts.params[k].numpy(),
                                       np.asarray(js.params[k]), atol=1e-6,
                                       rtol=1e-6)
            np.testing.assert_allclose(ts.g[k].numpy(), np.asarray(js.g[k]),
                                       atol=1e-6, rtol=1e-6)


def test_ssca_step_is_in_place_on_flat_views():
    p = _t(_params(8))
    original = {k: v.clone() for k, v in p.items()}
    st = topt.ssca_init(p)
    for k in p:                              # the caller's params are copied
        assert st.params[k].data_ptr() != p[k].data_ptr()
        assert st.params[k]._base is st.w_flat and st.g[k]._base is st.g_flat
    new = topt.ssca_step(st, _t(_grads(1)[0]), FLConfig(**FL_KW))
    assert new.w_flat is st.w_flat and new.t == 2
    for k in p:
        assert torch.equal(p[k], original[k])
        assert torch.equal(new.params[k], st.params[k])      # shared buffer
        assert not torch.equal(new.params[k], original[k])


def test_ssca_state_converts_both_ways():
    p = _params(9)
    js = jopt.ssca_init({k: jnp.asarray(v) for k, v in p.items()})
    js = jopt.ssca_step(js, {k: jnp.ones_like(v) for k, v in js.params.items()},
                        JFLConfig(**FL_KW))
    ts = convert.ssca_state_from_numpy(
        {k: np.asarray(v) for k, v in js.params.items()},
        {k: np.asarray(v) for k, v in js.g.items()}, np.asarray(js.t),
        device="cpu")
    back = convert.ssca_state_to_numpy(ts)
    assert back["t"] == 2
    for k in p:
        np.testing.assert_array_equal(back["params"][k], np.asarray(js.params[k]))
        np.testing.assert_array_equal(back["g"][k], np.asarray(js.g[k]))


def test_remark2_momentum_form_equals_ssca_step():
    """Remark 2 inside the port: eqs. (11)-(12) give ssca_step's iterates."""
    fl = FLConfig(**FL_KW)
    p = _t(_params(10))
    s = topt.ssca_init(p)
    m = topt.momentum_form_init(p)
    for g in _grads(8, seed=11):
        s = topt.ssca_step(s, _t(g), fl)
        m = topt.momentum_form_step(m, _t(g), fl)
        for k in p:
            np.testing.assert_allclose(m.params[k].numpy(),
                                       s.params[k].numpy(), atol=1e-5,
                                       rtol=1e-5)


@pytest.mark.parametrize("tau", [0.05, 0.2])
def test_fused_sgd_momentum_form_is_the_ssca_update(tau):
    """Remark 2 (eqs. (11)-(12)) as one PyTorch call: ``torch._fused_sgd_``
    with momentum (1-ρ)(1-γ_prev), dampening 1-ρ/(2τ), weight decay 2λ and
    lr γ gives ssca_update's w over 5 rounds at the paper's 101,632 fp32
    parameters, from ρ = 1. It reads w, g and v and writes w and v, the
    kernel's five streams, so chip_smoke.py times it as the kernel's library
    yardstick; the port never calls it. Round 1 has momentum 0, which
    _fused_sgd_ refuses with a buffer list: momentum_form_step takes it.
    Tolerance 1e-5 (absolute plus relative): the two forms round apart."""
    from repro_torch.kernels import ssca_update
    fl = FLConfig(**dict(FL_KW, tau=tau))
    n = MNIST_MLP.num_params
    rng = np.random.default_rng(12)
    w0 = torch.from_numpy((rng.standard_normal(n) / 10).astype(np.float32))
    w_ssca, buf = w0.clone(), torch.zeros(n)
    mom = topt.momentum_form_init({"w": w0.clone()})
    v = w = None
    for t in range(1, 6):
        g = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        rho, gamma = topt._sched(fl, t)
        assert t > 1 or float(rho) == 1.0
        ssca_update.ssca_update_(w_ssca, buf, g, rho, gamma, fl.tau, fl.l2_lambda)
        if t == 1:
            mom = topt.momentum_form_step(mom, {"w": g}, fl, rho, gamma)
            w, v = mom.params["w"], mom.v["w"]
        else:
            torch._fused_sgd_([w], [g], [v], weight_decay=2 * fl.l2_lambda,
                              momentum=(1 - float(rho)) * (1 - gamma_prev),
                              lr=float(gamma),
                              dampening=1 - float(rho) / (2 * fl.tau),
                              nesterov=False, maximize=False,
                              is_first_step=False)
        gamma_prev = float(gamma)
        np.testing.assert_allclose(w.numpy(), w_ssca.numpy(), atol=1e-5,
                                   rtol=1e-5)
