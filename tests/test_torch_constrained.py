"""The port's constrained stack against the JAX reference on the CPU: the
surrogate recursion, the solvers, the constrained optimizer states,
``sample_round``'s value sums, Algorithm 2 and its general form at a small
width (P=32, J=16, L=10, I=4, B=20), and the constrained train step on
qwen2.5-3b's smoke model, with data, weights and keys carried across as
numpy.

Tolerances: the surrogate, Lemma 1 and the bisection at 1e-5 (fp32 sums in
another order). ``solve_constrained_multi`` is held to its KKT residuals,
as the reference's own randomized test holds it (one of its cases fails on
the reference, ROADMAP §3). Trajectories over 24 rounds: params, losses,
slack and the stationarity residual at atol 1e-5 (plus rtol 1e-5, as
Algorithm 1's); ν equal where Lemma 1 clips it to c. In Lemma 1's interior
ν = (√(b/disc) − 1)/τ with disc = b − 4τd: at U = 2.2 disc falls to about
b/170, so the 1e-7 relative gap that another summation order puts in the
reference's b and d reaches ν as about 2e-5 a round, and the surrogate
carries it on; ν is held there at rtol 2e-4 (it reads 5.0e-5), the params
still at 1e-5. The general form's bisection root is held alike. The slack,
0 at an interior root up to the rounding of its terms, is held at 8 ulps
of their size where those terms are large. int8 + EF: the loss at rtol
1e-3 over 12 rounds (a 1-ulp gradient difference can move one stochastic
rounding decision, as for Algorithm 1).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import codecs as jcodecs
from repro.configs.base import FLConfig as JFLConfig
from repro.configs.registry import ARCHS as JARCHS
from repro.core import algorithms as jalg
from repro.core import fed as jfed
from repro.core import optimizer as jopt
from repro.core import rounds as jrounds
from repro.core import solvers as jsol
from repro.core import surrogate as jsur
from repro.data import synthetic as jsyn
from repro.data.synthetic import classification_dataset as jdataset
from repro.launch import train as jtrain
from repro.models import get_model as jget_model
from repro.models import mlp as jmlp
from repro.models import transformer as jtr
from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.comm import codecs as tcodecs
from repro_torch.comm.error_feedback import CommCarry
from repro_torch.configs.base import FLConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import algorithms as talg
from repro_torch.core import optimizer as topt
from repro_torch.core import rounds as trounds
from repro_torch.core import solvers as tsol
from repro_torch.core import surrogate as tsur
from repro_torch.core import topology as ttopo
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from repro_torch.models import mlp as tmlp

P, J, L, I, B, N = 32, 16, 10, 4, 20, 400
C_KW = dict(num_clients=I, batch_size=B, a1=0.9, a2=0.5, alpha_rho=0.1,
            alpha_gamma=0.6, tau=0.2, constrained=True, penalty_c=1e5)


@pytest.fixture(scope="module")
def setup():
    (z, y, _), _ = jdataset(jax.random.PRNGKey(0), n=N, num_features=P,
                            num_classes=L, test_n=50, noise=4.0)
    jd = jfed.partition_samples(z, y, I)
    p0 = {k: np.asarray(v) for k, v in jmlp.init(jax.random.PRNGKey(1), P, J,
                                                 L).items()}
    return {"jd": jd, "p0": p0,
            "td": convert.sample_fed_data_from_numpy(
                *(np.asarray(a) for a in jd), device="cpu")}


def _tree(rng, scale=1.0):
    return {"w0": (rng.standard_normal((L, J)) * scale).astype(np.float32),
            "w1": (rng.standard_normal((J, P)) * scale).astype(np.float32)}


def _close(got, want, atol=1e-5, rtol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=msg)


def _slack_atol(state, tau):
    """8 fp32 ulps of the slack's terms: max(d + ⟨g, ω̄⟩ + τ‖ω̄‖², 0) is 0 at
    an interior root up to the rounding of terms the size of |d| and
    ‖g‖²/(4τ)."""
    scale = max(abs(float(state.cons.d)),
                float(torch.dot(state.g_flat, state.g_flat)) / (4 * tau))
    return 8 * float(np.spacing(np.float32(scale)))


def _tclose(tt, jt, **kw):
    for k in jt:
        _close(tt[k].numpy(), jt[k], msg=k, **kw)


@pytest.mark.parametrize("extra", [0.0, 2e-5])
@pytest.mark.parametrize("seed", [0, 1])
def test_update_surrogate_value_grad_match(seed, extra):
    rng = np.random.default_rng(seed)
    g, w, gr = _tree(rng), _tree(rng, 0.3), _tree(rng)
    d, val, rho, tau = np.float32(0.7), np.float32(2.1), np.float32(0.4), 0.2
    js = jsur.QuadSurrogate(d=jnp.asarray(d), g=jax.tree.map(jnp.asarray, g))
    ts = tsur.QuadSurrogate(d=torch.tensor(d), g=convert.params_from_numpy(g, "cpu"))
    tw = convert.params_from_numpy(w, "cpu")
    jn = jsur.update_surrogate(js, rho, w, gr, val, tau, extra_linear=extra)
    tn = tsur.update_surrogate(ts, torch.tensor(rho), tw,
                               convert.params_from_numpy(gr, "cpu"),
                               torch.tensor(val), tau, extra_linear=extra)
    _close(tn.d.numpy(), jn.d)
    _tclose(tn.g, jn.g)
    _tclose(ts.g, g, atol=0, rtol=0)                    # s is not written
    _close(tsur.surrogate_value(tn, tw, tau).numpy(),
           jsur.surrogate_value(jn, w, tau))
    _tclose(tsur.surrogate_grad(tn, tw, tau), jsur.surrogate_grad(jn, w, tau))
    init = tsur.init_surrogate(tw)
    assert init.d.item() == 0 and all(float(v.abs().sum()) == 0
                                      for v in init.g.values())


@pytest.mark.parametrize("n", [1, 999, 1000, 1001, 10_007])
def test_chunks_cover_the_buffer_once(monkeypatch, n):
    """The in-place passes visit every element of the flat buffer once, in
    order, whether n is below, at or past a multiple of CHUNK."""
    monkeypatch.setattr(tsur, "CHUNK", 1000)
    assert [i for sl in tsur.chunks(n) for i in range(n)[sl]] == list(range(n))


def test_chunked_recursion_matches_one_chunk(monkeypatch):
    """The in-place recursion a chunk at a time (the train size's path) gives
    the one-chunk result: only the fp32 sums' order differs."""
    rng = np.random.default_rng(4)
    n = 10_007
    g0, w, gr = (torch.from_numpy(rng.standard_normal(n).astype(np.float32))
                 for _ in range(3))
    outs = []
    for size in (1 << 25, 1000):
        monkeypatch.setattr(tsur, "CHUNK", size)
        g = g0.clone()
        d, b = tsur.update_surrogate_((g,), torch.tensor(0.3), 0.6, (w,),
                                      (gr.to(torch.bfloat16),),
                                      torch.tensor(1.0), 0.2)
        outs.append((g, d, b))
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=0, rtol=0)
    torch.testing.assert_close(outs[1][1], outs[0][1], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(outs[1][2], outs[0][2], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,d1", [(4.0, 0.5), (4.0, -3.0), (4.0, 4.9),
                                  (4.0, 5.1), (1e-3, 1e-3), (30.0, 37.4)])
def test_lemma1_nu_matches(b, d1):
    for tau, c in ((0.2, 1e5), (0.05, 10.0)):
        want = jsol.lemma1_nu(jnp.float32(b), jnp.float32(d1), tau, c)
        got = tsol.lemma1_nu(torch.tensor(b), torch.tensor(d1), tau, c)
        _close(got.numpy(), want)


@pytest.mark.parametrize("d1", [-3.0, -0.2, 0.0, 0.3, 5.0])
@pytest.mark.parametrize("seed", [0, 7])
def test_solve_constrained_single_matches(seed, d1):
    """Gram scalars of order 1 (g scaled by 0.05): with ‖g‖² in the hundreds
    φ(ν) is a difference of terms near 250, whose fp32 ulps alone move a
    root near 0 by more than 1e-5."""
    rng = np.random.default_rng(seed)
    g0, g1 = _tree(rng, 0.05), _tree(rng, 0.05)
    for tau0, tauc, c in ((0.2, 0.2, 1e5), (1.0, 0.05, 10.0)):
        js = jsol.solve_constrained_single(
            g0, tau0, jsur.QuadSurrogate(d=jnp.float32(d1), g=g1), tauc, c)
        ts = tsol.solve_constrained_single(
            convert.params_from_numpy(g0, "cpu"), tau0,
            tsur.QuadSurrogate(d=torch.tensor(d1, dtype=torch.float32),
                               g=convert.params_from_numpy(g1, "cpu")),
            tauc, c)
        _close(ts.nu.numpy(), js.nu)
        _close(ts.slack.numpy(), js.slack)
        _tclose(ts.omega_bar, js.omega_bar)
    _tclose(tsol.solve_unconstrained(convert.params_from_numpy(g0, "cpu"), 0.2),
            jsol.solve_unconstrained(g0, 0.2))


def test_lemma1_agrees_with_bisection():
    """The closed form is the bisection's root when g0 = 0 and τ0 = 1, to
    the reference test's 1e-2·(1 + ν)."""
    g1 = torch.from_numpy(np.random.default_rng(3).standard_normal(32)
                          .astype(np.float32))
    for d1 in (-0.5, 0.0, 0.3, 5.0):
        tau, c = 0.2, 100.0
        cons = tsur.QuadSurrogate(d=torch.tensor(d1), g=g1)
        nu_l = float(tsol.lemma1_nu(torch.sum(g1 * g1), torch.tensor(d1), tau, c))
        sol = tsol.solve_constrained_single(torch.zeros(32), 1.0, cons, tau, c)
        assert abs(nu_l - float(sol.nu[0])) < 1e-2 * (1 + nu_l), (d1, nu_l, sol.nu)


@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 5, 365484909])
def test_solve_constrained_multi_meets_kkt(seed, m):
    """Projected dual ascent lands on a KKT point of Problem 5 for any mix of
    active and inactive constraints (offsets d_m in [-2, 2]), by the
    reference test's yardstick; seed 365484909 with m=1 at τ = τ0 = 0.25 is
    the case the reference's own test fails on."""
    rng = np.random.default_rng(seed)
    tau = tau0 = 0.25
    g0 = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    gs = [torch.from_numpy(rng.standard_normal(8).astype(np.float32))
          for _ in range(m)]
    ds = torch.from_numpy(rng.uniform(-2.0, 2.0, m).astype(np.float32))
    c = 10.0
    cons = [tsur.QuadSurrogate(d=ds[j], g=gs[j]) for j in range(m)]
    sol = tsol.solve_constrained_multi(g0, tau0, cons, tau, c, iters=3000)
    w, nu, slack = sol.omega_bar, sol.nu.numpy(), sol.slack.numpy()
    fvals = np.array([float(ds[j] + gs[j] @ w + tau * (w @ w)) for j in range(m)])
    nu_scale = 1.0 + float(nu.sum())
    res = tsol.kkt_residuals(g0 + 2 * tau0 * w,
                             [gs[j] + 2 * tau * w for j in range(m)],
                             fvals - slack, sol.nu)
    assert float(res["stationarity"]) < 2e-2 * nu_scale
    assert float(res["violation"]) < 1e-3
    assert (nu >= -1e-6).all() and (nu <= c + 1e-6).all()
    for j in range(m):
        if slack[j] > 1e-4:               # paid slack => multiplier at cap
            assert abs(nu[j] - c) < 1e-2
        if fvals[j] < slack[j] - 1e-2:    # strictly inactive => nu ~ 0
            assert nu[j] < 1e-2 * nu_scale


def test_solve_constrained_multi_default_iters_match_reference():
    """At the default 200 steps the port's ascent follows the reference's."""
    rng = np.random.default_rng(2)
    g0 = rng.standard_normal(8).astype(np.float32)
    gs = [rng.standard_normal(8).astype(np.float32) for _ in range(2)]
    ds = np.array([0.5, -0.3], np.float32)
    js = jsol.solve_constrained_multi(
        g0, 0.3, [jsur.QuadSurrogate(d=ds[j], g=gs[j]) for j in range(2)], 0.2, 10.0)
    ts = tsol.solve_constrained_multi(
        torch.from_numpy(g0), 0.3,
        [tsur.QuadSurrogate(d=torch.tensor(ds[j]), g=torch.from_numpy(gs[j]))
         for j in range(2)], 0.2, 10.0)
    _close(ts.nu.numpy(), js.nu)
    _close(ts.slack.numpy(), js.slack)
    _close(ts.omega_bar.numpy(), js.omega_bar)


def test_kkt_residuals_and_best_nu_match():
    rng = np.random.default_rng(8)
    og, cg1, cg2 = _tree(rng), _tree(rng), _tree(rng)
    vals, nu = np.array([0.3, -0.2], np.float32), np.array([0.5, 2.0], np.float32)
    jr = jsol.kkt_residuals(og, [cg1, cg2], vals, nu)
    tr = tsol.kkt_residuals(*(convert.params_from_numpy(t, "cpu")
                              for t in (og,)),
                            [convert.params_from_numpy(t, "cpu") for t in (cg1, cg2)],
                            torch.from_numpy(vals), torch.from_numpy(nu))
    for k in jr:
        _close(tr[k].numpy(), jr[k], msg=k)
    _close(tsol.kkt_best_nu(convert.params_from_numpy(og, "cpu"),
                            convert.params_from_numpy(cg1, "cpu")).numpy(),
           jsol.kkt_best_nu(og, cg1))


def test_sample_round_value_sums_at_paper_width():
    """sample_round(with_value=True) at the paper's width (P=784, J=128,
    L=10, I=10, B=100; 600 samples a client): the per-client value sums
    Algorithm 2 reads, their aggregate and the gradient, against the
    reference at 1e-5 (relative; sums over 100 samples)."""
    from repro.core import fed as jfed_
    from repro_torch.core import fed as tfed_
    (z, y, _), _ = jdataset(jax.random.PRNGKey(0), n=6000, num_features=784,
                            num_classes=10, test_n=10, noise=4.0)
    jd = jfed_.partition_samples(z, y, 10)
    td = convert.sample_fed_data_from_numpy(*(np.asarray(a) for a in jd),
                                            device="cpu")
    p0 = {k: np.asarray(v) for k, v in jmlp.init(jax.random.PRNGKey(1), 784,
                                                 128, 10).items()}
    jkey = jax.random.PRNGKey(3)
    jg, jv, ju = jfed_.sample_round(jmlp.per_sample_loss, p0, jd, jkey, 100,
                                    with_value=True)
    tg, tv, tu = tfed_.sample_round(tmlp.per_sample_loss,
                                    convert.params_from_numpy(p0, "cpu"), td,
                                    convert.key_from_numpy(np.asarray(jkey), "cpu"),
                                    100, with_value=True)
    assert tuple(tu["q_value_sums"].shape) == (10,)
    _close(tu["q_value_sums"].numpy(), ju["q_value_sums"], atol=0, rtol=1e-5)
    _close(tv.numpy(), jv, atol=0, rtol=1e-5)
    for k in jg:
        _close(tg[k].numpy(), jg[k], msg=k)


def _run2(s, rounds, cost_limit, general=False, jcodec=None, tcodec=None):
    kw = dict(C_KW, cost_limit=cost_limit)
    jkey = jax.random.PRNGKey(3)
    tkey = convert.key_from_numpy(np.asarray(jkey), "cpu")
    jp = {k: jnp.asarray(v) for k, v in s["p0"].items()}
    tp = convert.params_from_numpy(s["p0"], "cpu")
    if general:
        jl = (jmlp.per_sample_loss, jmlp.per_sample_loss)
        tl = (tmlp.per_sample_loss, tmlp.per_sample_loss)
        rj = jalg.algorithm2_general(*jl, jp, s["jd"], JFLConfig(**kw), rounds,
                                     jkey, codec=jcodec)
        rt = talg.algorithm2_general(*tl, tp, s["td"], FLConfig(**kw), rounds,
                                     tkey, codec=tcodec, device="cpu")
    else:
        rj = jalg.algorithm2(jmlp.per_sample_loss, jp, s["jd"], JFLConfig(**kw),
                             rounds, jkey, codec=jcodec)
        rt = talg.algorithm2(tmlp.per_sample_loss, tp, s["td"], FLConfig(**kw),
                             rounds, tkey, codec=tcodec, device="cpu")
    return rj, rt


@pytest.mark.parametrize("general", [False, True], ids=["alg2", "alg2_general"])
@pytest.mark.parametrize("cost_limit,nu_rtol", [(1.5, 1e-5), (2.2, 2e-4)],
                         ids=["nu_clipped", "nu_interior"])
def test_algorithm2_trajectory_matches(setup, general, cost_limit, nu_rtol):
    rj, rt = _run2(setup, 24, cost_limit, general)
    assert set(rt.history) == set(rj.history)
    nus = rt.history["round_nu"].numpy()
    if nu_rtol == 1e-5:
        assert (nus == 1e5).all(), nus
    else:
        assert ((nus > 0) & (nus < 1e5)).any(), nus
    for k, v in rj.history.items():
        _close(rt.history[k].numpy(), v, atol=1e-5,
               rtol=nu_rtol if k == "round_nu" else 1e-5, msg=k)
    _tclose(rt.params, rj.params)
    key = "round_cons_est" if general else "round_loss_est"
    assert key in rt.history and rt.final_state.t == 25
    want_bytes = (I * 4 * (L * J + J * P) if general else 0) + I * (4 * (L * J + J * P) + 4)
    assert float(rt.history["round_upload_bytes"][0]) == want_bytes


@pytest.mark.parametrize("general", [False, True], ids=["alg2", "alg2_general"])
def test_algorithm2_int8_ef_loss_matches(setup, general):
    jc = jcodecs.StochasticQuantizer(bits=8, impl="pallas", interpret=True)
    object.__setattr__(jc, "name", "int8")
    rj, rt = _run2(setup, 12, 2.2, general, jc, tcodecs.make_codec("int8"))
    key = "round_cons_est" if general else "round_loss_est"
    _close(rt.history[key].numpy(), rj.history[key], atol=0, rtol=1e-3)
    np.testing.assert_array_equal(rt.history["round_upload_bytes"].numpy(),
                                  np.asarray(rj.history["round_upload_bytes"]))
    assert isinstance(rt.final_state, CommCarry)
    ef = rt.final_state.ef
    if general:
        assert set(ef) == {"obj", "cons"} and ef["obj"].shape == (I, L * J + J * P)
    assert torch.isfinite(rt.history["round_ef_norm"]).all()


def test_constrained_state_round_trip_and_mid_trajectory_step(setup):
    """A reference state after 3 steps, carried across: one more step on
    both sides agrees (params, ν, slack, the surrogate)."""
    rng = np.random.default_rng(6)
    fl_j, fl_t = JFLConfig(**dict(C_KW, cost_limit=2.2)), FLConfig(**dict(C_KW, cost_limit=2.2))
    js = jopt.ssca_constrained_init({k: jnp.asarray(v) for k, v in setup["p0"].items()})
    grads = [_tree(rng, 0.5) for _ in range(4)]
    for g in grads[:3]:
        js = jopt.ssca_constrained_step(js, g, jnp.float32(2.5), fl_j)
    ts = convert.ssca_constrained_state_from_numpy(
        jax.tree.map(np.asarray, js.params), jax.tree.map(np.asarray, js.cons.g),
        js.cons.d, js.t, js.nu, js.slack, fl_t.tau, device="cpu")
    back = convert.ssca_constrained_state_to_numpy(ts)
    assert back["t"] == 4 and np.array_equal(back["cons_d"], np.asarray(js.cons.d))
    _tclose({k: torch.from_numpy(v) for k, v in back["cons_g"].items()}, js.cons.g,
            atol=0, rtol=0)
    js = jopt.ssca_constrained_step(js, grads[3], jnp.float32(2.5), fl_j)
    ts = topt.ssca_constrained_step(ts, convert.params_from_numpy(grads[3], "cpu"),
                                    torch.tensor(2.5), fl_t)
    _tclose(ts.params, js.params)
    _tclose(ts.cons.g, js.cons.g)
    for a, b in ((ts.nu, js.nu), (ts.cons.d, js.cons.d)):
        _close(a.numpy(), b, rtol=1e-4)
    _close(ts.slack.numpy(), js.slack, atol=_slack_atol(ts, fl_t.tau))
    assert ts.t == 5


def test_general_constrained_step_matches():
    rng = np.random.default_rng(9)
    p0 = _tree(rng, 0.3)
    fl_j = JFLConfig(**dict(C_KW, cost_limit=1.0))
    fl_t = FLConfig(**dict(C_KW, cost_limit=1.0))
    js = jopt.ssca_general_constrained_init(jax.tree.map(jnp.asarray, p0))
    ts = topt.ssca_general_constrained_init(convert.params_from_numpy(p0, "cpu"))
    for _ in range(3):
        og, cg = _tree(rng), _tree(rng)
        js = jopt.ssca_general_constrained_step(js, og, cg, jnp.float32(1.4), fl_j)
        ts = topt.ssca_general_constrained_step(
            ts, convert.params_from_numpy(og, "cpu"),
            convert.params_from_numpy(cg, "cpu"), torch.tensor(1.4), fl_t)
    _tclose(ts.params, js.params)
    _tclose(ts.obj_g, js.obj_g)
    _tclose(ts.cons.g, js.cons.g)
    _close(ts.nu.numpy(), js.nu, rtol=1e-4)
    _close(ts.slack.numpy(), js.slack, atol=_slack_atol(ts, fl_t.tau))
    # every view points into the flat buffers
    assert ts.params["w0"].data_ptr() == ts.w_flat.data_ptr()
    assert ts.obj_g["w0"].data_ptr() == ts.obj_flat.data_ptr()


# ---------------------------------------------------------------------------
# the constrained train step on qwen2.5-3b's smoke model
# ---------------------------------------------------------------------------

JCFG = JARCHS["qwen2.5-3b"].smoke()
TCFG = get_config("qwen2.5-3b").smoke()
TRAIN_KW = dict(a1=0.9, a2=0.5, alpha_rho=0.1, alpha_gamma=0.6, tau=0.2,
                l2_lambda=1e-5, cost_limit=3.0)


def _named(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _named(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _accurate_reference_dots(monkeypatch):
    """The reference's ``tree_dot`` is a sum of ``jnp.vdot``s, whose XLA CPU
    lowering accumulates the smoke model's 1.3 M-element fp32 sums 4e-5 off:
    its ‖ω‖² reads 4138.327 where float64 gives 4138.497 and ``jnp.sum`` of
    the products, like the port's ``torch.dot``, 4138.4971. Lemma 1's ν
    amplifies that gap (d = ... + τ‖ω‖² is near 830), so the constrained
    reference is run with ``jnp.sum`` of the products in its surrogate,
    optimizer and solver modules; the JAX package's files are untouched."""
    def tree_dot(x, y):
        return sum(jnp.sum(u.astype(jnp.float32) * v.astype(jnp.float32))
                   for u, v in zip(jax.tree.leaves(x), jax.tree.leaves(y)))

    for mod in (jsur, jopt, jsol):
        monkeypatch.setattr(mod, "tree_dot", tree_dot)
        monkeypatch.setattr(mod, "tree_l2sq", lambda x: tree_dot(x, x))


def test_reference_vdot_sum_is_the_gap():
    """The port's fp32 sums at the smoke size sit within 1e-6 of float64;
    the reference's vdot-based one does not (the reason for the swap
    above)."""
    jp = jtr.init(jax.random.PRNGKey(0), JCFG)
    exact = sum(float(np.sum(np.asarray(a, np.float64) ** 2))
                for a in jax.tree.leaves(jp))
    flat = convert.tensor_from_numpy(np.concatenate(
        [np.asarray(a).ravel() for a in jax.tree.leaves(jp)]), "cpu")
    assert abs(ttrain._sq_norm((flat,)).item() - exact) <= 1e-6 * exact
    ref = float(jsur.tree_l2sq(jp))
    assert abs(ref - exact) > 1e-5 * exact, (ref, exact)


@pytest.mark.parametrize("cost_limit", [3.0, 5.5])
def test_constrained_train_trajectory_matches_reference(cost_limit,
                                                        monkeypatch):
    """4 steps of make_scanned_step(constrained=True) from the same weights,
    tokens and round inputs as the reference's: loss, ν, slack and ‖ω‖² each
    step, the params after step 4. U = 3.0 is train_loop's default; at 5.5
    (below the smoke model's first loss, 6.3) ν leaves c."""
    _accurate_reference_dots(monkeypatch)
    steps, batch, seq = 4, 2, 16
    jp = jtr.init(jax.random.PRNGKey(0), JCFG)
    npp = jax.tree.map(np.asarray, jp)
    jkey = jax.random.fold_in(jax.random.PRNGKey(0), 1)
    jtoks = jsyn.token_dataset(jkey, JCFG.vocab_size, 2000)
    ttoks = tsyn.token_dataset(convert.key_from_numpy(np.asarray(jkey), "cpu"),
                               TCFG.vocab_size, 2000)
    kw = dict(TRAIN_KW, cost_limit=cost_limit)
    jfl, tfl = JFLConfig(**kw), FLConfig(**kw)
    jstep = jtrain.make_scanned_step(jget_model(JCFG), JCFG, jfl, jtoks, batch,
                                     seq, constrained=True)
    tstep = ttrain.make_scanned_step(tapi.get_model(TCFG), TCFG, tfl, ttoks,
                                     batch, seq, constrained=True)
    jin = jrounds.make_inputs(jfl, 1, steps, jax.random.PRNGKey(9))
    tin = trounds.make_inputs(tfl, 1, steps, rnd.PRNGKey(9, device="cpu"))
    jstate, jms = jrounds.loop_rounds(jstep, jopt.ssca_constrained_init(jp), jin)
    tstate, tms = trounds.ENGINES["scan"](tstep, topt.ssca_constrained_init(
        convert.params_from_numpy(npp, "cpu")), tin)
    assert set(tms) == set(jms) == {"loss", "nu", "slack", "l2"}
    for k in ("loss", "nu", "l2"):
        _close(tms[k].numpy(), jms[k], atol=1e-5, rtol=1e-5, msg=k)
    # d is near 700 here (fp32 ulp 6.1e-5)
    _close(tms["slack"].numpy(), jms["slack"],
           atol=_slack_atol(tstate, tfl.tau), msg="slack")
    got = dict(_named(convert.params_to_numpy(tstate.params)))
    want = dict(_named(jax.tree.map(np.asarray, jstate.params)))
    for k in want:
        _close(got[k], want[k], atol=1e-5, rtol=0, msg=k)
    assert tstate.t == steps + 1


def test_constrained_train_loop_runs_the_smoke_model(capsys):
    state, logs = ttrain.train_loop("qwen2.5-3b", 3, 2, 8, smoke=True,
                                    constrained=True, log_every=1,
                                    device="cpu")
    assert isinstance(state, topt.SSCAConstrainedState) and state.t == 4
    for m in logs:
        assert all(np.isfinite(m[k]) for k in ("loss", "nu", "slack", "l2"))
        assert 0.0 <= m["nu"] <= TRAIN_KW.get("penalty_c", 1e5)
        assert m["slack"] >= 0.0
    out = capsys.readouterr().out
    assert "nu=" in out and "slack=" in out


def test_constrained_cli_smoke(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
        "--constrained", "--cost-limit", "4.5", "--steps", "2", "--batch", "2",
        "--seq", "8"])
    ttrain.main()
    assert "nu=" in capsys.readouterr().out


def test_constrained_steps_refuse_an_unported_option(setup):
    """participation= is ported (S = 2 of 4 runs as the reference does),
    and so is the sharded topology (one rank: the local run's params)."""
    fl_kw = dict(C_KW, cost_limit=2.0)
    rt = talg.algorithm2(tmlp.per_sample_loss,
                         convert.params_from_numpy(setup["p0"], "cpu"),
                         setup["td"], FLConfig(**fl_kw), 2,
                         rnd.PRNGKey(0, device="cpu"), participation=2,
                         device="cpu")
    rj = jalg.algorithm2(jmlp.per_sample_loss,
                         {k: jnp.asarray(v) for k, v in setup["p0"].items()},
                         setup["jd"], JFLConfig(**fl_kw), 2,
                         jax.random.PRNGKey(0), participation=2)
    _tclose(rt.params, rj.params)
    _close(rt.history["round_upload_bytes"].numpy(),
           rj.history["round_upload_bytes"], atol=0, rtol=0)
    fl = dataclasses.replace(FLConfig(), cost_limit=2.0)
    runs = [talg.algorithm2_general(
        tmlp.per_sample_loss, tmlp.per_sample_loss,
        convert.params_from_numpy(setup["p0"], "cpu"), setup["td"], fl, 2,
        rnd.PRNGKey(0, device="cpu"), topology=topo, device="cpu")
        for topo in (ttopo.make_topology("sharded", device="cpu"), None)]
    _tclose(runs[0].params, convert.params_to_numpy(runs[1].params))
