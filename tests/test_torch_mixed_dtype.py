"""bf16 models with fp32 leaves under the constrained update and the
compressed and private uploads, against the JAX reference on the CPU.

The model is zamba2-1.2b's smoke variant with ``dtype="bfloat16"`` set back
(``smoke()`` is fp32): 1,730,128 parameters, the 16 of its Mamba2 decay
(``a_log``) and dt bias fp32, the rest bf16. The port keeps those 16 in a
second flat fp32 buffer (``w_side``); the reference flattens every leaf,
in ``jax.tree.leaves`` order, into one fp32 vector, so its fp32 leaves sit
between bf16 leaves and its 256-element codec chunks and threefry counters
straddle the leaf boundaries. ``WIDE`` cuts the same model with 256 SSM
heads, so that a_log and dt_bias take 512 entries each and a 256-element
piece boundary falls inside both.

(a) ``comm_update_`` on the (main, side) pair, codec only, equals the
    reference's ``ef_roundtrip`` on ``flatten_tree``'s vector bit for bit:
    the decoded upload in each leaf's dtype and the (P,) EF residual, at
    pieces of 256 and 512 and with piece boundaries inside a_log. With DP
    the privatized upload is within σ·3e-5 (erfinv's gap, as in
    tests/test_torch_privacy.py), and a bf16 leaf within one bf16 ulp of
    the value more (2^-7 relative: that gap may flip its rounding).
(b) Three steps of ``make_scanned_step`` under the constrained update,
    int8 + EF, DP, and int8 + DP against the reference's, from the same
    params, tokens and round keys. The loss and its gradient are the
    reference model's own, taken at the reference's state before each
    step and replayed in both packages (``_replay``): in bf16 the smoke
    model's Mamba2 gradients sit 2.5-93% (normwise per leaf) from the fp32
    gradient in either package, neither package closer over three token
    seeds, so two bf16 forwards do not give one trajectory; the replay
    holds what both steps do with one gradient. Gates: the fp32 leaves
    within 2e-5, the bf16 leaves and the surrogate buffers within one bf16
    rounding (2^-8); ‖ω‖² rtol 1e-5 and ν within 1e-5 of the float64 ν of
    the port's own inputs (``_nu64``), and of the reference's within that
    plus the reference's own distance from it (its d-based Lemma 1 loses
    digits to cancellation, tests/test_torch_constrained.py; its dots run
    as jnp.sum); the slack within 8 fp32 ulps of its terms; the DP metrics
    rtol 1e-5; upload bytes equal; the EF residual after step 1 within 2
    fp32 ulps of its largest entry (XLA fuses x - x̂ into one rounding);
    after that, and at every step with DP, normwise (``EF_NORMWISE``): an
    ulp of the carried residual moves a stochastic rounding by one level
    (1,759-2,466 of 1.73 M entries past 4 ulps, 1.8e-4 and 2.3e-4 normwise
    after steps 2-3, gate 1e-3), and with DP the normals' erfinv gap moves
    every entry (1.2e-2 to 2.0e-2, gate 5e-2); a residual that is dropped
    or not fed back reads about 1.
(c) The sharded topology on one gloo rank, and ``sharded_train_step(
    constrained=True)`` on a 1x1 mesh, each bit-equal to the local step.
(d) A constrained bf16 state and a ``CommCarry`` with its residual saved
    and read back into a fresh state's own buffers.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import codecs as jcodecs
from repro.comm import error_feedback as jef
from repro.configs.base import FLConfig as JFLConfig
from repro.configs.registry import ARCHS as JARCHS
from repro.core import optimizer as jopt
from repro.core import privacy as jpriv
from repro.core import rounds as jrounds
from repro.data import synthetic as jsyn
from repro.launch import train as jtrain
from repro.models import get_model as jget_model
from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.checkpoint import load_state_, save_state
from repro_torch.comm import codecs as tcodecs
from repro_torch.comm.error_feedback import CommCarry, ef_init
from repro_torch.configs.base import FLConfig, ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import optimizer as topt
from repro_torch.core import privacy as tpriv
from repro_torch.core import rounds as trounds
from repro_torch.core import topology as ttopo
from repro_torch.core.tree import leaves, split_runs
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi

A = "zamba2-1.2b"
JCFG = JARCHS[A].smoke(dtype="bfloat16")
TCFG = get_config(A).smoke(dtype="bfloat16")
WIDE = dict(ssm_heads=256)
BF16 = 2.0 ** -8               # one bf16 rounding
TOL = 2e-5                     # fp32 leaves
NORMAL_GAP = 3e-5              # random.normal against jax's (erfinv ulps)
DP_SMALL = dict(clip_norm=1.0, noise_multiplier=0.01)
# the train loop's FLConfig (the replayed gradient does not feed the
# steps' params back into the model, so τ = 0.2 does not diverge here)
FL_KW = dict(a1=0.9, a2=0.5, alpha_rho=0.1, alpha_gamma=0.6, tau=0.2,
             l2_lambda=1e-5, cost_limit=3.0)
B, S, STEPS = 2, 16, 3
# ‖Δef‖/‖ef‖ of the EF residual after the steps that follow one rounding
# apart (see the module's docstring), without and with DP
EF_NORMWISE = {False: 1e-3, True: 5e-2}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two PyTorch threads a process: the suite runs several at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _named(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _named(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _f32(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


@pytest.fixture(scope="module")
def ref():
    """The reference's bf16 smoke params, as jax arrays and as numpy."""
    jp = jget_model(JCFG).init(jax.random.PRNGKey(0), JCFG)
    return jp, _np_tree(jp)


def _tparams(npp):
    return convert.params_from_numpy(npp, "cpu")


def test_smoke_config_is_bf16_with_fp32_leaves(ref):
    """The config the tests use: bf16 leaves, a_log and dt_bias fp32, in
    the port's side buffer, in both packages."""
    jp, npp = ref
    state = topt.ssca_constrained_init(_tparams(npp))
    fp32 = {k for k, t in _named(state.params) if t.dtype == torch.float32}
    assert fp32 == {"mamba/a_log", "mamba/dt_bias"}
    assert {k for k, x in _named(jp) if x.dtype == jnp.float32} == fp32
    assert state.w_flat.dtype == torch.bfloat16
    assert state.w_side.numel() == state.g_side.numel() == 16
    assert state.w_flat.numel() + 16 == sum(x.size for x in jax.tree.leaves(jp))


# ---------------------------------------------------------------------------
# (a) the upload on the pair against the reference's whole-vector roundtrip
# ---------------------------------------------------------------------------


def _grad_case(cut, seed):
    """A gradient like the reference's init of the cut (each leaf in its
    param's dtype), numpy-seeded, as a jax tree, and the port's state laid
    out for it (its (main, side) buffers hold the gradient)."""
    cfg = JCFG if cut == "smoke" else JARCHS[A].smoke(dtype="bfloat16", **WIDE)
    shapes = jax.eval_shape(lambda k: jget_model(cfg).init(k, cfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    jg = jax.tree.map(lambda s: jnp.asarray(rng.standard_normal(s.shape) * 0.02,
                                            s.dtype), shapes)
    state = topt.ssca_init(_tparams(_np_tree(jg)))
    return jg, state, split_runs(state.params, torch.bfloat16)


def _inside_side_run(runs, piece) -> bool:
    """Whether a piece boundary falls strictly inside a run of the side
    buffer."""
    return any(-(-(s + 1) // piece) * piece < e for s, e, part, _ in runs if part)


UPLOAD_CASES = [("smoke", 256, "int8"), ("smoke", 512, "int8"),
                ("wide", 256, "int8"), ("wide", 256, "int4"),
                ("smoke", 256, "topk")]


@pytest.mark.parametrize("cut,piece,codec", UPLOAD_CASES)
def test_upload_on_the_pair_is_the_reference_roundtrip(cut, piece, codec):
    """Codec only, from a nonzero residual: every leaf of the decoded
    upload (in its dtype) and the (P,) residual bit-equal to the
    reference's ``ef_roundtrip`` on ``flatten_tree``'s vector, unflattened
    to the leaves' dtypes as its ``comm_body`` does. TopK takes the
    vector as one piece."""
    jg, state, runs = _grad_case(cut, 1)
    assert [part for _, _, part, _ in runs] == [0, 1, 0, 1, 0]
    if cut == "wide":
        assert _inside_side_run(runs, piece)
    gf, unflatten = jcodecs.flatten_tree(jg)
    ef0 = (np.random.default_rng(2).standard_normal(gf.shape[0]) * 1e-3
           ).astype(np.float32)
    jkey = jax.random.PRNGKey(5)
    _, g_hat, new_ef = jef.ef_roundtrip(jcodecs.make_codec(codec), gf,
                                        jnp.asarray(ef0),
                                        jax.random.fold_in(jkey, 0xC0DEC))
    ef = torch.from_numpy(ef0.copy())
    ttrain.comm_update_((state.w_flat, state.w_side), ef,
                        convert.key_from_numpy(np.asarray(jkey), "cpu"),
                        tcodecs.make_codec(codec), None, piece, runs=runs)
    want = dict(_named(unflatten(g_hat)))
    for k, t in _named(state.params):
        assert str(t.dtype)[6:] == str(want[k].dtype), k
        np.testing.assert_array_equal(_f32(t), _f32(want[k]), err_msg=k)
    np.testing.assert_array_equal(ef.numpy(), np.asarray(new_ef))


def test_upload_on_the_pair_with_dp_matches_privatize_flat():
    """DP alone on the WIDE cut at pieces of 256 (boundaries inside
    a_log): the privatized leaves within σ·3e-5, and the bf16 leaves within
    one bf16 ulp of the value more (the gap flips a rounding: 1 of 131,072
    embed entries does); the clip flag equal, the noise's ‖·‖² rtol 1e-5
    (the norm over both buffers)."""
    jg, state, runs = _grad_case("wide", 3)
    assert _inside_side_run(runs, 256)
    gf, unflatten = jcodecs.flatten_tree(jg)
    jkey = jax.random.PRNGKey(6)
    jdp, tdp = jpriv.DPConfig(**DP_SMALL), tpriv.DPConfig(**DP_SMALL)
    priv, jst = jpriv.privatize_flat(gf, jax.random.fold_in(jkey, 0xD9), jdp)
    tst = ttrain.comm_update_((state.w_flat, state.w_side), None,
                              convert.key_from_numpy(np.asarray(jkey), "cpu"),
                              None, tdp, 256, runs=runs)
    sigma = tpriv.sigma_of(tdp)
    want = dict(_named(unflatten(priv)))
    for k, t in _named(state.params):
        rtol = 2 * BF16 if t.dtype == torch.bfloat16 else 1e-6
        np.testing.assert_allclose(_f32(t), _f32(want[k]), rtol=rtol,
                                   atol=sigma * NORMAL_GAP, err_msg=k)
    assert float(tst["clipped"]) == float(jst["clipped"]) == 1.0
    np.testing.assert_allclose(float(tst["noise_sq"]), float(jst["noise_sq"]),
                               rtol=1e-5)


def test_a_pair_needs_its_runs():
    state = topt.ssca_init(_tparams(_np_tree(_grad_case("smoke", 0)[0])))
    with pytest.raises(ValueError, match="runs="):
        ttrain.comm_update_((state.w_flat, state.w_side), None,
                            rnd.PRNGKey(0, device="cpu"), None,
                            tpriv.DPConfig(**DP_SMALL))


# ---------------------------------------------------------------------------
# (b) three steps of make_scanned_step against the reference's
# ---------------------------------------------------------------------------


def _replay_j(value, grad):
    """A reference model whose loss at any params reads ``value`` and
    whose gradient is ``grad`` (each leaf in its param's dtype)."""
    def loss_fn(params, batch, cfg):
        s = sum(jnp.sum(p * g).astype(jnp.float32) for p, g in
                zip(jax.tree.leaves(params), jax.tree.leaves(grad)))
        return value + (s - jax.lax.stop_gradient(s))
    return types.SimpleNamespace(loss_fn=loss_fn)


def _replay_t(value, grad):
    """The port's counterpart of ``_replay_j``: backward accumulates each
    leaf of ``grad``, unrounded, into the step's flat gradient buffers."""
    g = leaves(_tparams(_np_tree(grad)))
    v = torch.tensor(float(value), dtype=torch.float32)

    def loss_fn(params, batch, cfg):
        s = sum((p * gg).sum().float() for p, gg in zip(leaves(params), g))
        return v + (s - s.detach())
    return types.SimpleNamespace(loss_fn=loss_fn, stacked={})


class _Nu64:
    """The constrained step's surrogate recursion and Lemma 1 in float64
    on given inputs: the exact-arithmetic ν of a step."""

    def __init__(self):
        self.g, self.m = None, 0.0

    def step(self, params, grad, value, rho, fl):
        w = np.concatenate([_f32(t).ravel() for t in leaves(params)]).astype(np.float64)
        gr = np.concatenate([np.asarray(x, np.float32).ravel()
                             for x in jax.tree.leaves(grad)]).astype(np.float64)
        g_old = np.zeros_like(w) if self.g is None else self.g
        inj = gr - 2 * fl.tau * w
        jump = float(np.dot(inj - g_old, inj - g_old))
        qmin = float(value) - fl.cost_limit - float(np.dot(gr, gr)) / (4 * fl.tau)
        self.g = (1 - rho) * g_old + rho * inj
        self.m = ((1 - rho) * self.m + rho * qmin
                  + rho * (1 - rho) * jump / (4 * fl.tau))
        b, disc = float(np.dot(self.g, self.g)), -4 * fl.tau * self.m
        if disc <= 0:
            return fl.penalty_c
        return min(max((np.sqrt(b / disc) - 1) / fl.tau, 0.0), fl.penalty_c)


TRAJ_CASES = {"constrained": (None, None, True),
              "int8": ("int8", None, False),
              "dp": (None, DP_SMALL, False),
              "int8_dp": ("int8", DP_SMALL, False)}


def _close_leaves(got_tree, want_tree, dtypes, what):
    """Each leaf within TOL where its param is fp32, else within one bf16
    rounding (a surrogate buffer of a bf16 leaf takes the rounded params)."""
    want = dict(_named(_np_tree(want_tree)))
    for k, t in _named(got_tree):
        tol = TOL if dtypes[k] == torch.float32 else BF16
        np.testing.assert_allclose(_f32(t), _f32(want[k]), rtol=tol, atol=tol,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("case", list(TRAJ_CASES))
def test_trajectory_matches_reference(ref, case, monkeypatch):
    codec, dp, constrained = TRAJ_CASES[case]
    if constrained:
        from test_torch_constrained import _accurate_reference_dots
        _accurate_reference_dots(monkeypatch)
    jp, npp = ref
    jkey = jax.random.fold_in(jax.random.PRNGKey(0), 1)
    jtoks = jsyn.token_dataset(jkey, JCFG.vocab_size, 2000)
    ttoks = tsyn.token_dataset(convert.key_from_numpy(np.asarray(jkey), "cpu"),
                               TCFG.vocab_size, 2000)
    jfl, tfl = JFLConfig(**FL_KW), FLConfig(**FL_KW)
    jc, tc = (jcodecs.make_codec(codec), tcodecs.make_codec(codec)) if codec else (None, None)
    jdp, tdp = (jpriv.DPConfig(**dp), tpriv.DPConfig(**dp)) if dp else (None, None)
    jin = jrounds.make_inputs(jfl, 1, STEPS, jax.random.PRNGKey(9))
    tin = trounds.make_inputs(tfl, 1, STEPS, rnd.PRNGKey(9, device="cpu"))
    js = (jopt.ssca_constrained_init if constrained else jopt.ssca_init)(jp)
    ts = (topt.ssca_constrained_init if constrained else topt.ssca_init)(_tparams(npp))
    dim = sum(x.size for x in jax.tree.leaves(jp))
    if codec:
        js = jef.CommCarry(opt=js, ef=jef.ef_init(dim))
        ts = CommCarry(opt=ts, ef=ef_init(dim, "cpu"))
    jm = jget_model(JCFG)
    real = jax.jit(lambda p, b: jax.value_and_grad(jm.loss_fn)(p, b, JCFG))
    nu64 = _Nu64()
    for r in range(STEPS):
        jinp = jax.tree.map(lambda x: x[r], jin)
        value, grad = real(jrounds.unwrap_comm(js).params,
                           jsyn.sample_window(jtoks, jinp.key, B, S))
        if constrained:
            exact = nu64.step(trounds.unwrap_comm(ts).params, grad, value,
                              float(tin.round(r).rho), tfl)
        jstep = jtrain.make_scanned_step(_replay_j(value, grad), JCFG, jfl,
                                         jtoks, B, S, constrained, codec=jc,
                                         dp=jdp)
        tstep = ttrain.make_scanned_step(_replay_t(value, grad), TCFG, tfl,
                                         ttoks, B, S, constrained, codec=tc,
                                         dp=tdp)
        js, jms = jax.jit(jstep)(js, jinp)
        ts, tms = tstep(ts, tin.round(r))
        what = f"step {r + 1}"
        assert set(tms) == set(jms)
        assert float(tms["loss"]) == float(jms["loss"])
        if codec:
            assert float(tms["upload_bytes"]) == float(jms["upload_bytes"])
        if dp:
            for k in ("dp_epsilon", "dp_clip_frac", "dp_noise_norm"):
                np.testing.assert_allclose(float(tms[k]), float(jms[k]),
                                           rtol=1e-5, err_msg=f"{what} {k}")
        topt_state, jopt_state = trounds.unwrap_comm(ts), jrounds.unwrap_comm(js)
        dtypes = {k: t.dtype for k, t in _named(topt_state.params)}
        _close_leaves(topt_state.params, jopt_state.params, dtypes,
                      f"{what} params")
        if constrained:
            _close_leaves(topt_state.cons.g, jopt_state.cons.g, dtypes,
                          f"{what} cons.g")
            nu, jnu = float(tms["nu"]), float(jms["nu"])
            np.testing.assert_allclose(float(tms["l2"]), float(jms["l2"]),
                                       rtol=1e-5, err_msg=f"{what} l2")
            assert abs(nu - exact) <= 1e-5 * exact, (what, nu, exact)
            assert abs(nu - jnu) <= 1e-5 * exact + abs(jnu - exact), (
                what, nu, jnu, exact)
            g_sq = sum(float(torch.dot(g, g)) for g in
                       (topt_state.g_flat, topt_state.g_side))
            scale = max(abs(float(topt_state.cons.d)), g_sq / (4 * FL_KW["tau"]))
            np.testing.assert_allclose(float(tms["slack"]), float(jms["slack"]),
                                       rtol=0, atol=8 * float(np.spacing(
                                           np.float32(scale))), err_msg=what)
        else:
            _close_leaves(topt_state.g, jopt_state.g, dtypes, f"{what} g")
        if codec:
            got, want = ts.ef.numpy(), np.asarray(js.ef)
            if r == 0 and not dp:
                gmax = max(float(jnp.abs(x).max()) for x in jax.tree.leaves(grad))
                np.testing.assert_allclose(
                    got, want, rtol=0, atol=2 * float(np.spacing(np.float32(gmax))),
                    err_msg=f"{what} ef")
            else:
                gap = float(np.linalg.norm(got - want) / np.linalg.norm(want))
                assert gap <= EF_NORMWISE[bool(dp)], (what, "ef normwise", gap)


# ---------------------------------------------------------------------------
# (c) the sharded topology and the model-parallel step on one rank
# ---------------------------------------------------------------------------


def _buffers(state):
    opt = trounds.unwrap_comm(state)
    out = [opt.w_flat, opt.w_side, getattr(opt, "g_flat", None), opt.g_side]
    return [t for t in out if t is not None]


def _shard_keys(monkeypatch):
    """The local upload with the keys of client shard 0 of 1 (the sharded
    step's: ``split(fold_in(key, ·), 1)[0]``), so both draw one stream."""
    plain = ttrain.comm_update_

    def with_shard_keys(grad, ef, key, codec=None, dp=None, piece=None, **kw):
        kw.setdefault("codec_key", rnd.split(rnd.fold_in(key, 0xC0DEC), 1)[0])
        kw.setdefault("dp_key", rnd.split(rnd.fold_in(key, 0xD9), 1)[0])
        return plain(grad, ef, key, codec, dp, piece, **kw)

    monkeypatch.setattr(ttrain, "comm_update_", with_shard_keys)


@pytest.mark.parametrize("constrained", [False, True])
def test_sharded_topology_on_one_rank_is_the_local_step(ref, constrained,
                                                        monkeypatch):
    """Two int8 + EF + DP steps on the real bf16 model through the sharded
    topology (one gloo rank in this process) and locally with the shard's
    keys: every flat buffer, the EF residual and the metrics bit-equal."""
    _shard_keys(monkeypatch)
    _, npp = ref
    model = tapi.get_model(TCFG)
    toks = tsyn.token_dataset(rnd.PRNGKey(1, device="cpu"), TCFG.vocab_size, 2000)
    tfl = FLConfig(**FL_KW)
    tin = trounds.make_inputs(tfl, 1, 2, rnd.PRNGKey(9, device="cpu"))
    codec, dp = tcodecs.make_codec("int8"), tpriv.DPConfig(epsilon=8.0)
    init = topt.ssca_constrained_init if constrained else topt.ssca_init
    topo = ttopo.make_topology("sharded", device="cpu")
    runs = {}
    for name, topology in (("sharded", topo), ("local", None)):
        state = init(_tparams(npp))
        dim = state.w_flat.numel() + state.w_side.numel()
        ef = (torch.zeros((1, dim)) if topology else ef_init(dim, "cpu"))
        step = ttrain.make_scanned_step(model, TCFG, tfl, toks, B, S,
                                        constrained, codec=codec,
                                        topology=topology, dp=dp)
        runs[name] = trounds.ENGINES["scan"](step, CommCarry(opt=state, ef=ef),
                                             tin)
    (sh, sms), (lo, lms) = runs["sharded"], runs["local"]
    for a, b in zip(_buffers(sh), _buffers(lo), strict=True):
        assert torch.equal(a, b)
    assert torch.equal(sh.ef[0], lo.ef)
    for k in lms:
        assert torch.equal(sms[k], lms[k]), k


def test_sharded_train_step_on_a_1x1_mesh_is_the_local_step(ref):
    """``sharded_train_step(constrained=True)`` on a 1x1 mesh, two steps:
    the side buffers and the metrics bit-equal to the local step's."""
    _, npp = ref
    model = tapi.get_model(TCFG)
    tok = rnd.randint(rnd.PRNGKey(1, device="cpu"), (B, S + 1), 0,
                      TCFG.vocab_size)
    batch = {"tokens": tok[:, :S], "targets": tok[:, 1:]}
    tfl = FLConfig(**FL_KW)
    mesh = tmesh.make_mesh((1, 1), device="cpu")
    specs = ttrain.state_specs(model, TCFG, True)
    sharded = topt.ssca_constrained_init(_tparams(npp))
    assert ttrain.shard_state(sharded, mesh, specs) is sharded
    local = topt.ssca_constrained_init(_tparams(npp))
    step = ttrain.sharded_train_step(model, TCFG, tfl, mesh, batch, True)
    local_step = ttrain.make_constrained_train_step(model, TCFG, tfl)
    for _ in range(2):
        sharded, ms = step(sharded, batch)
        local, lms = local_step(local, batch)
        for k in ("loss", "nu", "slack", "l2"):
            assert torch.equal(ms[k], lms[k]), k
    for a, b in zip(_buffers(sharded), _buffers(local), strict=True):
        assert torch.equal(a, b)


def test_counted_spans_split_by_buffer():
    """The constrained step's counted spans on a bf16 tree with fp32
    leaves: one list a flat buffer, each covering its buffer."""
    cfg = TCFG
    model = tapi.get_model(cfg)
    params = model.init(rnd.PRNGKey(0, device="cpu"), cfg, device="cpu")
    mesh = tmesh.make_mesh((1, 1), device="cpu")
    main, side = ttrain._counted_spans(mesh, model.param_specs(cfg, mode="train"),
                                       params, torch.bfloat16)
    state = topt.ssca_constrained_init(params)
    for spans, buf in ((main, state.w_flat), (side, state.w_side)):
        assert spans[0][0] == 0 and spans[-1][1] == buf.numel()
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


# ---------------------------------------------------------------------------
# (d) checkpoints of a state with a side buffer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["constrained", "comm_carry"])
def test_state_saves_and_resumes_to_the_same_buffers(ref, kind, tmp_path):
    """A constrained bf16 state after one step, and a CommCarry after one
    int8 + EF step, saved (``save_state``) and read back into a fresh
    state's own buffers (``load_state_``): every flat buffer, the residual
    and the scalars bit-equal; the next step from either is the same."""
    _, npp = ref
    model = tapi.get_model(TCFG)
    toks = tsyn.token_dataset(rnd.PRNGKey(1, device="cpu"), TCFG.vocab_size, 2000)
    tfl = FLConfig(**FL_KW)
    tin = trounds.make_inputs(tfl, 1, 2, rnd.PRNGKey(9, device="cpu"))
    constrained = kind == "constrained"
    codec = None if constrained else tcodecs.make_codec("int8")
    step = ttrain.make_scanned_step(model, TCFG, tfl, toks, B, S, constrained,
                                    codec=codec)

    def fresh():
        state = (topt.ssca_constrained_init if constrained
                 else topt.ssca_init)(_tparams(npp))
        if codec:
            state = CommCarry(opt=state, ef=ef_init(
                state.w_flat.numel() + state.w_side.numel(), "cpu"))
        return state

    state, _ = step(fresh(), tin.round(0))
    path = str(tmp_path / "state.msgpack")
    save_state(path, state, step=1)
    back, at = load_state_(path, fresh())
    assert at == 1 and trounds.unwrap_comm(back).t == 2
    for a, b in zip(_buffers(back), _buffers(state), strict=True):
        assert torch.equal(a, b)
    if codec:
        assert torch.equal(back.ef, state.ef)
    else:
        for k in ("nu", "slack", "cons_min"):
            assert torch.equal(getattr(back, k), getattr(state, k)), k
        assert torch.equal(back.cons.d, state.cons.d)
    nxt, ms = step(state, tin.round(1))
    nxt_back, ms_back = step(back, tin.round(1))
    for a, b in zip(_buffers(nxt_back), _buffers(nxt), strict=True):
        assert torch.equal(a, b)
    assert torch.equal(ms["loss"], ms_back["loss"])


# ---------------------------------------------------------------------------
# train_loop and the CLI on the bf16 model
# ---------------------------------------------------------------------------


@pytest.fixture
def bf16_smoke(monkeypatch):
    """``ModelConfig.smoke`` at the full config's bf16 (the cut alone is
    fp32), as the train loop and the CLI call it."""
    plain = ModelConfig.smoke
    monkeypatch.setattr(ModelConfig, "smoke", lambda self, **kw: plain(
        self, **{"dtype": "bfloat16", **kw}))


@pytest.mark.parametrize("kw", [
    dict(constrained=True), dict(codec="int8"), dict(dp=8.0),
    dict(codec="int8", dp=8.0, constrained=True)],
    ids=["constrained", "int8", "dp", "int8_dp_constrained"])
def test_train_loop_runs_the_bf16_model(kw, bf16_smoke):
    """train_loop on the smoke model at its bf16, two steps: the state
    keeps its fp32 side buffer, the residual is sized P, the losses and
    metrics are finite."""
    kw = dict(kw)
    if "dp" in kw:
        kw["dp"] = tpriv.DPConfig(epsilon=kw["dp"])
    state, logs = ttrain.train_loop(A, 2, B, S, smoke=True, device="cpu",
                                    log_every=1, **kw)
    opt = trounds.unwrap_comm(state)
    assert opt.w_flat.dtype == torch.bfloat16 and opt.w_side.numel() == 16
    assert opt.t == 3 and len(logs) == 2
    if "codec" in kw:
        assert state.ef.shape == (opt.w_flat.numel() + 16,)
    for lg in logs:
        assert all(np.isfinite(v) for v in lg.values()), lg
    if kw.get("constrained"):
        assert all(0.0 <= lg["nu"] <= FLConfig().penalty_c for lg in logs)


def test_cli_trains_the_bf16_model(monkeypatch, capsys, bf16_smoke):
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", A, "--smoke", "--device", "cpu", "--steps", "2",
        "--batch", "2", "--seq", "8", "--constrained",
        "--codec", "int8", "--dp-epsilon", "8", "--log-every", "2"])
    ttrain.main()
    out = capsys.readouterr().out
    assert "nu=" in out and "upload_bytes=" in out and "dp_epsilon=" in out
