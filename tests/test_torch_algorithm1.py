"""The whole slice: the port's ``algorithm1(device="cpu")`` against
``repro.core.algorithms.algorithm1`` at a small width (P=32, J=16, L=10,
I=4, B=20), with data, weights and keys carried across as numpy.

Dense uploads: every per-round series and the final params agree within
atol 1e-5 over 24 rounds (fp32 sums run in another order; the
cross-engine standard of the reference's own sharded==local tests).
int8 + error feedback: the wire values of every round are bit-equal when
both codecs get identical pre-codec uploads with that round's keys, and the
loss trajectory agrees within rtol 1e-3 over 12 rounds — looser because a
1-ulp gradient difference can move one stochastic-rounding decision by one
level, which then feeds back through the error-feedback residuals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import codecs as jcodecs
from repro.configs.base import FLConfig as JFLConfig
from repro.core import algorithms as jalg
from repro.core import fed as jfed
from repro.core import rounds as jrounds
from repro.core import topology as jtopo
from repro.data.synthetic import classification_dataset as jdataset
from repro.models import mlp as jmlp
from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.comm import codecs as tcodecs
from repro_torch.comm.error_feedback import CommCarry
from repro_torch.configs.base import FLConfig
from repro_torch.core import algorithms as talg
from repro_torch.core import fed as tfed
from repro_torch.core import rounds as trounds
from repro_torch.core import topology as ttopo
from repro_torch.data.synthetic import classification_dataset as tdataset
from repro_torch.models import mlp as tmlp

P, J, L, I, B, N = 32, 16, 10, 4, 20, 400
FL_KW = dict(num_clients=I, batch_size=B, a1=0.3, a2=0.3, alpha_rho=0.1,
             alpha_gamma=0.6, tau=0.05, l2_lambda=1e-5)


@pytest.fixture(scope="module")
def setup():
    (z, y, _), (zt, _, lt) = jdataset(jax.random.PRNGKey(0), n=N,
                                      num_features=P, num_classes=L,
                                      test_n=50, noise=4.0)
    jd = jfed.partition_samples(z, y, I)
    p0 = {k: np.asarray(v) for k, v in jmlp.init(jax.random.PRNGKey(1), P, J,
                                                 L).items()}
    return {"jd": jd, "p0": p0, "z": np.array(z), "y": np.array(y),
            "zt": np.array(zt), "lt": np.array(lt),
            "td": convert.sample_fed_data_from_numpy(
                *(np.asarray(a) for a in jd), device="cpu")}


def _run_both(s, rounds, jcodec=None, tcodec=None, eval_every=None):
    jkey = jax.random.PRNGKey(2)
    jeval = teval = None
    if eval_every:
        def jeval(params, state):
            return {"cost": jmlp.mean_loss(params, s["z"], s["y"]),
                    "acc": jmlp.accuracy(params, s["zt"], s["lt"])}

        tz, ty = torch.from_numpy(s["z"]), torch.from_numpy(s["y"])
        tzt, tlt = torch.from_numpy(s["zt"]), torch.from_numpy(s["lt"])

        def teval(params, state):
            return {"cost": tmlp.mean_loss(params, tz, ty),
                    "acc": tmlp.accuracy(params, tzt, tlt)}
    rj = jalg.algorithm1(jmlp.per_sample_loss,
                         {k: jnp.asarray(v) for k, v in s["p0"].items()},
                         s["jd"], JFLConfig(**FL_KW), rounds=rounds, key=jkey,
                         codec=jcodec, eval_fn=jeval,
                         eval_every=eval_every or 10)
    rt = talg.algorithm1(tmlp.per_sample_loss,
                         convert.params_from_numpy(s["p0"], "cpu"), s["td"],
                         FLConfig(**FL_KW), rounds=rounds,
                         key=convert.key_from_numpy(np.asarray(jkey), "cpu"),
                         codec=tcodec, eval_fn=teval,
                         eval_every=eval_every or 10, device="cpu")
    return rj, rt


def test_algorithm1_dense_trajectory_matches(setup):
    rj, rt = _run_both(setup, 24, eval_every=8)
    assert set(rt.history) == set(rj.history)
    for k, v in rj.history.items():
        np.testing.assert_allclose(rt.history[k].numpy(), np.asarray(v),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    for k in rj.params:
        np.testing.assert_allclose(rt.params[k].numpy(),
                                   np.asarray(rj.params[k]), atol=1e-5)
    assert float(rt.history["round_upload_bytes"][0]) == 4 * I * (L * J + J * P)
    assert rt.final_state.t == 25


def test_algorithm1_int8_ef_wire_and_loss_match(setup):
    rounds = 12
    jc = jcodecs.StochasticQuantizer(bits=8, impl="pallas", interpret=True)
    object.__setattr__(jc, "name", "int8")
    rj, rt = _run_both(setup, rounds, jc, tcodecs.make_codec("int8"))
    assert isinstance(rt.final_state, CommCarry)
    assert tuple(rt.final_state.ef.shape) == (I, L * J + J * P)
    np.testing.assert_allclose(rt.history["round_loss_est"].numpy(),
                               np.asarray(rj.history["round_loss_est"]),
                               rtol=1e-3)
    np.testing.assert_array_equal(rt.history["round_upload_bytes"].numpy(),
                                  np.asarray(rj.history["round_upload_bytes"]))
    assert float(rt.history["round_upload_bytes"][0]) == I * (
        4 * 3 + L * J + J * P)
    assert torch.isfinite(rt.history["round_ef_norm"]).all()

    # each round's wire values: identical pre-codec uploads, that round's keys
    jkey = jax.random.PRNGKey(2)
    _, sub = jax.random.split(jkey)
    jin = jrounds.make_inputs(JFLConfig(**FL_KW), 1, rounds, sub)
    _, tsub = rnd.split(convert.key_from_numpy(np.asarray(jkey), "cpu")).unbind(0)
    tin = trounds.make_inputs(FLConfig(**FL_KW), 1, rounds, tsub)
    np.testing.assert_array_equal(convert.key_to_numpy(tin.key),
                                  np.asarray(jin.key))
    rng = np.random.default_rng(0)
    for r in range(rounds):
        up = {"w0": rng.standard_normal((I, L, J)).astype(np.float32),
              "w1": (rng.standard_normal((I, J, P)) * 0.3).astype(np.float32)}
        ef = (rng.standard_normal((I, L * J + J * P)) * 0.05).astype(np.float32)
        jkeys = jfed.client_keys(jax.random.fold_in(jin.key[r], 0xC0DEC),
                                 jnp.arange(I))
        tkeys = tfed.client_keys(rnd.fold_in(tin.key[r], 0xC0DEC),
                                 torch.arange(I))
        jenc, _, jr = jtopo._compress_stacked(
            jc, {k: jnp.asarray(v) for k, v in up.items()}, jnp.asarray(ef),
            jkeys, None)
        tenc, _, tr = ttopo._compress_stacked(
            tcodecs.make_codec("int8"), convert.params_from_numpy(up, "cpu"),
            torch.from_numpy(ef), tkeys)
        np.testing.assert_array_equal(tenc.values.numpy(),
                                      np.asarray(jenc.values))
        np.testing.assert_array_equal(tenc.scales.numpy(),
                                      np.asarray(jenc.scales))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_round_inputs_and_round_loop_helpers_match():
    fl_j, fl_t = JFLConfig(**FL_KW), FLConfig(**FL_KW)
    for t0, k in ((1, 7), (5, 3)):
        jin = jrounds.make_inputs(fl_j, t0, k, jax.random.PRNGKey(t0))
        tin = trounds.make_inputs(fl_t, t0, k, rnd.PRNGKey(t0, device="cpu"))
        assert tin.num_rounds == jin.num_rounds == k
        np.testing.assert_array_equal(convert.key_to_numpy(tin.key),
                                      np.asarray(jin.key))
        np.testing.assert_allclose(tin.rho.numpy(), np.asarray(jin.rho),
                                   rtol=1e-6)
        np.testing.assert_allclose(tin.gamma.numpy(), np.asarray(jin.gamma),
                                   rtol=1e-6)
        np.testing.assert_array_equal(tin.t.numpy(), np.asarray(jin.t))
        one = tin.round(1)
        assert one.key.shape == (2,) and one.rho.dim() == 0
    for rounds, chunk in ((10, 3), (7, 7), (5, 50), (1, 1)):
        assert trounds.chunk_sizes(rounds, chunk) == jrounds.chunk_sizes(
            rounds, chunk)
    with pytest.raises(ValueError, match="collide"):
        trounds._check_eval_keys({"round_loss_est": 1.0}, {"loss_est": 0})
    carry = CommCarry(opt=CommCarry(opt=trounds.RunResult(1, {}, None),
                                    ef=None), ef=None)
    assert trounds.unwrap_comm(carry).params == 1


def test_algorithm1_zero_rounds_and_synthetic_data(setup):
    r = talg.algorithm1(tmlp.per_sample_loss,
                        convert.params_from_numpy(setup["p0"], "cpu"),
                        setup["td"], FLConfig(**FL_KW), rounds=0,
                        key=rnd.PRNGKey(0, device="cpu"), device="cpu")
    for k, v in r.params.items():
        np.testing.assert_array_equal(v.numpy(), setup["p0"][k])
    # the port's own synthetic data: labels bit-equal, features to erfinv ulps
    (tz, ty, tl), (tzt, _, tlt) = tdataset(rnd.PRNGKey(0, device="cpu"), n=N,
                                           num_features=P, num_classes=L,
                                           test_n=50, noise=4.0, device="cpu")
    np.testing.assert_array_equal(tl.numpy(), np.argmax(setup["y"], -1))
    np.testing.assert_array_equal(ty.numpy(), setup["y"])
    np.testing.assert_array_equal(tlt.numpy(), setup["lt"])
    np.testing.assert_allclose(tz.numpy(), setup["z"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tzt.numpy(), setup["zt"], rtol=1e-5, atol=1e-5)
