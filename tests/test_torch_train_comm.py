"""The zoo's train step with codec uploads and differential privacy (the
reference's ``comm_body``: flat gradient, ``privatize_flat``, then
``ef_roundtrip``, then the SSCA or Lemma-1 update) against
``repro.launch.train.make_scanned_step(codec=, dp=)`` on the CPU, on
qwen2.5-3b's smoke variant (2 layers, fp32, 1.3 M parameters), weights
carried across by ``convert``; ``comm_update_`` in pieces; the CLI's
``--codec``, ``--dp-*``, ``--log-jsonl`` and ``--ckpt`` on the zoo.
Tolerances are stated on each test.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.comm import codecs as jcodecs
from repro.comm.error_feedback import CommCarry as JCommCarry
from repro.comm.error_feedback import ef_init as jef_init
from repro.configs.base import FLConfig as JFLConfig
from repro.core import optimizer as jopt
from repro.core import privacy as jpriv
from repro.core import rounds as jrounds
from repro.data import synthetic as jsyn
from repro.launch import train as jtrain
from repro.models import get_model as jget_model
from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.comm import codecs as tcodecs
from repro_torch.comm.error_feedback import CommCarry, ef_init
from repro_torch.configs.base import FLConfig
from repro_torch.core import optimizer as topt
from repro_torch.core import privacy as tpriv
from repro_torch.core import rounds as trounds
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from test_torch_train import (FL_KW, JCFG, TCFG, _named, _np_tree,  # noqa: F401
                              weights)

# ---------------------------------------------------------------------------
# codec and DP uploads on the zoo (the reference's comm_body)
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several processes at once: two PyTorch threads a
    process keep them from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)

NORMAL_GAP = 3e-5      # random.normal against jax's: erfinv ulps (see
                       # tests/test_torch_privacy.py)
DP_SMALL = dict(clip_norm=1.0, noise_multiplier=0.01)
COMM_CASES = {
    "int8": ("int8", None, False, 1 << 18),
    "int8_one_piece": ("int8", None, False, ttrain.COMM_PIECE),
    "int4": ("int4", None, False, 1 << 16),
    "topk": ("topk", None, False, 1 << 18),
    "dp": (None, DP_SMALL, False, 1 << 18),
    "int8_dp": ("int8", DP_SMALL, False, 1 << 18),
    "dp_constrained": (None, DP_SMALL, True, 1 << 18),
    "int8_constrained": ("int8", None, True, 1 << 18),
}


def _comm_runs(weights, codec, dp, constrained, piece, monkeypatch, steps=3):
    """``steps`` steps of make_scanned_step(codec=, dp=) in both packages
    from the same weights, tokens and round inputs, the port's upload in
    pieces of ``piece`` elements."""
    monkeypatch.setattr(ttrain, "COMM_PIECE", piece)
    jp, npp = weights
    batch, seq = 2, 16
    jkey = jax.random.fold_in(jax.random.PRNGKey(0), 1)
    jtoks = jsyn.token_dataset(jkey, JCFG.vocab_size, 2000)
    ttoks = tsyn.token_dataset(convert.key_from_numpy(np.asarray(jkey), "cpu"),
                               TCFG.vocab_size, 2000)
    jfl, tfl = JFLConfig(**FL_KW), FLConfig(**FL_KW)
    jc = jcodecs.make_codec(codec) if codec else None
    tc = tcodecs.make_codec(codec)
    jstep = jtrain.make_scanned_step(
        jget_model(JCFG), JCFG, jfl, jtoks, batch, seq, constrained, codec=jc,
        dp=jpriv.DPConfig(**dp) if dp else None)
    tstep = ttrain.make_scanned_step(
        tapi.get_model(TCFG), TCFG, tfl, ttoks, batch, seq, constrained,
        codec=tc, dp=tpriv.DPConfig(**dp) if dp else None)
    jin = jrounds.make_inputs(jfl, 1, steps, jax.random.PRNGKey(9))
    tin = trounds.make_inputs(tfl, 1, steps, rnd.PRNGKey(9, device="cpu"))
    init_j = jopt.ssca_constrained_init if constrained else jopt.ssca_init
    init_t = topt.ssca_constrained_init if constrained else topt.ssca_init
    js, ts = init_j(jp), init_t(convert.params_from_numpy(npp, "cpu"))
    if codec:
        dim = ts.w_flat.numel()
        js = JCommCarry(opt=js, ef=jef_init(dim))
        ts = CommCarry(opt=ts, ef=ef_init(dim, "cpu"))
    jstate, jms = jrounds.loop_rounds(jstep, js, jin)
    tstate, tms = trounds.ENGINES["scan"](tstep, ts, tin)
    return jstate, jms, tstate, tms


@pytest.mark.parametrize("case", list(COMM_CASES))
def test_comm_step_matches_reference(weights, case, monkeypatch):
    """3 steps of the zoo step with codec uploads and/or DP against the
    reference's make_scanned_step(codec=, dp=), at a piece size well below P
    (1.3 M: 5-21 pieces, each at its own counter offset) and in one piece.
    Dense or DP-only: losses rtol 1e-5, params atol 1e-5 (a 0.01 noise
    multiplier keeps erfinv's ulps below it); the DP metrics rtol 1e-5. With
    int8/int4 + error feedback a 1-ulp gradient difference may move one
    rounding decision by one level: losses rtol 1e-3, params within the
    largest EF residual entry. TopK selects the same entries: atol 1e-5.
    The constrained cases run the reference with jnp.sum dots
    (tests/test_torch_constrained.py: its vdot is 4e-5 off at 1.3 M)."""
    codec, dp, constrained, piece = COMM_CASES[case]
    if constrained:
        from test_torch_constrained import _accurate_reference_dots
        _accurate_reference_dots(monkeypatch)
    jstate, jms, tstate, tms = _comm_runs(weights, codec, dp, constrained,
                                          piece, monkeypatch)
    assert set(tms) == set(jms)
    quant = codec in ("int8", "int4")
    np.testing.assert_allclose(tms["loss"].numpy(), np.asarray(jms["loss"]),
                               rtol=1e-3 if quant else 1e-5)
    if codec:
        np.testing.assert_array_equal(tms["upload_bytes"].numpy(),
                                      np.asarray(jms["upload_bytes"]))
    if dp:
        for k in ("dp_epsilon", "dp_clip_frac", "dp_noise_norm"):
            np.testing.assert_allclose(tms[k].numpy(), np.asarray(jms[k]),
                                       rtol=1e-5, err_msg=k)
    if constrained and not quant:
        for k in ("nu", "l2"):
            np.testing.assert_allclose(tms[k].numpy(), np.asarray(jms[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    atol = (float(np.abs(np.asarray(jstate.ef)).max()) if quant else 1e-5)
    got = dict(_named(convert.params_to_numpy(trounds.unwrap_comm(tstate).params)))
    want = dict(_named(_np_tree(trounds.unwrap_comm(jstate).params)))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)


def test_comm_step_calibrated_dp_first_step(weights, monkeypatch):
    """One step at the acceptance run's DPConfig(epsilon=8) (σ/C 0.42, the
    noise far above the clipped gradient): the noise norm and the clip
    fraction rtol 1e-5, ε exact to fp32, and the params within 1e-5 plus
    erfinv's gap times the step's γ/(2τ)·σ."""
    dp = dict(epsilon=8.0)
    jstate, jms, tstate, tms = _comm_runs(weights, None, dp, False, 1 << 18,
                                          monkeypatch, steps=1)
    for k in ("loss", "dp_epsilon", "dp_clip_frac", "dp_noise_norm"):
        np.testing.assert_allclose(tms[k].numpy(), np.asarray(jms[k]),
                                   rtol=1e-5, err_msg=k)
    sigma = tpriv.noise_multiplier(tpriv.DPConfig(**dp))
    atol = 1e-5 + 0.5 / (2 * FL_KW["tau"]) * sigma * NORMAL_GAP
    got = dict(_named(convert.params_to_numpy(tstate.params)))
    want = dict(_named(_np_tree(jstate.params)))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("codec", ["int8", "int4", None])
def test_comm_update_is_the_same_in_any_pieces(codec):
    """comm_update_ in 256-aligned pieces at their own counters gives the
    same gradient and residual, bit for bit, as in one piece, with DP on."""
    n = 10_000
    g0 = torch.randn(n, generator=torch.Generator().manual_seed(1)) * 0.02
    dp = tpriv.DPConfig(epsilon=8.0)
    key = rnd.PRNGKey(4, device="cpu")
    c = tcodecs.make_codec(codec)
    out = []
    for piece in (256, 1024 * 3, 1 << 14):
        g, ef = g0.clone(), torch.full((n,), 0.001)
        st = ttrain.comm_update_(g, ef, key, c, dp, piece)
        out.append((g, ef, st["noise_sq"], st["clipped"]))
    for g, ef, sq, clipped in out[1:]:
        assert torch.equal(g, out[0][0]) and torch.equal(ef, out[0][1])
        torch.testing.assert_close(sq, out[0][2], rtol=1e-6, atol=0)
        assert float(clipped) == float(out[0][3]) == 1.0
    with pytest.raises(ValueError, match="multiple of 256"):
        ttrain.comm_update_(g0.clone(), None, key, None, dp, 1000)


def test_cli_codec_and_dp_on_the_zoo(monkeypatch, capsys, tmp_path):
    log = str(tmp_path / "run.jsonl")
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
        "--steps", "2", "--batch", "2", "--seq", "8", "--codec", "int8",
        "--dp-epsilon", "8", "--dp-delta", "1e-6", "--dp-clip", "0.5",
        "--log-jsonl", log, "--log-every", "2", "--ckpt",
        str(tmp_path / "c.msgpack")])
    ttrain.main()
    out = capsys.readouterr().out
    assert "dp_epsilon=" in out and "upload_bytes=" in out
    rows = [json.loads(ln) for ln in open(log)]
    assert [r["t"] for r in rows if r["kind"] == "round"] == [2]
    man = json.load(open(log + ".manifest.json"))
    assert man["dp"]["delta"] == 1e-6 and man["dp"]["clip_norm"] == 0.5
