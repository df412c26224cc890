"""Drivers for the paper's Algorithms 1-4 (``repro.core.algorithms``).

Each driver runs the paper's communication rounds with per-round client
mini-batch selection (PRNG-folded, bit-equal to the reference), the exact
uploads of the paper and the closed-form server updates, under
``rounds.run_rounds``:

- Algorithm 1 (sample-based, unconstrained): ``fed.sample_round``, then the
  fused ``ssca_update`` kernel (one launch a round).
- Algorithm 2 (sample-based, constrained, formulation (40)): the round with
  the value sums, then Lemma 1 (``optimizer.ssca_constrained_step``);
  ``algorithm2_general`` samples objective and constraint in two streams
  and solves Problem 5 by bisection.
- Algorithms 3/4 (feature-based): ``fed.feature_round`` (h-exchange, head
  and block uploads), then the kernel update (3) or Lemma 1 (4).

The sample-based drivers (Algorithms 1/2) take ``participation=S`` to
aggregate S of I clients a round, Horvitz-Thompson reweighted; adding
``cohort=True`` runs the participant-only O(S) engine (``fed.cohort_round``):
per-round compute, uploads and error-feedback state scale with S, the
residuals live in a keyed ``EFStore``, and the data may be a
``data.synthetic.VirtualFedData`` (I = 1e6 is never materialized).

With ``codec=`` the q-uploads cross the client boundary in the codec's wire
format, with per-client error-feedback residuals carried in a ``CommCarry``
(a dict of streams where a round has several). With ``dp=`` (a
``privacy.DPConfig``) every q-upload is clipped and noised at the client
boundary before any codec encode, and each round's metrics gain
``dp_epsilon`` (the subsampled-RDP accountant's ε spent through round t,
computed on the device from the round's ``t``), ``dp_clip_frac`` (the share
of participating uploads whose clip bound) and ``dp_noise_norm`` (the ℓ2
norm of the injected noise). The metrics keep the reference's names:
``loss_est``, ``cons_est``, ``nu``, ``slack``, ``stat_res``, ``cons_viol``,
``upload_bytes``, ``axis_bytes`` (always 0.0: one device) and, with a codec,
``ef_norm``. ``obs=`` (an ``obs.MetricStream``) streams them while the
rounds run.

Every entry point runs on ``device`` (default: the CUDA card; raises
without one); params0, data and key are moved there and params0 itself is
not written. ``topology=`` other than the local one is not ported yet and
raises NotImplementedError naming its ROADMAP item.
"""
from __future__ import annotations

import torch

from repro_torch import device as device_lib
from repro_torch.comm import accounting as comm_accounting
from repro_torch.comm import codecs as comm_codecs
from repro_torch.comm.error_feedback import (CommCarry, ef_init,
                                             ef_init_stacked, ef_store_init,
                                             with_comm_carry)
from repro_torch import random as rnd
from repro_torch.core import fed, optimizer
from repro_torch.core import privacy as privacy_lib
from repro_torch.core import rounds as rounds_lib
from repro_torch.core import topology as topology_lib
from repro_torch.core.fed import FeatureFedData, SampleFedData
from repro_torch.core.rounds import RunResult  # noqa: F401  (re-exported)
from repro_torch.core.tree import leaves, tree_map

_LATER = {
    "topology": "the sharded topology comes with ROADMAP queue 1, item 8",
}


def refuse_unported(topology=None):
    """Raise NotImplementedError, naming its ROADMAP item, for a reference
    option the port has not ported."""
    if not (topology is None
            or isinstance(topology, topology_lib.LocalTopology)):
        raise NotImplementedError(
            f"topology=: not ported yet; {_LATER['topology']}")


def _to(device, params0, data, key):
    dev = device_lib.resolve(device)
    return (tree_map(lambda t: t.to(dev), params0), data.to(dev), key.to(dev),
            dev)


def _sample_upload_bytes(uploads, grad_est, data, participation=None,
                         with_value: bool = False):
    """Static per-round uplink bytes: the codec's exact wire bytes from the
    round, or dense fp32 bytes derived from the grad shapes."""
    if uploads["upload_nbytes"] is not None:
        return float(uploads["upload_nbytes"])
    return float(comm_accounting.sample_round_bytes(
        comm_codecs.tree_flat_dim(grad_est), data.num_clients,
        participation=participation, with_value=with_value)["up"])


def _stat_res(new_flat, old_flat, gamma_t):
    """Per-round stationarity residual ‖ω^{t+1} − ω^t‖₂ / γ^t = ‖ω̄^t − ω^t‖₂
    (the update is ω ← (1−γ)ω + γω̄, eq. 5), over the flat params."""
    sq = torch.sum(torch.square(new_flat.float() - old_flat.float()))
    return torch.sqrt(sq) / torch.clamp(gamma_t, min=1e-30)


def _ef_norm(ef):
    """‖EF residuals‖₂ across every stream — the signal the codec is still
    holding back."""
    streams = ef if isinstance(ef, list) else leaves(ef)
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in streams))


def _cons_viol(value, fl):
    return torch.clamp(value - fl.cost_limit, min=0.0)


def _wrap_codec_state(state, codec, ef0):
    """Attach the zeroed EF residuals (built by the ef0 thunk, so the dense
    path allocates nothing) when a codec is in play."""
    return state if codec is None else CommCarry(opt=state, ef=ef0())


def _sample_ef0(params0, num_clients: int, device, cohort: bool = False):
    """Zeroed per-client EF residuals for sample-based q-uploads: the dense
    (I, P) tensor, or for the cohort engine a keyed EFStore."""
    dim = comm_codecs.tree_flat_dim(params0)
    if cohort:
        return ef_store_init(num_clients, dim, device=device)
    return ef_init_stacked(num_clients, dim, device=device)


def _check_cohort(name: str, cohort: bool, participation):
    """The cohort engine is a partial-participation engine (S is its
    per-round shape): cohort=True without participation=S is refused."""
    if cohort and participation is None:
        raise ValueError(
            f"{name}: cohort=True needs participation=S (the O(S) engine's "
            "per-round cohort size); pass participation= or drop cohort=")


def _cohort_ef_norm(ids, ef):
    """ef_norm for the cohort engine: the norm of the cohort's own residual
    rows (O(S·P)), not of the (I, P) backing, which would put an O(I)
    reduction into every round. Not comparable with the dense engine's
    all-clients norm."""
    stores = ef.values() if isinstance(ef, dict) else (ef,)
    return _ef_norm([st.gather(ids) for st in stores])


def _sample_round(cohort: bool, per_sample_loss, params, data, key, fl,
                  participation, **kw):
    """One sample-based round on the dense engine or the cohort engine."""
    if cohort:
        return fed.cohort_round(per_sample_loss, params, data, key,
                                fl.batch_size, participation, **kw)
    return fed.sample_round(per_sample_loss, params, data, key, fl.batch_size,
                            participation=participation, **kw)


def _ef_metric(cohort: bool, up, ef):
    return _cohort_ef_norm(up["cohort"], ef) if cohort else _ef_norm(ef)


def _dp_sample_rate(participation, num_clients: int) -> float:
    """The accountant's subsampling rate q of a sample-based driver: S/I
    under partial participation (dense mask or cohort engine), else 1."""
    if participation is None or participation >= num_clients:
        return 1.0
    return participation / num_clients


def _data_device(data):
    """The device a round's data (dense, feature or virtual) lives on."""
    for name in ("counts", "labels", "key"):
        t = getattr(data, name, None)
        if isinstance(t, torch.Tensor):
            return t.device
    raise TypeError(f"no tensor to place {type(data).__name__} by")


def _eps_fn(dp, sample_rate: float, device, releases_per_round: int = 1):
    return (privacy_lib.make_eps_fn(dp, sample_rate, releases_per_round,
                                    device=device)
            if dp is not None else None)


def _dp_metrics(eps_fn, stats, mask, inp):
    """Per-round DP metrics from a sample-based round's uploads["dp"];
    ``mask`` is the dense participation mask (None on the cohort path and at
    full participation: every row of ``stats`` is a participant)."""
    clipped, noise_sq = stats["clipped"], stats["noise_sq"]
    if mask is None:
        mask = torch.ones_like(clipped)
    denom = torch.clamp(torch.sum(mask), min=1.0)
    return {"dp_epsilon": eps_fn(inp.t),
            "dp_clip_frac": torch.sum(clipped * mask) / denom,
            "dp_noise_norm": torch.sqrt(torch.sum(noise_sq * mask))}


def _dp_feature_metrics(eps_fn, stats, num_clients: int, inp):
    """Feature-round variant: the head stream and the I block streams all
    release every round (the clip fraction averages over the I+1)."""
    return {"dp_epsilon": eps_fn(inp.t),
            "dp_clip_frac": (stats["head_clipped"]
                             + torch.sum(stats["blocks_clipped"]))
            / (num_clients + 1.0),
            "dp_noise_norm": torch.sqrt(stats["head_noise_sq"]
                                        + torch.sum(stats["blocks_noise_sq"]))}


# ---------------------------------------------------------------------------
# Algorithm 1: unconstrained sample-based FL via mini-batch SSCA
# ---------------------------------------------------------------------------


def make_algorithm1_step(per_sample_loss, data: SampleFedData, fl,
                         participation=None, codec=None, cohort: bool = False,
                         dp=None):
    """One full Algorithm-1 round as a (state, RoundInputs-slice) step. With
    a codec the state is a CommCarry(opt=SSCAState, ef=(I, P) residuals, or
    an EFStore with ``cohort``). dp= privatizes every q-upload and adds the
    dp_* metrics."""
    _check_cohort("make_algorithm1_step", cohort, participation)
    eps_fn = _eps_fn(dp, _dp_sample_rate(participation, data.num_clients),
                     _data_device(data))

    def body(state, inp, ef):
        grad_est, val_est, up = _sample_round(
            cohort, per_sample_loss, state.params, data, inp.key, fl,
            participation, codec=codec, ef=ef, dp=dp)
        old = state.w_flat.clone()      # ssca_step updates in place
        new = optimizer.ssca_step(state, grad_est, fl,
                                  rho_t=inp.rho, gamma_t=inp.gamma)
        metrics = {"loss_est": val_est,
                   "stat_res": _stat_res(new.w_flat, old, inp.gamma),
                   "upload_bytes": _sample_upload_bytes(up, grad_est, data,
                                                        participation),
                   "axis_bytes": 0.0}
        if codec is not None:
            metrics["ef_norm"] = _ef_metric(cohort, up, up["ef"])
        if dp is not None:
            metrics.update(_dp_metrics(eps_fn, up["dp"],
                                       up.get("participants"), inp))
        return new, up["ef"], metrics

    return with_comm_carry(codec, body)


def algorithm1(per_sample_loss, params0, data: SampleFedData, fl, rounds: int,
               key, eval_fn=None, eval_every: int = 10, participation=None,
               codec=None, topology=None, obs=None, cohort: bool = False,
               dp=None, device=None) -> RunResult:
    refuse_unported(topology)
    params0, data, key, dev = _to(device, params0, data, key)
    step = make_algorithm1_step(per_sample_loss, data, fl, participation,
                                codec, cohort, dp)
    state = _wrap_codec_state(optimizer.ssca_init(params0), codec,
                              lambda: _sample_ef0(params0, data.num_clients,
                                                  dev, cohort))
    return rounds_lib.run_rounds(step, state, fl, key, rounds,
                                 eval_fn=eval_fn, eval_every=eval_every,
                                 obs=obs)


# ---------------------------------------------------------------------------
# Algorithm 2: constrained sample-based FL (formulation (40): min ‖ω‖², F <= U)
# ---------------------------------------------------------------------------


def make_algorithm2_step(per_sample_loss, data: SampleFedData, fl,
                         participation=None, codec=None, cohort: bool = False,
                         dp=None):
    """One Algorithm-2 round: the sample round with its value sums, then
    Lemma 1 (``ssca_constrained_step``, in place). dp= privatizes the
    q-grad uploads; the value sums are not noised (the accountant covers
    the gradient stream), as in the reference."""
    _check_cohort("make_algorithm2_step", cohort, participation)
    eps_fn = _eps_fn(dp, _dp_sample_rate(participation, data.num_clients),
                     _data_device(data))

    def body(state, inp, ef):
        grad_est, val_est, up = _sample_round(
            cohort, per_sample_loss, state.params, data, inp.key, fl,
            participation, with_value=True, codec=codec, ef=ef, dp=dp)
        old = state.w_flat.clone()
        new = optimizer.ssca_constrained_step(state, grad_est, val_est, fl,
                                              rho_t=inp.rho, gamma_t=inp.gamma)
        metrics = {"loss_est": val_est, "nu": new.nu, "slack": new.slack,
                   "stat_res": _stat_res(new.w_flat, old, inp.gamma),
                   "cons_viol": _cons_viol(val_est, fl),
                   "upload_bytes": _sample_upload_bytes(
                       up, grad_est, data, participation, with_value=True),
                   "axis_bytes": 0.0}
        if codec is not None:
            metrics["ef_norm"] = _ef_metric(cohort, up, up["ef"])
        if dp is not None:
            metrics.update(_dp_metrics(eps_fn, up["dp"],
                                       up.get("participants"), inp))
        return new, up["ef"], metrics

    return with_comm_carry(codec, body)


def algorithm2(per_sample_loss, params0, data: SampleFedData, fl, rounds: int,
               key, eval_fn=None, eval_every: int = 10, participation=None,
               codec=None, topology=None, obs=None, cohort: bool = False,
               dp=None, device=None) -> RunResult:
    refuse_unported(topology)
    params0, data, key, dev = _to(device, params0, data, key)
    step = make_algorithm2_step(per_sample_loss, data, fl, participation,
                                codec, cohort, dp)
    state = _wrap_codec_state(optimizer.ssca_constrained_init(params0), codec,
                              lambda: _sample_ef0(params0, data.num_clients,
                                                  dev, cohort))
    return rounds_lib.run_rounds(step, state, fl, key, rounds,
                                 eval_fn=eval_fn, eval_every=eval_every,
                                 obs=obs)


def algorithm2_general(obj_loss, cons_loss, params0, data: SampleFedData, fl,
                       rounds: int, key, eval_fn=None, eval_every: int = 10,
                       participation=None, codec=None,
                       topology=None, obs=None, cohort: bool = False, dp=None,
                       device=None) -> RunResult:
    """Full Algorithm 2: sampled nonconvex objective AND constraint, from
    the two halves of ``split(round key)``. With a codec the objective and
    constraint q-uploads carry separate EF residuals (ef = {"obj": (I, P),
    "cons": (I, P)}, or two EFStores with ``cohort``). Under partial
    participation both streams come from the same S clients: the shared
    participation key ``fold_in(round key, 0x5ca)`` draws the same ids.
    dp= privatizes both q-grad streams (each with its own round key), so
    the accountant composes 2 releases a round."""
    refuse_unported(topology)
    _check_cohort("algorithm2_general", cohort, participation)
    params0, data, key, dev = _to(device, params0, data, key)
    eps_fn = _eps_fn(dp, _dp_sample_rate(participation, data.num_clients),
                     dev, releases_per_round=2)

    def body(state, inp, ef):
        ef = ef if ef is not None else {"obj": None, "cons": None}
        k1, k2 = rnd.split(inp.key).unbind(0)
        pk = (rnd.fold_in(inp.key, 0x5CA) if participation is not None
              else None)
        og, _, uo = _sample_round(cohort, obj_loss, state.params, data, k1,
                                  fl, participation, participation_key=pk,
                                  codec=codec, ef=ef["obj"], dp=dp)
        cg, cv, uc = _sample_round(cohort, cons_loss, state.params, data, k2,
                                   fl, participation, with_value=True,
                                   participation_key=pk, codec=codec,
                                   ef=ef["cons"], dp=dp)
        old = state.w_flat.clone()
        new = optimizer.ssca_general_constrained_step(
            state, og, cg, cv, fl, rho_t=inp.rho, gamma_t=inp.gamma)
        metrics = {"cons_est": cv, "nu": new.nu, "slack": new.slack,
                   "stat_res": _stat_res(new.w_flat, old, inp.gamma),
                   "cons_viol": _cons_viol(cv, fl),
                   "upload_bytes": (
                       _sample_upload_bytes(uo, og, data, participation)
                       + _sample_upload_bytes(uc, cg, data, participation,
                                              with_value=True)),
                   "axis_bytes": 0.0}
        new_ef = {"obj": uo["ef"], "cons": uc["ef"]}
        if codec is not None:
            metrics["ef_norm"] = _ef_metric(cohort, uo, new_ef)
        if dp is not None:
            pm = uo.get("participants")
            mo = _dp_metrics(eps_fn, uo["dp"], pm, inp)
            mc = _dp_metrics(eps_fn, uc["dp"], pm, inp)
            metrics.update({
                "dp_epsilon": mo["dp_epsilon"],
                "dp_clip_frac": 0.5 * (mo["dp_clip_frac"]
                                       + mc["dp_clip_frac"]),
                "dp_noise_norm": torch.sqrt(torch.square(mo["dp_noise_norm"])
                                            + torch.square(
                                                mc["dp_noise_norm"]))})
        return new, new_ef, metrics

    state = _wrap_codec_state(
        optimizer.ssca_general_constrained_init(params0), codec,
        lambda: {"obj": _sample_ef0(params0, data.num_clients, dev, cohort),
                 "cons": _sample_ef0(params0, data.num_clients, dev, cohort)})
    return rounds_lib.run_rounds(with_comm_carry(codec, body), state, fl, key,
                                 rounds, eval_fn=eval_fn, eval_every=eval_every,
                                 obs=obs)


# ---------------------------------------------------------------------------
# Algorithms 3/4: feature-based FL via mini-batch SSCA
# ---------------------------------------------------------------------------


def _feature_upload_bytes(uploads, grad_est, data, batch_size: int):
    """Per-round uplink bytes of a feature-based round: the codec path reuses
    fed.feature_round's exact figure, the dense path derives fp32 bytes from
    the upload shapes. Shared with the feature baselines."""
    if uploads["upload_nbytes"] is not None:
        return float(uploads["upload_nbytes"])
    return float(comm_accounting.feature_round_bytes(
        comm_codecs.tree_flat_dim(grad_est["w0"]),
        [comm_codecs.tree_flat_dim(grad_est["blocks"], stacked=True)]
        * data.num_clients,
        batch_size, uploads["h_exchange"].shape[-1],
        data.num_clients)["up"])


def _feature_ef0(params0, num_clients: int, device):
    """Zeroed EF residuals for the feature-based uploads: one head stream +
    one per-client block stream."""
    return {"w0": ef_init(comm_codecs.tree_flat_dim(params0["w0"]), device),
            "blocks": ef_init_stacked(
                num_clients,
                comm_codecs.tree_flat_dim(params0["blocks"], stacked=True),
                device=device)}


def _make_feature_step(head_loss_from_h, client_h, data, fl, codec,
                       update_fn, dp=None):
    """Shared Algorithm-3/4 step body: feature_round + the given in-place
    optimizer update ``update_fn(state, grad_est, val_est, inp) -> (state,
    metrics)``, with optional codec/EF threading. dp= privatizes the head
    and block q-uploads; all I clients release every round (q = 1) and the
    head and block streams count as 2 releases a round."""
    eps_fn = _eps_fn(dp, 1.0, _data_device(data), releases_per_round=2)

    def body(state, inp, ef):
        grad_est, val_est, up = fed.feature_round(
            state.params, data, inp.key, fl.batch_size, head_loss_from_h,
            client_h, codec=codec, ef=ef, dp=dp)
        old = state.w_flat.clone()
        new, metrics = update_fn(state, grad_est, val_est, inp)
        metrics["stat_res"] = _stat_res(new.w_flat, old, inp.gamma)
        metrics["upload_bytes"] = _feature_upload_bytes(up, grad_est, data,
                                                       fl.batch_size)
        metrics["axis_bytes"] = 0.0
        if codec is not None:
            metrics["ef_norm"] = _ef_norm(up["ef"])
        if dp is not None:
            metrics.update(_dp_feature_metrics(eps_fn, up["dp"],
                                               data.num_clients, inp))
        return new, up["ef"], metrics

    return with_comm_carry(codec, body)


def _run_feature(head_loss_from_h, client_h, params0, data, fl, rounds, key,
                 eval_fn, eval_every, codec, device, init_fn, update_fn,
                 dp=None, obs=None):
    params0, data, key, dev = _to(device, params0, data, key)
    step = _make_feature_step(head_loss_from_h, client_h, data, fl, codec,
                              update_fn, dp)
    state = _wrap_codec_state(init_fn(params0), codec,
                              lambda: _feature_ef0(params0, data.num_clients,
                                                   dev))
    return rounds_lib.run_feature_rounds(step, state, fl, key, rounds,
                                         eval_fn=eval_fn, eval_every=eval_every,
                                         obs=obs)


def algorithm3(head_loss_from_h, client_h, params0, data: FeatureFedData, fl,
               rounds: int, key, eval_fn=None, eval_every: int = 10,
               codec=None, topology=None, obs=None, dp=None,
               device=None) -> RunResult:
    """Unconstrained feature-based FL: params0 = {"w0", "blocks" (I, ...)};
    the update is ``ssca_step``, one ``ssca_update`` launch a round."""
    refuse_unported(topology)

    def update(state, grad_est, val_est, inp):
        new = optimizer.ssca_step(state, grad_est, fl,
                                  rho_t=inp.rho, gamma_t=inp.gamma)
        return new, {"loss_est": val_est}

    return _run_feature(head_loss_from_h, client_h, params0, data, fl, rounds,
                        key, eval_fn, eval_every, codec, device,
                        optimizer.ssca_init, update, dp, obs)


def algorithm4(head_loss_from_h, client_h, params0, data: FeatureFedData, fl,
               rounds: int, key, eval_fn=None, eval_every: int = 10,
               codec=None, topology=None, obs=None, dp=None,
               device=None) -> RunResult:
    """Constrained feature-based FL (formulation (40) via Lemma 1)."""
    refuse_unported(topology)

    def update(state, grad_est, val_est, inp):
        new = optimizer.ssca_constrained_step(state, grad_est, val_est, fl,
                                              rho_t=inp.rho, gamma_t=inp.gamma)
        return new, {"loss_est": val_est, "nu": new.nu, "slack": new.slack,
                     "cons_viol": _cons_viol(val_est, fl)}

    return _run_feature(head_loss_from_h, client_h, params0, data, fl, rounds,
                        key, eval_fn, eval_every, codec, device,
                        optimizer.ssca_constrained_init, update, dp, obs)
