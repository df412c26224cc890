"""Training: the SSCA federated optimizer wrapped around a zoo model, on one
device (counterpart of ``repro.launch.train``'s sample and feature modes
with the local topology).

A step draws a batch of token windows (``sample_window``), takes the mean
next-token cross-entropy and its gradient by autograd, and applies
Algorithm 1's example update (``optimizer.ssca_step``): one launch of the
``ssca_update`` kernel over every parameter. With ``constrained=True`` the
update is the Algorithm-2 example instead, min ‖ω‖² s.t. mean-loss <= U
(formulation (40), Lemma 1: ``optimizer.ssca_constrained_step``), which
runs as PyTorch ops in place on the flat buffers. The gradient lands in one
flat buffer laid out as the params' flat buffer (``grad_leaves``), so
either update takes it with no copy. On a card every RMSNorm and attention,
forward and backward, runs on its hand-written kernel.

``feature_train_loop`` (``--mode feature``) runs Algorithm 3, or Algorithm
4 with ``constrained``, on a synthetic classification task with the
features split into ``clients`` vertical blocks, with ``codec=`` on its
head and block uploads.

``cohort_train_loop`` (``--mode cohort``) runs Algorithm 1, or Algorithm 2
with ``constrained``, through the participant-only O(S) cohort engine over
a ``VirtualFedData`` population of ``clients`` (a million is never
materialized), ``participation`` clients a round, with ``codec=`` and its
error feedback in a keyed ``EFStore`` on the card.

The reference's options that the port does not have yet raise
NotImplementedError, naming the ROADMAP item that brings them: codec
uploads on the zoo, the sharded topology, differential privacy, JSONL logs,
profiles and checkpoints.

CLI:  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
          --steps 20 --batch 8 --seq 512 [--constrained --cost-limit 3.0] \\
          [--smoke --device cpu]
      PYTHONPATH=src python -m repro_torch.launch.train --mode feature \\
          --clients 4 --steps 200 [--constrained --cost-limit 1.2] \\
          [--codec int8] [--device cpu]
      PYTHONPATH=src python -m repro_torch.launch.train --mode cohort \\
          --clients 1000000 --participation 256 [--codec int8|topk8] \\
          [--constrained] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch import device as device_lib
from repro_torch import random as rnd
from repro_torch.comm.codecs import make_codec
from repro_torch.configs.base import FLConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import algorithms, fed, optimizer, rounds
from repro_torch.core.rounds import unwrap_comm
from repro_torch.core.surrogate import chunks
from repro_torch.core.tree import leaves, tree_map, views
from repro_torch.data.synthetic import (VirtualFedData, classification_dataset,
                                        sample_window, token_dataset)
from repro_torch.models import mlp
from repro_torch.models.api import get_model

# train_loop's default: the reference's FLConfig
TRAIN_FL = FLConfig(a1=0.9, a2=0.5, alpha_rho=0.1, alpha_gamma=0.6, tau=0.2,
                    l2_lambda=1e-5, cost_limit=3.0)

_LATER = {
    "codec": "codec uploads on the zoo come with ROADMAP queue 1, item 13",
    "topology": "the sharded topology comes with ROADMAP queue 1, item 8",
    "dp": "differential privacy comes with ROADMAP queue 1, item 7",
    "log_jsonl": "JSONL logs come with ROADMAP queue 1, item 9",
    "profile_dir": "profiles come with ROADMAP queue 1, item 9",
    "ckpt_path": "checkpoints come with ROADMAP queue 1, item 9",
}


def _refuse(what: str):
    raise NotImplementedError(f"{what}: not ported yet; {_LATER[what]}")


def _check_options(codec=None, topology=None, dp=None):
    if codec not in (None, "none"):
        _refuse("codec")
    if topology not in (None, "local"):
        _refuse("topology")
    if dp is not None:
        _refuse("dp")


def grad_leaves(state, grad_flat):
    """The state's params as autograd leaves for ``loss_fn``: each a detached
    view of ``state.w_flat`` that requires grad, whose ``.grad`` is the same
    span of ``grad_flat`` (so backward accumulates every gradient into that
    one buffer, in place). The stacked (L, ...) leaves under "layers" are cut
    into a list of L per-layer dicts of such views: a select's backward
    would build a full-size zero tensor for every use."""
    gviews = views(grad_flat, state.params)

    def leaf(w, g):
        t = w.detach().requires_grad_()
        t.grad = g
        return t

    out = {}
    for k in state.params:
        if k == "layers":
            n = leaves(state.params[k])[0].shape[0]
            out[k] = [tree_map(lambda w, g: leaf(w[i], g[i]),
                               state.params[k], gviews[k]) for i in range(n)]
        elif isinstance(state.params[k], dict):
            out[k] = tree_map(leaf, state.params[k], gviews[k])
        else:
            out[k] = leaf(state.params[k], gviews[k])
    return out


def _sq_norm(flat):
    """‖flat‖² in fp32, a chunk at a time (no full-size fp32 temporary)."""
    total = torch.zeros((), device=flat.device)
    for sl in chunks(flat.numel()):
        x = flat[sl].float()
        total = total + torch.dot(x, x)
    return total


def _ssca_update(state, loss, grad, fl: FLConfig, rho_t, gamma_t,
                 constrained: bool):
    """The update and metrics shared by both train steps."""
    if constrained:
        new = optimizer.ssca_constrained_step(state, grad, loss, fl,
                                              rho_t=rho_t, gamma_t=gamma_t)
        return new, {"loss": loss, "nu": new.nu, "slack": new.slack,
                     "l2": _sq_norm(new.w_flat)}
    new = optimizer.ssca_step(state, grad, fl, rho_t=rho_t, gamma_t=gamma_t)
    return new, {"loss": loss, "t": state.t}


def _make_step(model, cfg, fl: FLConfig, constrained: bool):
    """train_step(state, batch[, rho_t, gamma_t]) -> (state, metrics). The
    gradient buffer (w_flat's dtype and layout) and the leaves that point
    into it are made once per state and zeroed each step."""
    held = {}

    def train_step(state, batch, rho_t=None, gamma_t=None):
        if held.get("w") is not state.w_flat:
            held.clear()
            grad = torch.empty_like(state.w_flat)
            held.update(w=state.w_flat, grad=grad,
                        leaves=grad_leaves(state, grad))
        held["grad"].zero_()
        loss = model.loss_fn(held["leaves"], batch, cfg)
        loss.backward()
        with torch.no_grad():
            return _ssca_update(state, loss.detach(), held["grad"], fl, rho_t,
                                gamma_t, constrained)

    return train_step


def make_train_step(model, cfg, fl: FLConfig):
    """Algorithm 1's unconstrained example update (momentum SGD with
    diminishing step sizes) on the batch's loss gradient. ρ^t/γ^t default to
    the state.t-derived schedule; the scanned step passes them per round.
    Metrics: ``loss``, ``t``."""
    return _make_step(model, cfg, fl, constrained=False)


def make_constrained_train_step(model, cfg, fl: FLConfig):
    """The Algorithm-2 example: min ‖ω‖² s.t. mean-loss <= U (formulation
    (40)), on an ``SSCAConstrainedState``. Metrics: ``loss``, ``nu``,
    ``slack``, ``l2`` (‖ω‖² after the step)."""
    return _make_step(model, cfg, fl, constrained=True)


def make_scanned_step(model, cfg, fl: FLConfig, tokens, batch: int, seq: int,
                      constrained: bool = False, codec=None, topology=None,
                      dp=None):
    """Fuses the round's data selection into the train step: step(state,
    RoundInputs of one round) -> (state, metrics), the batch drawn from
    ``tokens`` with the round's key. Local topology and dense uploads only."""
    _check_options(codec, topology, dp)
    train_step = (make_constrained_train_step if constrained
                  else make_train_step)(model, cfg, fl)

    def step(state, inp):
        data = sample_window(tokens, inp.key, batch, seq)
        return train_step(state, data, rho_t=inp.rho, gamma_t=inp.gamma)

    return step


def train_loop(arch: str, steps: int, batch: int, seq: int, *,
               smoke: bool = False, constrained: bool = False,
               fl: Optional[FLConfig] = None, log_every: int = 10,
               ckpt_path: Optional[str] = None, seed: int = 0,
               driver: str = "scan", codec: Optional[str] = None,
               topology: str = "local", log_jsonl: Optional[str] = None,
               profile_dir: Optional[str] = None, dp=None, device=None,
               params=None):
    """``repro.launch.train.train_loop``: ``steps`` SSCA steps of ``arch``
    (its smoke variant with ``smoke``) on a Markov token stream, with a line
    of metrics printed every ``log_every`` steps. Weights are drawn from
    ``seed``, the same keys as the reference's; ``params`` (the model's
    nested dict, on the device) starts from those instead, and is copied
    into the optimizer's flat buffer. Returns (state, logs), logs one dict
    per printed line."""
    for what, on in (("ckpt_path", ckpt_path), ("log_jsonl", log_jsonl),
                     ("profile_dir", profile_dir)):
        if on:
            _refuse(what)
    _check_options(codec, topology, dp)
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    fl = fl or TRAIN_FL
    model = get_model(cfg)
    dev = device_lib.resolve(device)
    key = rnd.PRNGKey(seed, device=dev)
    init = (optimizer.ssca_constrained_init if constrained
            else optimizer.ssca_init)
    state = init(model.init(key, cfg, device=dev) if params is None else params)
    del params
    toks = token_dataset(rnd.fold_in(key, 1), cfg.vocab_size,
                         n_tokens=max(200_000, batch * (seq + 1) * 4))
    step_fn = make_scanned_step(model, cfg, fl, toks, batch, seq, constrained)
    engine = rounds.ENGINES[driver]

    logs = []
    t0, done = 1, 0
    key_run = rnd.fold_in(key, 2)
    wall0 = time.time()
    for size in rounds.chunk_sizes(steps, log_every):
        key_run, sub = rnd.split(key_run).unbind(0)
        inputs = rounds.make_inputs(fl, t0, size, sub)
        state, ms = engine(step_fn, state, inputs)
        t0 += size
        done += size
        m = {k: float(v[-1]) for k, v in ms.items()}
        m["step"] = done
        m["wall_s"] = time.time() - wall0
        logs.append(m)
        print(" ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in m.items()), flush=True)
    return state, logs


def feature_train_loop(*, clients: int = 4, rounds: int = 200,
                       batch: int = 64, features: int = 128,
                       classes: int = 10, hidden: int = 32, n: int = 8000,
                       constrained: bool = False, cost_limit: float = 1.2,
                       topology: str = "local", codec: Optional[str] = None,
                       log_every: int = 20,
                       seed: int = 0, fl: Optional[FLConfig] = None,
                       log_jsonl: Optional[str] = None,
                       profile_dir: Optional[str] = None, dp=None,
                       device=None, params0=None):
    """``repro.launch.train.feature_train_loop``: synthetic classification
    (``classification_dataset``, noise 4), features split into ``clients``
    blocks, the MLP head composition (``models/mlp.py``), Algorithm 3 or
    (constrained) Algorithm 4 for ``rounds`` rounds, a line of eval metrics
    every ``log_every`` rounds. The params are drawn as the reference draws
    them (``random.normal``, to a few ulps); ``params0`` ({"w0", "blocks"})
    starts from given ones instead. Returns the RunResult."""
    for what, on in (("log_jsonl", log_jsonl), ("profile_dir", profile_dir)):
        if on:
            _refuse(what)
    _check_options(None, topology, dp)
    dev = device_lib.resolve(device)
    key = rnd.PRNGKey(seed, device=dev)
    (z, y, _), _ = classification_dataset(key, n=n, num_features=features,
                                          num_classes=classes, test_n=10,
                                          noise=4.0, device=dev)
    data = fed.partition_features(z, y, clients)
    pi = data.feature_blocks.shape[-1]
    if params0 is None:
        params0 = {"w0": rnd.normal(key, (classes, hidden)) * 0.2,
                   "blocks": rnd.normal(rnd.fold_in(key, 1),
                                        (clients, hidden, pi)) * 0.2}
    fl = fl or FLConfig(batch_size=batch, a1=0.9, a2=0.5, alpha_rho=0.1,
                        alpha_gamma=0.6, tau=0.2, l2_lambda=1e-5,
                        mode="feature", constrained=constrained,
                        cost_limit=cost_limit, penalty_c=1e4)

    def eval_fn(p, s):
        hsum = torch.sum(mlp.client_h(p["blocks"], data.feature_blocks), dim=0)
        m = {"loss": torch.mean(mlp.per_sample_loss_from_h(p["w0"], hsum,
                                                           data.labels))}
        if constrained:
            m["nu"], m["slack"] = unwrap_comm(s).nu, unwrap_comm(s).slack
        return m

    alg = algorithms.algorithm4 if constrained else algorithms.algorithm3
    wall0 = time.time()
    result = alg(mlp.per_sample_loss_from_h, mlp.client_h, params0, data, fl,
                 rounds, rnd.fold_in(key, 2), eval_fn=eval_fn,
                 eval_every=log_every, codec=make_codec(codec),
                 device=dev)
    _print_history(result)
    print(f"done: {rounds} rounds, 1 client shard(s), "
          f"{time.time() - wall0:.1f}s", flush=True)
    return result


def _print_history(result):
    for i, r in enumerate(result.history["round"].tolist()):
        line = {k: float(v[i]) for k, v in result.history.items()
                if not k.startswith("round")}
        line["round"] = int(r)
        print(" ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in line.items()), flush=True)


def cohort_train_loop(*, clients: int = 100_000, participation: int = 256,
                      rounds: int = 200, batch: int = 16, features: int = 32,
                      classes: int = 4, hidden: int = 16,
                      constrained: bool = False, cost_limit: float = 1.2,
                      topology: str = "local", codec: Optional[str] = None,
                      topk_frac: float = 0.01, log_every: int = 20,
                      seed: int = 0, fl: Optional[FLConfig] = None,
                      log_jsonl: Optional[str] = None,
                      profile_dir: Optional[str] = None, dp=None,
                      device=None, params0=None):
    """``repro.launch.train.cohort_train_loop``: a ``VirtualFedData``
    population of ``clients`` ragged Dirichlet-skewed shards (noise 4),
    the mlp of ``features``-``hidden``-``classes``, and Algorithm 1 (or 2
    with ``constrained``) through the cohort engine, ``participation``
    clients a round, for ``rounds`` rounds; the eval every ``log_every``
    rounds is the masked mean loss over the first 64 clients' shards. The
    params are drawn as the reference draws them (``random.normal``, to a
    few ulps); ``params0`` starts from given ones instead. Returns the
    RunResult."""
    for what, on in (("log_jsonl", log_jsonl), ("profile_dir", profile_dir)):
        if on:
            _refuse(what)
    _check_options(None, topology, dp)
    dev = device_lib.resolve(device)
    key = rnd.PRNGKey(seed, device=dev)
    data = VirtualFedData(rnd.fold_in(key, 0xDA7A), clients,
                          num_features=features, num_classes=classes,
                          noise=4.0)
    if params0 is None:
        params0 = mlp.init(rnd.fold_in(key, 1), features, hidden, classes,
                           device=dev)
    fl = fl or FLConfig(batch_size=batch, a1=0.9, a2=0.5, alpha_rho=0.1,
                        alpha_gamma=0.6, tau=0.2, l2_lambda=1e-5,
                        constrained=constrained, cost_limit=cost_limit,
                        penalty_c=1e4)
    codec_obj = make_codec(codec, topk_frac=topk_frac)
    ez, ey, ec = data.shards_for(torch.arange(min(64, clients),
                                              dtype=torch.int32, device=dev))
    emask = (torch.arange(ez.shape[1], device=dev)[None, :]
             < ec[:, None]).float()

    def eval_fn(p, s):
        per_row = mlp.per_sample_loss(p, ez, ey)
        return {"loss": torch.sum(per_row * emask) / torch.sum(emask)}

    alg = algorithms.algorithm2 if constrained else algorithms.algorithm1
    wall0 = time.time()
    result = alg(mlp.per_sample_loss, params0, data, fl, rounds,
                 rnd.fold_in(key, 2), eval_fn=eval_fn, eval_every=log_every,
                 participation=participation, codec=codec_obj, cohort=True,
                 device=dev)
    _print_history(result)
    print(f"done: {rounds} rounds, population {clients}, cohort "
          f"{participation} over 1 shard(s), {time.time() - wall0:.1f}s",
          flush=True)
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="model zoo arch (required for --mode sample)")
    ap.add_argument("--mode", choices=("sample", "feature", "cohort"),
                    default="sample",
                    help="sample = horizontal FL on a zoo model (Alg 1/2); "
                         "feature = vertical FL, features split across "
                         "clients (Alg 3/4); cohort = million-client "
                         "horizontal FL through the participant-only O(S) "
                         "engine over a virtual population")
    ap.add_argument("--clients", type=int, default=4,
                    help="feature-mode vertical client count, or cohort-mode "
                         "population size I (e.g. 1000000, never "
                         "materialized)")
    ap.add_argument("--participation", type=int, default=256,
                    help="cohort-mode clients a round S")
    ap.add_argument("--features", type=int, default=None,
                    help="default: 128, or 32 in cohort mode")
    ap.add_argument("--classes", type=int, default=None,
                    help="default: 10, or 4 in cohort mode")
    ap.add_argument("--hidden", type=int, default=None,
                    help="default: 32, or 16 in cohort mode")
    ap.add_argument("--n", type=int, default=8000)
    ap.add_argument("--cost-limit", type=float, default=None,
                    help="U in min ‖ω‖² s.t. loss <= U with --constrained "
                         "(default: 1.2 in feature mode, train_loop's 3.0 "
                         "in sample mode)")
    ap.add_argument("--steps", type=int, default=100,
                    help="steps, or rounds in feature mode")
    ap.add_argument("--batch", type=int, default=None,
                    help="default: 8, or 16 in cohort mode")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--constrained", action="store_true")
    ap.add_argument("--driver", choices=("scan", "loop"), default="scan",
                    help="both are the port's Python loop over steps")
    ap.add_argument("--codec", default="none",
                    help="none|identity|int8|int4|topk|topk8 (feature and "
                         "cohort modes; sample mode refuses a codec)")
    ap.add_argument("--topk-frac", type=float, default=0.01)
    ap.add_argument("--topology", choices=("local", "sharded"),
                    default="local")
    ap.add_argument("--dp-epsilon", type=float, default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-jsonl", default=None)
    ap.add_argument("--profile", default=None)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device (cpu for a smoke run)")
    args = ap.parse_args()
    if args.dp_epsilon is not None:
        _refuse("dp")
    cohort = args.mode == "cohort"
    widths = {k: (getattr(args, k) if getattr(args, k) is not None
                  else (cohort_default if cohort else default))
              for k, default, cohort_default in (
                  ("features", 128, 32), ("classes", 10, 4),
                  ("hidden", 32, 16), ("batch", 8, 16))}
    args.__dict__.update(widths)
    if cohort:
        cohort_train_loop(clients=args.clients,
                          participation=args.participation, rounds=args.steps,
                          batch=args.batch, features=args.features,
                          classes=args.classes, hidden=args.hidden,
                          constrained=args.constrained,
                          cost_limit=(1.2 if args.cost_limit is None
                                      else args.cost_limit),
                          topology=args.topology, codec=args.codec,
                          topk_frac=args.topk_frac, log_jsonl=args.log_jsonl,
                          profile_dir=args.profile, device=args.device)
        return
    if args.mode == "feature":
        feature_train_loop(clients=args.clients, rounds=args.steps,
                           batch=args.batch, features=args.features,
                           classes=args.classes, hidden=args.hidden, n=args.n,
                           constrained=args.constrained,
                           cost_limit=(1.2 if args.cost_limit is None
                                       else args.cost_limit),
                           topology=args.topology, codec=args.codec,
                           log_jsonl=args.log_jsonl,
                           profile_dir=args.profile, device=args.device)
        return
    if args.arch is None:
        ap.error("--arch is required for --mode sample")
    fl = (None if args.cost_limit is None
          else dataclasses.replace(TRAIN_FL, cost_limit=args.cost_limit))
    train_loop(args.arch, args.steps, args.batch, args.seq, smoke=args.smoke,
               constrained=args.constrained, fl=fl, ckpt_path=args.ckpt,
               driver=args.driver, codec=args.codec, topology=args.topology,
               log_jsonl=args.log_jsonl, profile_dir=args.profile,
               device=args.device)


if __name__ == "__main__":
    main()
