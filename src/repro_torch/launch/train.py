"""Training: the SSCA federated optimizer wrapped around a zoo model, on one
device (counterpart of ``repro.launch.train``'s sample mode with its
defaults: local topology, dense uploads, unconstrained SSCA).

A step draws a batch of token windows (``sample_window``), takes the mean
next-token cross-entropy and its gradient by autograd, and applies
Algorithm 1's example update (``optimizer.ssca_step``): one launch of the
``ssca_update`` kernel over every parameter. The gradient lands in one flat
buffer laid out as the params' flat buffer (``grad_leaves``), so the update
takes it with no copy. On a card every RMSNorm and attention, forward and
backward, runs on its hand-written kernel.

The reference's options that the port does not have yet raise
NotImplementedError, naming the ROADMAP item that brings them: codec
uploads, the sharded topology, differential privacy, the constrained
update, JSONL logs, profiles and checkpoints, and the feature and cohort
modes.

CLI:  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
          --steps 20 --batch 8 --seq 512 [--smoke --device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch import device as device_lib
from repro_torch import random as rnd
from repro_torch.configs.base import FLConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import optimizer, rounds
from repro_torch.core.tree import leaves, tree_map
from repro_torch.data.synthetic import sample_window, token_dataset
from repro_torch.models.api import get_model

_LATER = {
    "codec": "codec uploads on the zoo come with ROADMAP queue 1, item 13",
    "topology": "the sharded topology comes with ROADMAP queue 1, item 8",
    "dp": "differential privacy comes with ROADMAP queue 1, item 7",
    "constrained": "the constrained update comes with ROADMAP queue 1, item 4",
    "log_jsonl": "JSONL logs come with ROADMAP queue 1, item 9",
    "profile_dir": "profiles come with ROADMAP queue 1, item 9",
    "ckpt_path": "checkpoints come with ROADMAP queue 1, item 9",
    "feature": "--mode feature comes with ROADMAP queue 1, item 6",
    "cohort": "--mode cohort comes with ROADMAP queue 1, item 3",
}


def _refuse(what: str):
    raise NotImplementedError(f"{what}: not ported yet; {_LATER[what]}")


def _check_options(constrained=False, codec=None, topology=None, dp=None):
    if constrained:
        _refuse("constrained")
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
    gviews = optimizer.views(grad_flat, state.params)

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


def make_train_step(model, cfg, fl: FLConfig):
    """Returns train_step(state, batch[, rho_t, gamma_t]) -> (state,
    metrics): Algorithm 1's unconstrained example update (momentum SGD with
    diminishing step sizes) on the batch's loss gradient. ρ^t/γ^t default to
    the state.t-derived schedule; the scanned step passes them per round.
    The gradient buffer (w_flat's dtype and layout) and the leaves that
    point into it are made once per state and zeroed each step."""
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
            new = optimizer.ssca_step(state, held["grad"], fl, rho_t=rho_t,
                                      gamma_t=gamma_t)
        return new, {"loss": loss.detach(), "t": state.t}

    return train_step


def make_scanned_step(model, cfg, fl: FLConfig, tokens, batch: int, seq: int,
                      constrained: bool = False, codec=None, topology=None,
                      dp=None):
    """Fuses the round's data selection into the train step: step(state,
    RoundInputs of one round) -> (state, metrics), the batch drawn from
    ``tokens`` with the round's key. Local topology and dense uploads only."""
    _check_options(constrained, codec, topology, dp)
    train_step = make_train_step(model, cfg, fl)

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
    _check_options(constrained, codec, topology, dp)
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    fl = fl or FLConfig(a1=0.9, a2=0.5, alpha_rho=0.1, alpha_gamma=0.6,
                        tau=0.2, l2_lambda=1e-5, cost_limit=3.0)
    model = get_model(cfg)
    dev = device_lib.resolve(device)
    key = rnd.PRNGKey(seed, device=dev)
    state = optimizer.ssca_init(model.init(key, cfg, device=dev)
                                if params is None else params)
    del params
    toks = token_dataset(rnd.fold_in(key, 1), cfg.vocab_size,
                         n_tokens=max(200_000, batch * (seq + 1) * 4))
    step_fn = make_scanned_step(model, cfg, fl, toks, batch, seq)
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="model zoo arch")
    ap.add_argument("--mode", choices=("sample", "feature", "cohort"),
                    default="sample")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--constrained", action="store_true")
    ap.add_argument("--driver", choices=("scan", "loop"), default="scan",
                    help="both are the port's Python loop over steps")
    ap.add_argument("--codec", default="none")
    ap.add_argument("--topology", choices=("local", "sharded"),
                    default="local")
    ap.add_argument("--dp-epsilon", type=float, default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-jsonl", default=None)
    ap.add_argument("--profile", default=None)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device (cpu for a smoke run)")
    args = ap.parse_args()
    if args.mode != "sample":
        _refuse(args.mode)
    if args.dp_epsilon is not None:
        _refuse("dp")
    if args.arch is None:
        ap.error("--arch is required for --mode sample")
    train_loop(args.arch, args.steps, args.batch, args.seq, smoke=args.smoke,
               constrained=args.constrained, ckpt_path=args.ckpt,
               driver=args.driver,
               codec=args.codec, topology=args.topology,
               log_jsonl=args.log_jsonl, profile_dir=args.profile,
               device=args.device)


if __name__ == "__main__":
    main()
