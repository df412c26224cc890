"""Training: the SSCA federated optimizer wrapped around a zoo model
(counterpart of ``repro.launch.train``'s sample, feature and cohort modes,
on the local or the sharded client topology).

A step draws a batch of token windows (``sample_window``), takes the mean
next-token cross-entropy and its gradient by autograd, and applies
Algorithm 1's example update (``optimizer.ssca_step``): one launch of the
``ssca_update`` kernel over every parameter (and a second over a bf16
model's fp32 leaves, which the state keeps in a flat buffer of their own).
With ``constrained=True`` the update is the Algorithm-2 example instead,
min ‖ω‖² s.t. mean-loss <= U (formulation (40), Lemma 1:
``optimizer.ssca_constrained_step``), which runs as PyTorch ops in place
on the flat buffers. The gradient lands in one
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

Uploads on the zoo (``codec=``, ``dp=``; the reference's ``comm_body``):
the step's gradient, the clients-as-data-shards picture's one upload, is
privatized (``dp``: clipped to C and noised with ``fold_in(key, 0xD9)``)
and then compressed through an error-feedback roundtrip (``codec``, key
``fold_in(key, 0xC0DEC)``), before the SSCA or Lemma-1 update.
``comm_update_`` does both in place on the flat gradient buffer, a
256-aligned piece at a time (``COMM_PIECE`` elements), each piece drawing
its threefry bits at its own counter offset on the ``dp_noise`` and keyed
quantize kernels; the EF residual (fp32, one per parameter) is updated in
place and is the only full-size state the codec adds. TopK and Chain select
over the whole vector, so they take the vector as one piece. A bf16 model's
fp32 leaves (its second flat buffer) sit between its bf16 leaves in the
reference's one flat vector, so the upload walks that vector's order
(``tree.split_runs``): a piece that spans both buffers is gathered into
fp32, run through the kernels at its offset, and scattered back.

Every mode takes the reference's observability: ``log_jsonl`` streams the
round rows through an ``obs.MetricStream`` (rows built off the dispatch
thread) and writes a run manifest beside them (with the DP calibration and
the accountant's ε under ``dp``), ``profile_dir`` wraps the run in
``torch.profiler`` (a Chrome trace with the phase labels), and
``ckpt_path`` saves the final params in the reference's msgpack format.

``topology="sharded"`` (``--topology sharded``) spreads the clients over
the ranks of a ``torch.distributed`` client mesh (``launch/mesh.py``), one
process a rank: run alone it is a one-rank group (the collectives still
run), under ``torchrun --nproc-per-node D`` D ranks. On the zoo the batch
is the D clients' data shards: rank r takes shard r's rows, privatizes and
compresses its gradient with the shard's keys (``split(fold_in(key, 0xD9),
D)[r]``, ``split(fold_in(key, 0xC0DEC), D)[r]``, as the reference draws
them), scales it by 1/D and all-reduces the flat gradient in place; its EF
residual is its (1, P) row. Feature mode puts I/D feature clients on each
rank, cohort mode S/D of the cohort. Output, logs, manifests, profiles and
checkpoints come from rank 0 only. A client mesh of fewer ranks than the
group (``--shards D`` below the rank count; feature and cohort mode take
the most ranks that divide the clients, as the reference does) spans the
first D ranks; the others run no round and return rank 0's result.

CLI:  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
          --steps 20 --batch 8 --seq 512 [--constrained --cost-limit 3.0] \\
          [--codec int8] [--dp-epsilon 8 --dp-delta 1e-5 --dp-clip 1.0] \\
          [--log-jsonl run.jsonl --log-every 1] [--profile prof/] \\
          [--ckpt params.msgpack] [--smoke --device cpu]
      PYTHONPATH=src python -m repro_torch.launch.train --mode feature \\
          --clients 4 --steps 200 [--constrained --cost-limit 1.2] \\
          [--codec int8] [--device cpu]
      PYTHONPATH=src python -m repro_torch.launch.train --mode cohort \\
          --clients 1000000 --participation 256 [--codec int8|topk8] \\
          [--constrained] [--device cpu]
      any mode: [--topology sharded [--shards D]], alone (one rank) or under
          torchrun --nproc-per-node D -m repro_torch.launch.train ...
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import device as device_lib
from repro_torch import random as rnd
from repro_torch.checkpoint.msgpack_ckpt import save_checkpoint
from repro_torch.comm.codecs import (Identity, StochasticQuantizer,
                                     make_codec)
from repro_torch.comm.error_feedback import (CommCarry, ef_init,
                                             ef_init_stacked, ef_roundtrip_,
                                             with_comm_carry)
from repro_torch.configs.base import FLConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import algorithms, fed, optimizer, rounds
from repro_torch.core import privacy as privacy_lib
from repro_torch.core import topology as topology_lib
from repro_torch.core.rounds import unwrap_comm
from repro_torch.core.surrogate import (CHUNK, QuadSurrogate, buffer_spans,
                                        counted_chunks, dot)
from repro_torch.core.tree import leaves, split_runs, split_views, tree_map
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import P
from repro_torch.data.synthetic import (VirtualFedData, classification_dataset,
                                        sample_window, token_dataset)
from repro_torch.kernels.dp_noise import dp_noise
from repro_torch.models import layers as L
from repro_torch.models import mlp, transformer
from repro_torch.models.api import get_model
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import sinks as obs_sinks
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.trace import phase

# train_loop's default: the reference's FLConfig
TRAIN_FL = FLConfig(a1=0.9, a2=0.5, alpha_rho=0.1, alpha_gamma=0.6, tau=0.2,
                    l2_lambda=1e-5, cost_limit=3.0)

# elements of the flat gradient the comm step takes at a time: a multiple
# of 256, so no codec chunk straddles two pieces
COMM_PIECE = CHUNK

def _lead(topo) -> bool:
    """Whether this rank writes the run's output (rank 0, or the only
    process on the local topology)."""
    return getattr(topo, "rank", 0) == 0


def _make_stream(log_jsonl, log_stream_every, profile_dir, name):
    """The observability trio of a training loop: a MetricStream (a JSONL
    sink with ``log_jsonl``; with none it keeps rows in memory), HostSpans
    bound to it, and the profiler context (a no-op without
    ``profile_dir``). Other ranks than rank 0 pass None for both paths."""
    sinks = [obs_sinks.JsonlSink(log_jsonl)] if log_jsonl else []
    stream = obs_metrics.MetricStream(sinks, log_every=log_stream_every,
                                      name=name)
    spans = obs_trace.HostSpans(stream)
    prof = (obs_trace.profile(profile_dir) if profile_dir
            else contextlib.nullcontext())
    return stream, spans, prof


def _parts(grad):
    """The flat gradient's buffers: (main,) or (main, side)."""
    return (grad,) if isinstance(grad, torch.Tensor) else tuple(grad)


def grad_leaves(state, grad, stacked=transformer.STACKED):
    """The state's params as autograd leaves for ``loss_fn``: each a detached
    view of the state's flat buffers that requires grad, whose ``.grad`` is
    the same span of ``grad`` (w_flat's layout, or a (main, side) pair in
    w_flat's and w_side's), so backward accumulates every gradient into
    those buffers, in place. The entries that ``stacked`` names (the
    model's ``Model.stacked``; by default the decoders') are cut into lists
    of per-block dicts of such views, nested once per stacked axis: a
    select's backward would build a full-size zero tensor for every use."""
    main, *side = _parts(grad)
    gviews = split_views(main, side[0] if side else None, state.params,
                         state.w_flat.dtype)

    def leaf(w, g):
        t = w.detach().requires_grad_()
        t.grad = g
        return t

    def cut(w, g, axes):
        if not axes:
            return tree_map(leaf, w, g)
        n = leaves(w)[0].shape[0]
        return [cut(tree_map(lambda t: t[i], w), tree_map(lambda t: t[i], g),
                    axes - 1) for i in range(n)]

    out = {}
    for k in state.params:
        if isinstance(state.params[k], dict):
            out[k] = cut(state.params[k], gviews[k], stacked.get(k, 0))
        else:
            out[k] = leaf(state.params[k], gviews[k])
    return out


def _sq_norm(bufs, spans=None, reduce=None):
    """‖·‖² in fp32 over a tuple of flat buffers, a chunk at a time (no
    full-size fp32 temporary); on a sharded state over the counted
    ``spans`` (``surrogate.buffer_spans``), summed over the ranks by
    ``reduce`` (``surrogate.update_surrogate_``'s)."""
    total = torch.zeros((), device=bufs[0].device)
    for buf, sps in buffer_spans(bufs, spans):
        for sl, counted in sps:
            if counted:
                x = buf[sl].float()
                total = total + dot(x, x)
    return total if reduce is None else reduce(total)[0]


def _ssca_update(state, loss, grad, fl: FLConfig, rho_t, gamma_t,
                 constrained: bool, spans=None, reduce=None):
    """The update and metrics shared by the train steps (``spans`` and
    ``reduce``: the sharded step's global sums)."""
    if constrained:
        new = optimizer.ssca_constrained_step(state, grad, loss, fl,
                                              rho_t=rho_t, gamma_t=gamma_t,
                                              spans=spans, reduce=reduce)
        return new, {"loss": loss, "nu": new.nu, "slack": new.slack,
                     "l2": _sq_norm(new.buffers, spans, reduce)}
    new = optimizer.ssca_step(state, grad, fl, rho_t=rho_t, gamma_t=gamma_t)
    return new, {"loss": loss, "t": state.t}


def _make_grad(model, cfg, wrap=None):
    """grad_of(state, batch) -> (loss, flat gradient): the gradient buffers,
    one a flat param buffer (``state.buffers``: w_flat's dtype and layout,
    and an fp32 one for a side buffer), and the leaves that point into
    them are made once per state and zeroed each step. ``wrap`` (the sharded step's) turns the
    leaves into what ``loss_fn`` reads, each step."""
    held = {}

    def grad_of(state, batch):
        if held.get("w") is not state.w_flat:
            held.clear()
            grad = tuple(map(torch.empty_like, state.buffers))
            held.update(w=state.w_flat, grad=grad,
                        leaves=grad_leaves(state, grad, model.stacked))
        for g in held["grad"]:
            g.zero_()
        params = held["leaves"] if wrap is None else wrap(held["leaves"])
        loss = model.loss_fn(params, batch, cfg)
        loss.backward()
        return loss.detach(), held["grad"]

    return grad_of


def _make_step(model, cfg, fl: FLConfig, constrained: bool):
    """train_step(state, batch[, rho_t, gamma_t]) -> (state, metrics)."""
    grad_of = _make_grad(model, cfg)

    def train_step(state, batch, rho_t=None, gamma_t=None):
        loss, grad = grad_of(state, batch)
        with torch.no_grad():
            return _ssca_update(state, loss, grad, fl, rho_t, gamma_t,
                                constrained)

    return train_step


def make_train_step(model, cfg, fl: FLConfig):
    """Algorithm 1's unconstrained example update (momentum SGD with
    diminishing step sizes) on the batch's loss gradient: the batch is what
    the model's ``loss_fn`` takes (tokens and targets; an encoder-decoder's
    also frame_embeddings). ρ^t/γ^t default to the state.t-derived
    schedule; the scanned step passes them per round. Metrics: ``loss``,
    ``t``."""
    return _make_step(model, cfg, fl, constrained=False)


def make_constrained_train_step(model, cfg, fl: FLConfig):
    """The Algorithm-2 example: min ‖ω‖² s.t. mean-loss <= U (formulation
    (40)), on an ``SSCAConstrainedState``. Metrics: ``loss``, ``nu``,
    ``slack``, ``l2`` (‖ω‖² after the step)."""
    return _make_step(model, cfg, fl, constrained=True)


# ---------------------------------------------------------------------------
# the model-parallel step (data x model meshes)
# ---------------------------------------------------------------------------


def state_specs(model, cfg, constrained: bool):
    """The state's partition specs: its params and surrogate buffer by
    ``param_specs(cfg, "train")``, its scalars replicated; the flat
    buffers are the params' storage (None)."""
    ps = model.param_specs(cfg, mode="train")
    if constrained:
        return optimizer.SSCAConstrainedState(
            params=ps, cons=QuadSurrogate(d=P(), g=ps), t=P(), nu=P(),
            slack=P(), w_flat=None, g_flat=None, cons_min=P())
    return optimizer.SSCAState(params=ps, g=ps, t=P(), w_flat=None,
                               g_flat=None)


def batch_specs(batch_tree, mesh):
    """Every batch entry's rows over the mesh's data axes."""
    axes = mesh_lib.data_axes(mesh)
    return tree_map(lambda _: P(axes), batch_tree)


def shard_state(state, mesh, specs):
    """A (whole) SSCA state cut to this rank's blocks by ``specs``
    (``state_specs``): its params and surrogate buffer in a state of the
    same kind with flat buffers of their own, its scalars as they are.
    Where no leaf is cut (every named axis of size 1) it is the state
    itself."""
    params = mesh_lib.shard_tree(state.params, mesh, specs.params, "params")
    if all(a is b for a, b in zip(leaves(params), leaves(state.params))):
        return state
    if isinstance(state, optimizer.SSCAConstrainedState):
        new = optimizer.ssca_constrained_init(params)
        g = mesh_lib.shard_tree(state.cons.g, mesh, specs.params, "cons.g")
        for dst, src in zip(leaves(new.cons.g), leaves(g)):
            dst.copy_(src)
        return new._replace(cons=new.cons._replace(d=state.cons.d.clone()),
                            t=state.t, nu=state.nu.clone(),
                            slack=state.slack.clone(),
                            cons_min=state.cons_min.clone())
    new = optimizer.ssca_init(params)
    g = mesh_lib.shard_tree(state.g, mesh, specs.params, "g")
    for dst, src in zip(leaves(new.g), leaves(g)):
        dst.copy_(src)
    return new._replace(t=state.t)


def _counted_spans(mesh, specs, like, dtype):
    """(start, end, counted) spans of this rank's flat buffers (the leaves
    of ``like`` in order: those of ``dtype`` in the main buffer, the
    others in the side one): a leaf counts where this rank sits at
    coordinate 0 of every axis it is replicated over, so that the
    constrained step's sums add each element once. A tuple of one list a
    buffer, as the state's ``buffers``."""
    live = [a for a, n in mesh_lib.axis_sizes(mesh).items() if n > 1]
    out, o = {}, [0, 0]
    for spec, t in zip(leaves(specs), leaves(like)):
        named_axes = {a for e in spec for a in mesh_lib.entry_axes(e)}
        counted = all(mesh_lib.axis_index(mesh, a) == 0
                      for a in live if a not in named_axes)
        i, n = int(t.dtype != dtype), t.numel()
        spans = out.setdefault(i, [])
        if spans and spans[-1][2] == counted:
            spans[-1] = (spans[-1][0], o[i] + n, counted)
        else:
            spans.append((o[i], o[i] + n, counted))
        o[i] += n
    return tuple(out[i] for i in sorted(out))


def sharded_train_step(model, cfg, fl: FLConfig, mesh, batch_like,
                       constrained: bool = False, specs=None):
    """The reference's ``jit_train_step``: train_step(state, batch[, rho_t,
    gamma_t]) -> (state, metrics) on ``mesh``, one process a rank. The
    state is this rank's block of a state placed by ``state_specs``
    (``shard_state``) and stays so between steps; the batch is this rank's
    rows of the global batch, whose shapes ``batch_like`` gives (placed by
    ``batch_specs``: ``shard_tree``). Raises where an entry does not divide
    over its axes.

    Each param leaf is gathered whole from the ranks' blocks where the
    model code reads it (``mesh.Gathered``; a stacked layer one layer at a
    time, inside its checkpoint), and ``loss_fn`` runs unchanged, with its
    kernels, on this rank's rows: the gradient of their mean loss comes
    back through the gathers' backwards, summed over the data axes and
    kept to this rank's block, into the local flat gradient, which is then
    divided by the data-axis size (the global batch's mean). The update is
    the local one on the local flat buffers: one ``ssca_update`` launch a
    buffer, or, ``constrained``, Lemma 1 with its sums over the counted
    spans (``_counted_spans``) all-reduced over every axis. The loss is
    the global batch's mean. On a mesh of one rank every gather, sum and
    division is skipped: the step is the local step, bit for bit.
    ``train_step.grad_of(state, batch)`` returns (the loss, this rank's
    flat gradient buffers, a tuple as ``state.buffers``) without the
    update. ``specs`` defaults to
    ``state_specs``; the dry run passes them fitted to the shapes
    (``mesh.fit_specs``). On a mesh over the first ranks of a larger group
    every rank calls the step: a rank outside the mesh computes nothing and
    returns rank 0's result (``mesh.idle_step``), as ``grad_of`` does."""
    if mesh_lib.outside(mesh):
        return mesh_lib.idle_step(mesh)
    specs = specs or state_specs(model, cfg, constrained)
    for k, spec in batch_specs(batch_like, mesh).items():
        mesh_lib.check_fits(spec, tuple(batch_like[k].shape), mesh,
                             f"batch {k!r}")
    plans = L.param_plans(cfg, specs.params, mesh)
    data = mesh_lib.data_axes(mesh)
    n_data = mesh_lib.axis_size(mesh, data)
    axes = tuple(mesh.mesh_dim_names)
    one_rank = math.prod(mesh_lib.axis_sizes(mesh).values()) == 1
    grad_of = _make_grad(model, cfg, wrap=lambda leaves_: mesh_lib.Gathered(
        leaves_, plans, mesh))
    held = {}

    def reduce(*sums):
        return mesh_lib.all_reduce_axes(torch.stack(sums), mesh,
                                        axes).unbind(0)

    def local_grad(state, batch):
        with mesh_lib.use_mesh(mesh):
            loss, grad = grad_of(state, batch)
        if n_data > 1:
            with torch.no_grad():
                for g in grad:
                    g.mul_(1.0 / n_data)
                loss = mesh_lib.all_reduce_axes(loss.float().clone(), mesh,
                                                data) / n_data
        return loss, grad

    def sharded_grad(state, batch):
        return mesh_lib.from_first_rank(mesh, local_grad(state, batch))

    def train_step(state, batch, rho_t=None, gamma_t=None):
        loss, grad = local_grad(state, batch)
        with torch.no_grad():
            spans = None
            if constrained and not one_rank:
                if held.get("w") is not state.w_flat:
                    held.update(w=state.w_flat, spans=tuple(map(
                        counted_chunks, _counted_spans(
                            mesh, specs.params, state.params,
                            state.w_flat.dtype))))
                spans = held["spans"]
            return mesh_lib.from_first_rank(mesh, _ssca_update(
                state, loss, grad, fl, rho_t, gamma_t, constrained, spans,
                None if spans is None else reduce))

    train_step.grad_of = sharded_grad
    return train_step


def comm_update_(grad, ef, key, codec=None, dp=None, piece: int = None, *,
                 dp_key=None, codec_key=None, runs=None):
    """The train step's upload, in place on the flat gradient ``grad`` (the
    params' dtype): privatize it (``dp``: clip to C at the whole vector's
    norm, add N(0, σ²C²) drawn with ``dp_key``, default ``fold_in(key,
    0xD9)``), then run it through an error-feedback roundtrip (``codec``,
    bits from ``codec_key``, default ``fold_in(key, 0xC0DEC)``, the residual
    ``ef`` updated in place), and
    write the decoded upload back into ``grad``. It goes through the vector
    ``piece`` elements at a time (default ``COMM_PIECE``, read at the call;
    a multiple of 256; TopK and Chain select over the whole vector and take
    it as one piece): each piece is made
    fp32, privatized on the ``dp_noise`` kernel and quantized on the keyed
    quantize kernel at its own counter offset, which draws exactly the
    normals and bits of the reference's whole-vector draws. The norm is a
    first pass in fp32 chunks. Returns the DP stats {"clipped", "noise_sq"}
    as 0-d device tensors, or None without ``dp``.

    ``grad`` may be a (main, side) pair (a bf16 model's fp32 leaves in a
    second flat buffer); ``runs`` (``tree.split_runs`` of the params) then
    lays the reference's vector, whose order ``ef`` and the offsets
    follow, over the two buffers. A piece inside one run is taken in
    place; one across runs is gathered into an fp32 piece and its decoded
    upload scattered back. The norm is over both buffers."""
    parts = _parts(grad)
    if runs is None:
        if len(parts) > 1:
            raise ValueError("comm_update_: a (main, side) gradient needs "
                             "runs= (tree.split_runs of the params)")
        runs = [(0, parts[0].numel(), 0, 0)]
    n = runs[-1][1]
    piece = COMM_PIECE if piece is None else piece
    if piece % 256:
        raise ValueError(f"comm_update_: piece must be a multiple of 256, "
                         f"got {piece}")
    if codec is not None and not isinstance(codec, (Identity,
                                                    StochasticQuantizer)):
        piece = n
    dev = parts[0].device
    stats = None
    if dp is not None:
        dkey = rnd.fold_in(key, 0xD9) if dp_key is None else dp_key
        norm = torch.sqrt(_sq_norm(parts))
        factor = privacy_lib.clip_factor(norm, dp)
        one = torch.ones((), device=dev)
        sigma = privacy_lib.sigma_of(dp)
        noise_sq = torch.zeros((), device=dev)
        stats = {"clipped": (norm > dp.clip_norm).float()}
    ckey = None
    if codec is not None:
        ckey = rnd.fold_in(key, 0xC0DEC) if codec_key is None else codec_key
    for a in range(0, n, piece):
        b = min(a + piece, n)
        # (part, its offset, the piece's offset, length) of each run in [a, b)
        spans = [(p, ps + max(a, s) - s, max(a, s) - a, min(b, e) - max(a, s))
                 for s, e, p, ps in runs if s < b and e > a]
        if len(spans) == 1:
            p, lo, _, m = spans[0]
            g = parts[p][lo:lo + m]
            x = g.float()
        else:
            g = None
            x = torch.empty(b - a, dtype=torch.float32, device=dev)
            for p, lo, xo, m in spans:
                x[xo:xo + m].copy_(parts[p][lo:lo + m])
        if dp is not None:
            x, sq = dp_noise(x, dkey, factor, one, sigma, offset=a, out=x)
            noise_sq = noise_sq + sq
        if codec is not None:
            _, x = ef_roundtrip_(codec, x, ef[a:b], ckey, offset=a)
        if g is None:
            for p, lo, xo, m in spans:
                parts[p][lo:lo + m].copy_(x[xo:xo + m])
        elif x is not g:
            g.copy_(x)
    if dp is not None:
        stats["noise_sq"] = noise_sq
    return stats


def _upload_runs(held, state):
    """``split_runs`` of the state's params, made once per state (keyed on
    its flat buffer) into ``held``."""
    if held.get("w") is not state.w_flat:
        held.update(w=state.w_flat,
                    runs=split_runs(state.params, state.w_flat.dtype))
    return held["runs"]


def make_scanned_step(model, cfg, fl: FLConfig, tokens, batch: int, seq: int,
                      constrained: bool = False, codec=None, topology=None,
                      dp=None):
    """Fuses the round's data selection into the train step: step(state,
    RoundInputs of one round) -> (state, metrics), the batch drawn from
    ``tokens`` with the round's key. With a codec (an instance) or ``dp``
    (a ``privacy.DPConfig``) the gradient goes through ``comm_update_``
    before the update, and the metrics gain ``upload_bytes`` (the codec's
    bytes for the vector) and ``dp_epsilon``, ``dp_clip_frac``,
    ``dp_noise_norm`` (one release a step, q = 1); with a codec the state is
    a CommCarry(opt=state, ef=(P,) fp32 residual).

    With a sharded ``topology`` (D ranks) the batch is D equal client
    shards and this rank computes shard r's loss and gradient, runs its
    upload through ``comm_update_`` with the shard's keys, scales it by 1/D
    and all-reduces it in place (eq. (9) with weights 1/D); the loss and
    the DP stats are summed in one small all-reduce. The EF residual is the
    rank's (1, P) row; ``upload_bytes`` is D times the codec's bytes."""
    if topology is not None and topology.name == "sharded":
        return _sharded_step(model, cfg, fl, tokens, batch, seq, constrained,
                             codec, topology, dp)
    if codec is None and dp is None:
        train_step = (make_constrained_train_step if constrained
                      else make_train_step)(model, cfg, fl)

        def step(state, inp):
            data = sample_window(tokens, inp.key, batch, seq)
            return train_step(state, data, rho_t=inp.rho, gamma_t=inp.gamma)

        return step

    grad_of = _make_grad(model, cfg)
    eps_fn = (privacy_lib.make_eps_fn(dp, 1.0, device=tokens.device)
              if dp is not None else None)
    held = {}

    def comm_body(state, inp, ef):
        data = sample_window(tokens, inp.key, batch, seq)
        loss, grad = grad_of(state, data)
        with torch.no_grad():
            dstats = comm_update_(grad, ef, inp.key, codec, dp,
                                  runs=_upload_runs(held, state))
            new, metrics = _ssca_update(state, loss, grad, fl, inp.rho,
                                        inp.gamma, constrained)
        if codec is not None:
            metrics["upload_bytes"] = float(codec.nbytes(
                sum(map(torch.numel, state.buffers))))
        if dp is not None:
            metrics.update({"dp_epsilon": eps_fn(inp.t),
                            "dp_clip_frac": dstats["clipped"],
                            "dp_noise_norm": torch.sqrt(dstats["noise_sq"])})
        return new, ef, metrics

    return with_comm_carry(codec, comm_body)


def _sharded_step(model, cfg, fl, tokens, batch, seq, constrained, codec,
                  topo, dp):
    """``make_scanned_step`` on a sharded topology (the reference's
    ``sharded_body``), one rank's part of it."""
    shards = topo.num_shards
    if batch % shards:
        raise ValueError(f"--batch {batch} must be divisible by the "
                         f"{shards} client shards of --topology sharded")
    grad_of = _make_grad(model, cfg)
    eps_fn = (privacy_lib.make_eps_fn(dp, 1.0, device=tokens.device)
              if dp is not None else None)
    held = {}

    def body(state, inp, ef):
        data = sample_window(tokens, inp.key, batch, seq)
        loss, grad = grad_of(state, {k: topo.shard(v) for k, v in data.items()})
        with torch.no_grad():
            dstats = None
            if codec is not None or dp is not None:
                ckey = (rnd.split(rnd.fold_in(inp.key, 0xC0DEC), shards)[
                    topo.rank] if codec is not None else None)
                dkey = (rnd.split(rnd.fold_in(inp.key, 0xD9), shards)[
                    topo.rank] if dp is not None else None)
                with phase("codec-encode"):
                    dstats = comm_update_(
                        grad, ef[0] if codec is not None else None, inp.key,
                        codec, dp, codec_key=ckey, dp_key=dkey,
                        runs=_upload_runs(held, state))
            if shards > 1:              # a scale by 1 changes no bit
                with phase("aggregate"):
                    for g in grad:
                        g.mul_(1.0 / shards)
            with phase("collective"):
                for g in grad:
                    dist.all_reduce(g, group=topo.group)
                parts = {"loss": loss.float() * (1.0 / shards)}
                if dp is not None:
                    parts.update(clip=dstats["clipped"],
                                 noise_sq=dstats["noise_sq"])
                sums = topo.all_sum(parts)
            new, metrics = _ssca_update(state, sums["loss"], grad, fl,
                                        inp.rho, inp.gamma, constrained)
        if codec is not None:
            metrics["upload_bytes"] = float(shards * codec.nbytes(
                sum(map(torch.numel, state.buffers))))
        if dp is not None:
            metrics.update({"dp_epsilon": eps_fn(inp.t),
                            "dp_clip_frac": sums["clip"] / shards,
                            "dp_noise_norm": torch.sqrt(sums["noise_sq"])})
        return new, ef, metrics

    return with_comm_carry(codec, body)


def train_loop(arch: str, steps: int, batch: int, seq: int, *,
               smoke: bool = False, constrained: bool = False,
               fl: Optional[FLConfig] = None, log_every: int = 10,
               ckpt_path: Optional[str] = None, seed: int = 0,
               driver: str = "scan", codec: Optional[str] = None,
               topk_frac: float = 0.01, topology: str = "local",
               shards: Optional[int] = None,
               log_jsonl: Optional[str] = None, log_stream_every: int = 1,
               profile_dir: Optional[str] = None,
               dp: Optional[privacy_lib.DPConfig] = None, device=None,
               params=None):
    """``repro.launch.train.train_loop``: ``steps`` SSCA steps of ``arch``
    (its smoke variant with ``smoke``) on a Markov token stream, with a line
    of metrics printed every ``log_every`` steps. Weights are drawn from
    ``seed``, the same keys as the reference's; ``params`` (the model's
    nested dict, on the device) starts from those instead, and is copied
    into the optimizer's flat buffer. ``codec`` (a codec name) and ``dp``
    put the gradient upload through ``comm_update_``; ``log_jsonl``,
    ``log_stream_every``, ``profile_dir`` and ``ckpt_path`` are the
    reference's observability and checkpoint options. ``topology`` is
    "local" or "sharded" (over every rank of the group, or the first
    ``shards``, the reference's spelling: the other ranks run no step and
    return rank 0's result; the module docstring says how the step
    splits). Returns (state, logs), logs one dict per printed line."""
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    fl = fl or TRAIN_FL
    model = get_model(cfg)
    if not model.has_decode:
        raise ValueError(
            f"{arch}: its loss takes a features batch (features, "
            "labels_onehot) and the train loop feeds token windows; the "
            "paper's MLP trains through the federated drivers (--mode "
            "feature, --mode cohort, core.algorithms)")
    if cfg.is_encdec:
        raise ValueError(
            f"{arch}: its loss takes frame_embeddings beside the tokens and "
            "the train loop feeds token windows only (sample_window), as the "
            "reference's loop does (which fails on it with KeyError "
            "'frame_embeddings'); train it through make_train_step with "
            "batches of frame_embeddings, tokens and targets")
    dev = device_lib.resolve(device)
    topo = topology_lib.make_topology(
        topology, mesh=(mesh_lib.make_client_mesh(shards, device=dev)
                        if topology == "sharded" else None))
    if topo.idle:                # outside a mesh of ``shards`` < the group's
        return topo.share(None)
    if not _lead(topo):
        log_jsonl = profile_dir = ckpt_path = None
    key = rnd.PRNGKey(seed, device=dev)
    init = (optimizer.ssca_constrained_init if constrained
            else optimizer.ssca_init)
    state = init(model.init(key, cfg, device=dev) if params is None else params)
    del params
    codec_obj = make_codec(codec, topk_frac=topk_frac)
    if codec_obj is not None:
        # sharded: the rank's (1, P) row of the reference's (D, P) carry,
        # made as that row (D full-size residuals would not fit beside the
        # step at full width)
        dim = sum(map(torch.numel, state.buffers))
        state = CommCarry(opt=state, ef=(
            ef_init_stacked(1, dim, dev) if topo.name == "sharded"
            else ef_init(dim, dev)))
    toks = token_dataset(rnd.fold_in(key, 1), cfg.vocab_size,
                         n_tokens=max(200_000, batch * (seq + 1) * 4))
    step_fn = make_scanned_step(model, cfg, fl, toks, batch, seq, constrained,
                                codec=codec_obj, topology=topo, dp=dp)
    engine = rounds.ENGINES[driver]
    stream, spans, prof = _make_stream(log_jsonl, log_stream_every,
                                       profile_dir, name=arch)
    if log_jsonl:
        obs_sinks.write_manifest(
            log_jsonl + ".manifest.json",
            config={"arch": arch, "steps": steps, "batch": batch, "seq": seq,
                    "constrained": constrained, "driver": driver,
                    "smoke": smoke, "seed": seed},
            codec=codec_obj, topology=topo, device=dev,
            extra=({"dp": privacy_lib.manifest_info(dp, 1.0, rounds=steps)}
                   if dp is not None else None))

    logs = []
    t0, done = 1, 0
    key_run = rnd.fold_in(key, 2)
    wall0 = time.time()
    with prof:
        for size in rounds.chunk_sizes(steps, log_every):
            key_run, sub = rnd.split(key_run).unbind(0)
            inputs = rounds.make_inputs(fl, t0, size, sub)
            with spans.span("dispatch", rounds=size, t0=t0):
                state, ms = (stream.run(step_fn, state, inputs, driver=driver)
                             if log_jsonl else engine(step_fn, state, inputs))
            t0 += size
            done += size
            m = {k: float(v[-1]) for k, v in ms.items()}
            m["step"] = done
            m["wall_s"] = time.time() - wall0
            logs.append(m)
            if _lead(topo):
                print(" ".join(f"{k}={v:.4g}" if isinstance(v, float)
                               else f"{k}={v}" for k, v in m.items()),
                      flush=True)
    if ckpt_path:
        save_checkpoint(ckpt_path, unwrap_comm(state).params, step=steps)
    stream.close()
    return topo.share((state, logs))


def feature_train_loop(*, clients: int = 4, rounds: int = 200,
                       batch: int = 64, features: int = 128,
                       classes: int = 10, hidden: int = 32, n: int = 8000,
                       constrained: bool = False, cost_limit: float = 1.2,
                       topology: str = "local", codec: Optional[str] = None,
                       topk_frac: float = 0.01, log_every: int = 20,
                       seed: int = 0, fl: Optional[FLConfig] = None,
                       log_jsonl: Optional[str] = None,
                       log_stream_every: int = 1,
                       profile_dir: Optional[str] = None,
                       dp: Optional[privacy_lib.DPConfig] = None,
                       device=None, params0=None):
    """``repro.launch.train.feature_train_loop``: synthetic classification
    (``classification_dataset``, noise 4), features split into ``clients``
    blocks, the MLP head composition (``models/mlp.py``), Algorithm 3 or
    (constrained) Algorithm 4 for ``rounds`` rounds, a line of eval metrics
    every ``log_every`` rounds. The params are drawn as the reference draws
    them (``random.normal``, to a few ulps); ``params0`` ({"w0", "blocks"})
    starts from given ones instead. ``dp``, ``log_jsonl``,
    ``log_stream_every`` and ``profile_dir`` as in ``train_loop``;
    ``topology="sharded"`` puts I/D of the ``clients`` on each rank
    (``feature_sharded_for``). Returns the RunResult."""
    dev = device_lib.resolve(device)
    topo = (topology_lib.feature_sharded_for(clients, device=dev)
            if topology == "sharded" else None)
    if not _lead(topo):
        log_jsonl = profile_dir = None
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
    codec_obj = make_codec(codec, topk_frac=topk_frac)
    stream, spans, prof = _make_stream(log_jsonl, log_stream_every,
                                       profile_dir, name="feature")
    if log_jsonl:
        obs_sinks.write_manifest(
            log_jsonl + ".manifest.json",
            config={"mode": "feature", "clients": clients, "rounds": rounds,
                    "batch": batch, "features": features, "classes": classes,
                    "hidden": hidden, "n": n, "constrained": constrained,
                    "cost_limit": cost_limit, "driver": "scan", "seed": seed},
            codec=codec_obj, topology=topo, device=dev,
            extra=({"dp": privacy_lib.manifest_info(
                dp, 1.0, rounds=rounds, releases_per_round=2)}
                if dp is not None else None))
    wall0 = time.time()
    with prof, spans.span("run", rounds=rounds):
        result = alg(mlp.per_sample_loss_from_h, mlp.client_h, params0, data,
                     fl, rounds, rnd.fold_in(key, 2), eval_fn=eval_fn,
                     eval_every=log_every, codec=codec_obj, topology=topo,
                     obs=stream if log_jsonl else None, dp=dp, device=dev)
    stream.close()
    if _lead(topo):
        _print_history(result)
        print(f"done: {rounds} rounds, {_shards(topo)} client shard(s), "
              f"{time.time() - wall0:.1f}s", flush=True)
    return result


def _shards(topo) -> int:
    return topo.num_shards if topo is not None else 1


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
                      log_stream_every: int = 1,
                      profile_dir: Optional[str] = None,
                      dp: Optional[privacy_lib.DPConfig] = None,
                      device=None, params0=None):
    """``repro.launch.train.cohort_train_loop``: a ``VirtualFedData``
    population of ``clients`` ragged Dirichlet-skewed shards (noise 4),
    the mlp of ``features``-``hidden``-``classes``, and Algorithm 1 (or 2
    with ``constrained``) through the cohort engine, ``participation``
    clients a round, for ``rounds`` rounds; the eval every ``log_every``
    rounds is the masked mean loss over the first 64 clients' shards. The
    params are drawn as the reference draws them (``random.normal``, to a
    few ulps); ``params0`` starts from given ones instead. ``dp`` (the
    S-of-I draw earns the accountant's subsampling at q = S/I),
    ``log_jsonl``, ``log_stream_every`` and ``profile_dir`` as in
    ``train_loop``; ``topology="sharded"`` splits the cohort, S/D clients a
    rank (``sharded_for(participation)``). Returns the RunResult."""
    dev = device_lib.resolve(device)
    topo = (topology_lib.sharded_for(participation, device=dev)
            if topology == "sharded" else None)
    if not _lead(topo):
        log_jsonl = profile_dir = None
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
    stream, spans, prof = _make_stream(log_jsonl, log_stream_every,
                                       profile_dir, name="cohort")
    if log_jsonl:
        obs_sinks.write_manifest(
            log_jsonl + ".manifest.json",
            config={"mode": "cohort", "clients": clients,
                    "participation": participation, "rounds": rounds,
                    "batch": batch, "features": features, "classes": classes,
                    "hidden": hidden, "constrained": constrained,
                    "cost_limit": cost_limit, "driver": "scan", "seed": seed},
            codec=codec_obj, topology=topo, device=dev,
            extra=({"dp": privacy_lib.manifest_info(
                dp, min(1.0, participation / clients), rounds=rounds)}
                if dp is not None else None))
    wall0 = time.time()
    with prof, spans.span("run", rounds=rounds):
        result = alg(mlp.per_sample_loss, params0, data, fl, rounds,
                     rnd.fold_in(key, 2), eval_fn=eval_fn,
                     eval_every=log_every, participation=participation,
                     codec=codec_obj, cohort=True, topology=topo,
                     obs=stream if log_jsonl else None, dp=dp, device=dev)
    stream.close()
    if _lead(topo):
        _print_history(result)
        print(f"done: {rounds} rounds, population {clients}, cohort "
              f"{participation} over {_shards(topo)} shard(s), "
              f"{time.time() - wall0:.1f}s", flush=True)
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
                    help="none|identity|int8|int4|topk|topk8")
    ap.add_argument("--topk-frac", type=float, default=0.01)
    ap.add_argument("--topology", choices=("local", "sharded"),
                    default="local",
                    help="local = every client in this process; sharded = "
                         "the clients spread over the ranks of a "
                         "torch.distributed group (one rank alone, D under "
                         "torchrun --nproc-per-node D)")
    ap.add_argument("--shards", type=int, default=None,
                    help="sample mode's client-shard count with --topology "
                         "sharded: the reference's spelling, at most the "
                         "rank count; ranks past it sit idle (default: "
                         "every rank)")
    ap.add_argument("--dp-epsilon", type=float, default=None, metavar="EPS",
                    help="DP on the q-uploads: per-release (ε, δ) target of "
                         "the analytic Gaussian calibration; the streamed "
                         "dp_epsilon and the manifest report the composed ε")
    ap.add_argument("--dp-delta", type=float, default=1e-5, metavar="DELTA",
                    help="DP δ (with --dp-epsilon; default 1e-5)")
    ap.add_argument("--dp-clip", type=float, default=1.0, metavar="C",
                    help="DP ℓ2 clip norm of each client's mean upload "
                         "(with --dp-epsilon; default 1.0)")
    ap.add_argument("--ckpt", default=None, metavar="PATH",
                    help="save the final params to PATH (sample mode; the "
                         "reference's msgpack format)")
    ap.add_argument("--log-jsonl", default=None, metavar="PATH",
                    help="stream round/eval/span rows to PATH as JSONL; the "
                         "run manifest goes to PATH.manifest.json")
    ap.add_argument("--log-every", type=int, default=1, metavar="N",
                    help="emit every N-th streamed round row (default 1)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="torch.profiler trace of the whole run, written to "
                         "DIR/trace.json (Chrome trace format)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device (cpu for a smoke run)")
    args = ap.parse_args()
    dp = (privacy_lib.DPConfig(clip_norm=args.dp_clip,
                               epsilon=args.dp_epsilon, delta=args.dp_delta)
          if args.dp_epsilon is not None else None)
    obs_kw = dict(log_jsonl=args.log_jsonl, log_stream_every=args.log_every,
                  profile_dir=args.profile, dp=dp, device=args.device)
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
                          topk_frac=args.topk_frac, **obs_kw)
        return
    if args.mode == "feature":
        feature_train_loop(clients=args.clients, rounds=args.steps,
                           batch=args.batch, features=args.features,
                           classes=args.classes, hidden=args.hidden, n=args.n,
                           constrained=args.constrained,
                           cost_limit=(1.2 if args.cost_limit is None
                                       else args.cost_limit),
                           topology=args.topology, codec=args.codec,
                           topk_frac=args.topk_frac, **obs_kw)
        return
    if args.arch is None:
        ap.error("--arch is required for --mode sample")
    fl = (None if args.cost_limit is None
          else dataclasses.replace(TRAIN_FL, cost_limit=args.cost_limit))
    train_loop(args.arch, args.steps, args.batch, args.seq, smoke=args.smoke,
               constrained=args.constrained, fl=fl, ckpt_path=args.ckpt,
               driver=args.driver, codec=args.codec, topk_frac=args.topk_frac,
               topology=args.topology, shards=args.shards, **obs_kw)


if __name__ == "__main__":
    main()
