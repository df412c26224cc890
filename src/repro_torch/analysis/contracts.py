"""Contracts of one recorded round (``repro.analysis.contracts``).

Runs one round of the step ``make_algorithm1_step`` builds, for the config
matrix (dense/cohort × local/sharded × identity/int8+EF × dp on/off),
under a recorder that sees every dispatched op (a ``TorchDispatchMode``,
the ops inside the kernel wrappers' plain versions too) and every kernel
launch the wrappers report (``roofline.cost``), and asserts what no
pointwise test sees:

* **no host sync** — no ``aten._local_scalar_dense`` (``.item()``,
  ``float(t)``, ...) or ``aten.nonzero`` in the round, outside the kernel
  wrappers (a plain version stands in for its kernel on the CPU: the
  cohort walk's loop tests its CPU tensor). On the card the round also
  runs under ``torch.cuda.set_sync_debug_mode("error")``.
* **DP before encode** — the ``dp_noise`` launch comes before the keyed
  quantize launch, and on the CPU, where the plain versions run, the
  normal draw (``aten.erfinv``) before the first int8 output; without
  ``dp=`` there is neither.
* **collectives** — every c10d op runs over the active topology's group;
  the local topology runs none.
* **wire dtypes** — the codec's encoded fields: int8 values and fp32
  scales for the quantizer, fp32 for identity, fp32 values and int32
  indices for TopK.
* **no f64** — no op in the round produces a float64 tensor.
* **obs** — one chunk of ``MetricStream`` stages its metrics and round
  numbers on the dispatch thread without a sync: on the card one pinned
  non-blocking copy each, no blocking copy to the host.

A sharded config runs on a one-rank group (gloo on the CPU, NCCL on the
card), started here when none runs and destroyed after the matrix.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves

from repro_torch import random as rnd
from repro_torch.comm import codecs as codecs_lib
from repro_torch.configs.base import FLConfig
from repro_torch.core import algorithms, fed, optimizer, rounds
from repro_torch.core import topology as topology_lib
from repro_torch.core.privacy import DPConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import mlp
from repro_torch.roofline import cost

SYNC_OPS = frozenset({"_local_scalar_dense", "nonzero", "item"})
F64 = (torch.float64, torch.complex128)

# a small problem of the paper's shape: I = 16 clients, so the cohort of
# S = 8 and any mesh of up to 8 ranks divide it
_I, _N, _P, _L, _J, _B, _S = 16, 6, 10, 3, 8, 4, 8


class Event(NamedTuple):
    kind: str                # "op" | "launch"
    name: str                # the op's packet name, or the kernel's
    dtypes: tuple = ()       # the op's output dtypes
    group: str = None        # a collective's group name
    inside: bool = False     # an op inside a kernel wrapper (its plain version)
    thread: int = 0
    copy: tuple = None       # aten.copy_: (non_blocking, dst pinned, dst device, src device)


class Recorder(cost.CostCounter):
    """A cost counter that keeps every event in order (``events``)."""

    sees_plain = True

    def __init__(self):
        super().__init__()
        self.events: list[Event] = []

    def op(self, func, args, kwargs, out):
        super().op(func, args, kwargs, out)
        name = func._overloadpacket.__name__.split(".")[-1]
        dtypes = tuple(t.dtype for t in tree_leaves(out) if isinstance(t, torch.Tensor))
        group = None
        if cost.c10d_kind(func) is not None:
            for a in tree_leaves((args, kwargs)):
                if isinstance(a, torch.ScriptObject):
                    try:
                        group = dist.ProcessGroup.unbox(a).group_name
                    except RuntimeError:
                        continue
                    break
        copy = None
        if name == "copy_":
            dst, src = args[0], args[1]
            nb = bool(args[2]) if len(args) > 2 else bool(kwargs.get("non_blocking", False))
            copy = (nb, dst.device.type == "cpu" and dst.is_pinned(), dst.device.type,
                    src.device.type)
        self.events.append(Event("op", name, dtypes, group, bool(cost.INSIDE[0]),
                                 threading.get_ident(), copy))

    def launch(self, name, work):
        super().launch(name, work)
        self.events.append(Event("launch", name, thread=threading.get_ident()))


@dataclasses.dataclass
class ContractViolation:
    config: str
    check: str
    detail: str

    def render(self) -> str:
        return f"[{self.config}] {self.check}: {self.detail}"


@dataclasses.dataclass
class ContractReport:
    configs: list
    violations: list

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> dict:
        return {"num_configs": len(self.configs), "configs": self.configs,
                "ok": self.ok,
                "violations": [dataclasses.asdict(v) for v in self.violations]}

    def render_text(self) -> str:
        lines = [v.render() for v in self.violations]
        lines.append(f"contracts: {len(self.configs)} config(s), "
                     f"{len(self.violations)} violation(s)")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# checkers (each returns a list of violation details)
# ---------------------------------------------------------------------------


def check_no_host_sync(events) -> list:
    return [f"host sync '{e.name}' in the round (event {i}); keep the value on "
            "the device" for i, e in enumerate(events)
            if e.kind == "op" and e.name in SYNC_OPS and not e.inside]


def _first(events, pred):
    return next((i for i, e in enumerate(events) if pred(e)), None)


def check_dp_before_encode(events, dp_on: bool, int8: bool) -> list:
    noise = _first(events, lambda e: e.kind == "launch" and e.name == "dp_noise")
    enc = _first(events, lambda e: e.kind == "launch"
                 and e.name == "stochastic_quantize_keyed")
    draw = _first(events, lambda e: e.kind == "op" and e.name == "erfinv")
    cast = _first(events, lambda e: e.kind == "op" and torch.int8 in e.dtypes)
    out = []
    if dp_on and noise is None:
        out.append("dp enabled but no dp_noise launch in the round")
    if not dp_on and (noise is not None or draw is not None):
        out.append("a normal draw (dp_noise or erfinv) in the round without dp")
    if int8 and enc is None:
        out.append("int8 codec active but no keyed quantize launch in the round")
    if dp_on and int8 and noise is not None and enc is not None and noise >= enc:
        out.append(f"the dp_noise launch (event {noise}) does not precede the "
                   f"keyed quantize launch (event {enc}): EF residuals and the "
                   "wire would see raw uploads")
    if dp_on and int8 and draw is not None and cast is not None and draw >= cast:
        out.append(f"the normal draw (erfinv, event {draw}) does not precede "
                   f"the first int8 output (event {cast})")
    return out


def check_collectives(events, allowed: tuple) -> list:
    out = []
    for i, e in enumerate(events):
        if e.kind == "op" and e.group is not None and e.group not in allowed:
            out.append(f"collective '{e.name}' (event {i}) over group "
                       f"{e.group!r}, not the topology's {allowed or '()'}")
    return out


_WIRE_SPECS = {
    codecs_lib.DenseEncoded: {"values": torch.float32},
    codecs_lib.QuantEncoded: {"values": torch.int8, "scales": torch.float32},
    codecs_lib.TopKEncoded: {"values": torch.float32, "indices": torch.int32},
    codecs_lib.ChainEncoded: {"indices": torch.int32},     # and its inner quant
}


def encoded(codec, dim: int, device="cpu"):
    """What ``codec`` puts on the wire for a (dim,) fp32 upload."""
    x = torch.linspace(-1.0, 1.0, dim, dtype=torch.float32, device=device)
    return codec.roundtrip(x, rnd.PRNGKey(0, device=device))[0]


def check_wire_dtypes(enc, codec_name: str) -> list:
    """Each field of an encoded upload against the codec's spec (a nested
    encoded field, the chain's inner quantizer, checked in turn)."""
    spec = _WIRE_SPECS.get(type(enc))
    if spec is None:
        return [f"{codec_name}: no wire spec for {type(enc).__name__}"]
    out = []
    for f in enc._fields:
        v = getattr(enc, f)
        if isinstance(v, tuple):
            out.extend(check_wire_dtypes(v, codec_name))
        elif v.dtype != spec.get(f):
            out.append(f"{codec_name} wire field '{f}' is {v.dtype}, the "
                       f"codec's spec pins {spec.get(f)}")
    return out


def check_no_f64(events) -> list:
    for i, e in enumerate(events):
        if e.kind == "op" and any(d in F64 for d in e.dtypes):
            return [f"a float64 tensor from '{e.name}' (event {i}) in the round; "
                    "the round is pinned to fp32"]
    return []


def check_obs(device) -> list:
    """One chunk of a MetricStream over 3 rounds: no sync on the dispatch
    thread; on the card each of the two staged tensors (round numbers,
    metrics) one pinned non-blocking copy, and no blocking copy to the
    host; every round's row reaches the sink."""
    from repro_torch.obs.metrics import MetricStream

    stream = MetricStream(flush_every=3)
    x = torch.ones(4, device=device)

    def step(state, inp):
        new = state * inp.rho
        return new, {"loss_est": new.sum(), "rho": inp.rho}

    inputs = rounds.make_inputs(FLConfig(), 1, 3, rnd.PRNGKey(0, device=device))
    with Recorder() as rec:
        stream.run(step, x, inputs)
    stream.close()
    me = threading.get_ident()
    ev = [e for e in rec.events if e.thread == me]
    out = [d.replace("the round", "the stream's chunk") for d in check_no_host_sync(ev)]
    copies = [e.copy for e in ev if e.copy is not None and e.copy[2] == "cpu"
              and e.copy[3] != "cpu"]
    if torch.device(device).type == "cuda":
        pinned = [c for c in copies if c[0] and c[1]]
        if len(pinned) != 2 or len(copies) != 2:
            out.append(f"the chunk staged {len(copies)} device->host copies, "
                       f"{len(pinned)} pinned and non-blocking; expected 2 of 2")
    elif copies:
        out.append(f"{len(copies)} device->host copies on the CPU")
    got = [r.get("t") for r in stream.rows]
    if got != [1, 2, 3]:
        out.append(f"the stream's rows are rounds {got}, expected 1-3")
    return out


# ---------------------------------------------------------------------------
# the config matrix
# ---------------------------------------------------------------------------


def problem(device="cpu"):
    """(data, params0, fl) of the matrix: I clients of N samples each."""
    key = rnd.PRNGKey(7, device=device)
    kd, kp = rnd.split(key).unbind(0)
    feats = rnd.normal(kd, (_I * _N, _P))
    labels = torch.nn.functional.one_hot(
        rnd.randint(rnd.fold_in(kd, 1), (_I * _N,), 0, _L).long(), _L).float()
    data = fed.partition_samples(feats, labels, _I)
    params0 = mlp.init(kp, _P, _J, _L, device=device)
    return data, params0, FLConfig(num_clients=_I, batch_size=_B)


def topology(kind: str, device="cpu"):
    """(topology, the groups its collectives may use)."""
    if kind == "local":
        return topology_lib.LocalTopology(), ()
    topo = topology_lib.ShardedTopology(
        mesh_lib.make_client_mesh(axis="data", device=device))
    return topo, (topo.group.group_name,)


def matrix_configs():
    """(name, engine, topology, codec, dp) for the full matrix."""
    return [(f"{engine}/{topo}/{codec}/{'dp' if dp else 'nodp'}",
             engine, topo, codec, dp)
            for engine in ("dense", "cohort") for topo in ("local", "sharded")
            for codec in ("identity", "int8") for dp in (False, True)]


def diagonal_configs():
    """Four configs that take each value of every axis."""
    keep = {"dense/local/identity/nodp", "dense/sharded/int8/dp",
            "cohort/local/int8/dp", "cohort/sharded/identity/nodp"}
    return [c for c in matrix_configs() if c[0] in keep]


def record_round(step, state, inputs, device) -> tuple:
    """(state, the recorder) of round 0 of ``inputs`` run under the
    recorder (on the card also under sync-debug "error")."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.set_sync_debug_mode("error")
    try:
        with Recorder() as rec:
            state, _ = rounds.loop_rounds(step, state, inputs)
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode(0)
    return state, rec


def run_config(name: str, engine: str, topo_kind: str, codec_name: str,
               dp_on: bool, device="cpu", plant=None) -> list:
    """One config: a warm-up round, then one recorded round; every check on
    it. ``plant`` (a function of the topology) runs inside the recorded
    round's step, after it, to plant a fault."""
    data, params0, fl = problem(device)
    topo, groups = topology(topo_kind, device)
    codec = codecs_lib.make_codec(codec_name)
    dp = DPConfig(clip_norm=1.0, noise_multiplier=1.0) if dp_on else None
    cohort = engine == "cohort"
    step = algorithms.make_algorithm1_step(
        mlp.per_sample_loss, data, fl, participation=_S if cohort else None,
        codec=codec, cohort=cohort, dp=dp, topology=topo)
    if plant is not None:
        inner = step

        def step(state, inp):
            out = inner(state, inp)
            plant(topo)
            return out

    state = algorithms._wrap_codec_state(
        optimizer.ssca_init(params0), codec,
        lambda: algorithms._sample_ef0(params0, data.num_clients, device, cohort))
    state = topo.place_state(state)
    inputs = rounds.make_inputs(fl, 1, 2, rnd.PRNGKey(3, device=device))
    first, second = (type(inputs)(*(x[r:r + 1] for x in inputs)) for r in (0, 1))
    state, _ = rounds.loop_rounds(step, state, first)       # warm-up
    _, rec = record_round(step, state, second, device)
    ev = rec.events
    details = [
        ("no_host_sync", check_no_host_sync(ev)),
        ("dp_before_encode", check_dp_before_encode(ev, dp_on, codec_name == "int8")),
        ("collectives", check_collectives(ev, groups)),
        ("wire_dtypes", check_wire_dtypes(encoded(codec, _P * _J + _J * _L, device),
                                          codec_name)
         if codec is not None else []),
        ("no_f64", check_no_f64(ev)),
    ]
    return [ContractViolation(name, check, d) for check, ds in details for d in ds]


def run_matrix(configs=None, device="cpu") -> ContractReport:
    """Every config of ``configs`` (default the whole matrix), the TopK
    wire check and the metric stream's."""
    configs = matrix_configs() if configs is None else configs
    started = not dist.is_initialized()
    violations = []
    try:
        for cfg in configs:
            violations.extend(run_config(*cfg, device=device))
        violations.extend(ContractViolation("topk", "wire_dtypes", d)
                          for d in check_wire_dtypes(
                              encoded(codecs_lib.make_codec("topk"), 64, device), "topk"))
        violations.extend(ContractViolation("obs/stream", "obs", d)
                          for d in check_obs(device))
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    return ContractReport([c[0] for c in configs] + ["topk", "obs/stream"],
                          violations)
