"""The cost counter (``repro.roofline.hlo_cost.analyze`` and
``analysis.jit_cost_summary``): run a callable once under ``CostCounter``,
on meta, CPU or CUDA tensors, and read what it did.

    with CostCounter() as c:
        step(state, batch)
    c.summary()  # {"flops", "bytes", "collectives": {kind: bytes, "total"},
                 #  "kernels": {name: launches}, "kernel_work": {...}}

It sees every dispatched PyTorch op (a ``TorchDispatchMode``; on the
autograd engine's threads too) and counts:

- flops: 2·prod(out)·prod(contracted) of every product and convolution
  (``torch.utils.flop_counter``'s registry; an op outside it is first
  decomposed, as ``FlopCounterMode`` does). Elementwise ops count nothing.
- bytes: operand and output bytes of every op that moves data. Views and
  metadata ops (``is_view``: view, as_strided, t, transpose, expand, ...;
  detach, alias, the empty constructors) are left out.
- collectives: the output bytes of each c10d op (all-reduce, all-gather,
  reduce-scatter, all-to-all, broadcast, send/recv), keyed by kind, and
  the collectives a stand-in mesh records (``collective``).
- each hand-written kernel's launch, at the bytes and FLOPs of its own
  formula (``roofline.kernels``): the wrappers report it (``kernel``),
  and the ops a wrapper runs inside (its plain version on the CPU, its
  output allocations) are not counted again.

The port's loops are Python loops, so every iteration is seen: there is
no loop multiplier to apply. ``ACTIVE`` is empty when no counter runs, and
then a wrapper pays one check a launch.
"""
from __future__ import annotations

import contextlib
from collections import Counter, defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# running counters, innermost last
ACTIVE: list = []
# > 0 while a wrapper runs under a counter (its own body is not re-counted)
INSIDE = [0]

C10D_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast", "send": "collective-permute",
    "recv_": "collective-permute",
}
# ops that move no data besides the views
_NO_BYTES = frozenset({"detach", "alias", "lift_fresh", "empty", "empty_like",
                       "empty_strided", "new_empty", "new_empty_strided",
                       "_local_scalar_dense", "barrier", "monitored_barrier_"})


def nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensor_bytes(tree) -> int:
    return sum(nbytes(t) for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def c10d_kind(func):
    """The collective kind of a dispatched op, or None."""
    if func.namespace != "c10d":
        return None
    return C10D_KINDS.get(func._overloadpacket.__name__.split(".")[-1])


class _Mode(TorchDispatchMode):
    def __init__(self, counter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        c = self.counter
        if INSIDE[0] and not c.sees_plain:
            return func(*args, **kwargs)
        if func._overloadpacket not in flop_registry and func.namespace == "aten":
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        c.op(func, args, kwargs, out)
        return out


class CostCounter:
    """Counts what runs inside its block (see the module doc). Subclasses
    see each event through ``op`` and ``launch``; one with ``sees_plain``
    also sees the ops inside a wrapper (``inside`` is then > 0)."""

    sees_plain = False

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.collectives = defaultdict(int)
        self.kernels = Counter()
        self.kernel_work = defaultdict(lambda: {"flops": 0, "bytes": 0, "int_ops": 0})
        self._mode = _Mode(self)

    def __enter__(self):
        ACTIVE.append(self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        ACTIVE.remove(self)
        return False

    # -- events ----------------------------------------------------------

    def op(self, func, args, kwargs, out):
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        kind = c10d_kind(func)
        if kind is not None:
            self.collectives[kind] += _tensor_bytes(out)
        if func.is_view or packet.__name__.split(".")[-1] in _NO_BYTES:
            return
        self.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)

    def launch(self, name, work):
        self.kernels[name] += 1
        kw = self.kernel_work[name]
        kw["flops"] += int(work.flops)
        kw["bytes"] += int(work.bytes)
        kw["int_ops"] += int(work.int_ops)
        self.flops += int(work.flops)
        self.bytes += int(work.bytes)

    def collective(self, kind, out, inp):
        """A collective a stand-in mesh ran (nothing moved): ``out``'s
        bytes as its kind's, ``inp``'s and ``out``'s as bytes moved."""
        self.collectives[kind] += nbytes(out)
        self.bytes += nbytes(inp) + nbytes(out)

    def summary(self) -> dict:
        coll = {k: int(v) for k, v in self.collectives.items()}
        coll["total"] = sum(coll.values())
        return {"flops": int(self.flops), "bytes": int(self.bytes),
                "collectives": coll, "kernels": dict(self.kernels),
                "kernel_work": {k: dict(v) for k, v in self.kernel_work.items()}}


@contextlib.contextmanager
def kernel(name: str, work):
    """Around one wrapper call under running counters: each counts the
    launch at ``work``; the wrapper's own ops inside are left to the
    counters that see them (``sees_plain``)."""
    for c in ACTIVE:
        c.launch(name, work)
    INSIDE[0] += 1
    try:
        yield
    finally:
        INSIDE[0] -= 1


def collective(kind: str, out, inp) -> None:
    """Report a collective that a stand-in mesh ran to the counters."""
    for c in ACTIVE:
        c.collective(kind, out, inp)


def count(fn, *args, **kwargs) -> tuple:
    """(fn's result, the summary of its cost): fn run once under a fresh
    counter."""
    with CostCounter() as c:
        out = fn(*args, **kwargs)
    return out, c.summary()
