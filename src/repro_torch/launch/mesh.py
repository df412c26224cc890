"""Device meshes on ``torch.distributed`` (``repro.launch.mesh``): the
client and feature meshes of the sharded topology, the production meshes
of the model-parallel launch layer, partition specs, and the collectives
over a mesh's axes.

The reference is single-controller: one process holds every array and
``jax.jit``/``shard_map`` split them over a ``jax.sharding.Mesh``. The port
runs one process a rank (SPMD): every rank runs the same driver, and a mesh
here is a ``torch.distributed.device_mesh.DeviceMesh`` with the reference's
axis names: one axis for the client meshes ("data" for the sample-based
clients, "model" for the feature clients), ("data", "model") or ("pod",
"data", "model") for the production meshes (``make_production_mesh``,
``make_mesh``). Rank r sits at the mesh coordinate of r in row-major
order, as ``init_device_mesh`` lays it out. A mesh of n ranks on a group
of more spans ranks 0..n-1, as the reference takes ``devices[:n]``; the
others are outside it (``outside``): they hold no block and join none of
its collectives, and ``from_first_rank`` hands them rank 0's result.

The device picks the backend: NCCL on a CUDA device (with
``torch.cuda.set_device(LOCAL_RANK)``), gloo on the CPU. A group the caller
has already started is taken as it is, whatever its backend. Run alone (no
``torchrun`` environment) the helpers start a one-rank group themselves
(an in-process ``HashStore``: no file, no port), which still runs every
collective: the reference's 1-device mesh still runs its shard_map + psum
path. Under ``torchrun --nproc-per-node D`` the mesh spans the D ranks. A
failed NCCL start raises; gloo never stands in for it.

A partition spec is the port's ``P``: a tuple with one entry a tensor
dim, each None (replicated), an axis name, or a tuple of names (the dim
split over them, the first the major one), as ``jax.sharding.
PartitionSpec``'s entries; dims past its length are replicated. A spec
tree is a nested dict of them, each a leaf to ``core.tree.tree_map``
(``models/*.param_specs``, ``cache_specs``).
``shard_tree`` cuts a tree to this rank's blocks, ``gather_tree`` puts the
blocks back together, ``named`` gives the DTensor placements a spec means.
The collectives over a tuple of axes run one axis at a time and skip an
axis of size 1: there the result is the tensor itself, no copy and no
collective, so a 1x1 mesh computes exactly what the local path does.

``StandInMesh`` is a mesh of any shape with no process group behind it,
seen from rank 0 (the dry run's production meshes): its collectives take
meta tensors, return meta outputs of the right shapes, move nothing, and
report their bytes to the running cost counters (``roofline.cost``).

The ambient mesh (``use_mesh``, ``ambient``) is the counterpart of the
reference's ``with mesh:``: the layer code finds the model and data axes
there (``layers.moe``, ``layers.moe_expert_parallel``). It is process-wide,
not thread-local, because a rank is a process and autograd's recompute of a
checkpointed layer runs on its own device thread.

Functions only: importing this module touches no process group.
"""
from __future__ import annotations

import contextlib
import io
import math
import os
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch import device as device_lib
from repro_torch.core.tree import tree_map
from repro_torch.roofline import cost


def backend_for(device) -> str:
    """NCCL on a CUDA device, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_group(device=None) -> torch.device:
    """Start this process's default group unless one is running: under
    ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the master's
    address in the environment) over its ranks, else a one-rank group.
    Returns the device this rank computes on (``cuda:LOCAL_RANK`` on a
    card; ``device=None`` is the card, as everywhere in the port)."""
    dev = device_lib.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dist.is_initialized():
        return dev
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend_for(dev)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dev


def make_client_mesh(num_devices: int | None = None, axis: str = "data",
                     device=None):
    """1-D client mesh (the group started by ``init_group`` when none
    runs): ``axis`` carries the paper's clients, rank r holds the r-th
    contiguous block of them. Over every rank by default; ``num_devices``
    ranks, at most the group's, span ranks 0..num_devices-1 and leave the
    others idle (``make_mesh``)."""
    n = _world() if num_devices is None else num_devices
    return make_mesh((n,), (axis,), device=device)


def make_feature_mesh(num_devices: int | None = None, device=None):
    """1-D "model"-axis mesh for the sharded feature-based topology: each
    rank holds a contiguous block of the vertical-FL feature clients.
    Same rank policy as :func:`make_client_mesh`."""
    return make_client_mesh(num_devices, axis="model", device=device)


# ---------------------------------------------------------------------------
# production meshes
# ---------------------------------------------------------------------------

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _world() -> int:
    """The group's rank count, or the one ``init_group`` would start."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def make_mesh(shape, axes=("data", "model"), device=None):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over ranks
    0..n-1 of the group (started by ``init_group`` when none runs), n the
    product of ``shape``, as the reference builds its mesh from
    ``devices[:n]``. Every rank of the group must call it (the mesh's
    groups are made collectively); on a group of more than n ranks the
    others are ``outside`` the mesh. A group of fewer raises, before any
    group starts."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    n = math.prod(shape)
    if _world() < n:
        raise RuntimeError(
            f"need {n} ranks for a {shape} mesh, the group has {_world()}; "
            f"run under torchrun --nproc-per-node {n}")
    dev = init_group(device)
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    if n == dist.get_world_size():
        return init_device_mesh(dev.type, shape, mesh_dim_names=axes)
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def outside(mesh) -> bool:
    """Whether this rank lies outside ``mesh`` (a mesh over the first n
    ranks of a larger group): it holds no block and joins none of the
    mesh's collectives. False for a ``StandInMesh``."""
    coordinate = getattr(mesh, "get_coordinate", None)
    return coordinate is not None and coordinate() is None


def rank_device(mesh) -> torch.device:
    """The device this rank computes on for ``mesh``: the current card for
    a CUDA mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def idle_step(mesh):
    """The step of a rank ``outside`` ``mesh``: whatever it is passed, it
    computes nothing and returns rank 0's result of the same call
    (``from_first_rank``); its ``grad_of`` and ``forward`` alike."""
    def step(*args, **kwargs):
        return from_first_rank(mesh, None)
    step.grad_of = step.forward = step
    return step


def from_first_rank(mesh, result):
    """``result`` on every rank of the group. Where ``mesh`` spans fewer
    ranks than the group, rank 0 sends its result once, by one broadcast
    over the whole group (every rank must call this), and a rank outside
    the mesh returns that copy, its tensors on its ``rank_device``; a rank
    inside keeps its own. A mesh over the whole group (or a stand-in)
    returns ``result`` with no collective."""
    if (not dist.is_initialized() or isinstance(mesh, StandInMesh)
            or mesh.size() == dist.get_world_size()):
        return result
    payload = None
    if dist.get_rank() == 0:
        buf = io.BytesIO()
        torch.save(result, buf)
        payload = buf.getvalue()
    box = [payload]
    dist.broadcast_object_list(box, src=0)
    if not outside(mesh):
        return result
    return torch.load(io.BytesIO(box[0]), map_location=rank_device(mesh),
                      weights_only=False)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production mesh: (16, 16) ("data", "model"), or
    (2, 16, 16) ("pod", "data", "model") with ``multi_pod``, over the
    first 256 (512) ranks. Raises, before starting any group, unless the
    group has at least that many."""
    return make_mesh(*PRODUCTION[multi_pod], device=device)


class StandInMesh:
    """A mesh of ``shape`` over ``axes`` with no process group: rank 0's
    view of it (every coordinate 0). The collectives over its axes take
    meta tensors only (see the module doc)."""

    def __init__(self, shape, axes):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(axes)

    def get_local_rank(self, axis) -> int:
        return 0

    def __repr__(self):
        return f"StandInMesh({self.shape}, {self.mesh_dim_names})"


def production_stand_in(multi_pod: bool = False) -> StandInMesh:
    """The production mesh as a stand-in (no group, no ranks needed)."""
    return StandInMesh(*PRODUCTION[multi_pod])


# ---------------------------------------------------------------------------
# partition specs
# ---------------------------------------------------------------------------


class P(tuple):
    """A partition spec: ``P(None, "data", "model")``; see the module
    docstring. Equal, entry for entry, to the reference's ``PartitionSpec``
    of the same entries, whose normal form it takes: a tuple of one name is
    that name, an empty tuple None."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return e[0] if len(e) == 1 else (e or None)
            return e
        return super().__new__(cls, map(norm, entries))

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


def entry_axes(e) -> tuple:
    """The axis names of a spec entry: () for None."""
    return () if e is None else (e,) if isinstance(e, str) else tuple(e)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (or any object with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def axis_size(mesh, axes) -> int:
    """The product of the sizes of ``axes`` (a name, a tuple of names or
    None); an axis the mesh lacks counts 1."""
    sizes = axis_sizes(mesh)
    return math.prod(sizes.get(a, 1) for a in entry_axes(axes))


def axis_index(mesh, axes) -> int:
    """This rank's coordinate over ``axes`` flattened, the first the major
    one (0 for an axis the mesh lacks)."""
    sizes, idx = axis_sizes(mesh), 0
    for a in entry_axes(axes):
        if a in sizes:
            idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx


def data_axes(mesh) -> tuple:
    """The axes a global-batch dimension shards over."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def adapt_for_mesh(spec_tree, mesh):
    """Rewrites activation/cache specs written against the single-pod axis
    names: any "data" entry becomes ("pod", "data") on a multi-pod mesh.
    Param specs are not adapted: FSDP stays within a pod."""
    if "pod" not in mesh.mesh_dim_names:
        return spec_tree
    return tree_map(lambda spec: P(*(("pod", "data") if e == "data" else e
                                     for e in spec)), spec_tree)


def _shape(x) -> tuple:
    return tuple(getattr(x, "shape", x))


def fit_specs(spec_tree, shape_tree, mesh):
    """Shape-aware spec repair (the reference's): an entry whose axis size
    does not divide its dim is re-homed to the largest other unassigned dim
    it divides (a batch-1 decode cache shards its sequence instead), else
    dropped; an axis appears once. ``shape_tree`` holds ``torch.Size``s,
    tuples or tensors."""
    def fit(spec, shp):
        shape = _shape(shp)
        entries = list(spec) + [None] * (len(shape) - len(spec))
        out, homeless, seen = [None] * len(shape), [], set()
        for i, e in enumerate(entries[:len(shape)]):
            if e is None:
                continue
            names = entry_axes(e)
            if any(n in seen for n in names):
                continue
            seen.update(names)
            n = axis_size(mesh, e)
            if shape[i] % n == 0 and shape[i] >= n:
                out[i] = e
            else:
                homeless.append(e)
        for e in homeless:
            n = axis_size(mesh, e)
            cands = [i for i in range(len(shape))
                     if out[i] is None and shape[i] % n == 0 and shape[i] >= n]
            if cands:
                out[max(cands, key=lambda i: shape[i])] = e
        return P(*out)

    return tree_map(fit, spec_tree, shape_tree)


def named(mesh, spec_tree):
    """Spec tree -> the DTensor placements each spec means: a tuple of one
    ``Shard(dim)`` or ``Replicate()`` a mesh dim, in the mesh's order (two
    mesh dims on one tensor dim shard it major first, as the spec's
    tuple)."""
    from torch.distributed.tensor import Replicate, Shard

    def place(spec):
        dims = {a: i for i, e in enumerate(spec) for a in entry_axes(e)}
        return tuple(Shard(dims[a]) if a in dims else Replicate()
                     for a in mesh.mesh_dim_names)

    return tree_map(place, spec_tree)


def named_fitted(mesh, spec_tree, shape_tree):
    return named(mesh, fit_specs(spec_tree, shape_tree, mesh))


def check_fits(spec, shape, mesh, what):
    """Raises, naming ``what``, where ``spec`` does not fit ``shape``: more
    entries than dims, or a dim its entry's axes do not divide."""
    if len(spec) > len(shape):
        raise ValueError(f"{what}: spec {spec} has more entries than the "
                         f"shape {tuple(shape)} has dims")
    for i, e in enumerate(spec):
        n = axis_size(mesh, e)
        if shape[i] % n:
            raise ValueError(
                f"{what}: dim {i} of {tuple(shape)} does not divide over "
                f"{e!r} ({n} ranks); the steps take the reference's named "
                "specs, which must divide (fit_specs re-homes them)")


def shard_tree(tree, mesh, spec_tree, what="tree"):
    """This rank's block of every leaf: along each dim its spec entry
    names, the block at this rank's coordinate over those axes. Where no
    named axis has more than one rank the block is the tensor itself (a
    view, never a copy); otherwise a contiguous copy, so that the whole
    tensor can be freed. Raises where an entry does not divide its dim."""
    def cut(spec, t):
        check_fits(spec, t.shape, mesh, what)
        out = t
        for i, e in enumerate(spec):
            n = axis_size(mesh, e)
            if n > 1:
                k = out.shape[i] // n
                out = out.narrow(i, axis_index(mesh, e) * k, k)
        return out if out is t else out.contiguous()

    return tree_map(cut, spec_tree, tree)


def gather_tree(tree, mesh, spec_tree):
    """The whole leaves back from every rank's blocks (``shard_tree``'s
    inverse): an all-gather over each named axis; the tensor itself where
    no named axis has more than one rank."""
    def whole(spec, t):
        for i, e in enumerate(spec):
            t = all_gather_axes(t, mesh, e, dim=i)
        return t

    return tree_map(whole, spec_tree, tree)


# ---------------------------------------------------------------------------
# collectives over mesh axes (one axis at a time; a size-1 axis is skipped)
# ---------------------------------------------------------------------------

_all_gather_single = getattr(dist, "all_gather_single", None) or getattr(
    dist, "all_gather_into_tensor")
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or getattr(
    dist, "reduce_scatter_tensor")


def _live(mesh, axes) -> tuple:
    """The axes of ``axes`` that have more than one rank."""
    sizes = axis_sizes(mesh)
    return tuple(a for a in entry_axes(axes) if sizes.get(a, 1) > 1)


def _stand_in(mesh, x, kind, out) -> bool:
    """Whether ``mesh`` is a stand-in; if so, ``kind`` of ``x`` into
    ``out`` is reported to the cost counters (x must be on the meta
    device: the stand-in moves nothing)."""
    if not isinstance(mesh, StandInMesh):
        return False
    if x.device.type != "meta":
        raise ValueError(f"{mesh!r}: collectives take meta tensors, got "
                         f"{x.device}")
    cost.collective(kind, out, x)
    return True


def all_gather_axes(x, mesh, axes, dim: int = 0):
    """Every rank's ``x`` over ``axes`` concatenated along ``dim`` in their
    flattened order (the minor axis gathered first)."""
    sizes = axis_sizes(mesh)
    for a in reversed(_live(mesh, axes)):
        n = sizes[a]
        x = x.contiguous()
        out = x.new_empty((n * x.shape[0], *x.shape[1:]))
        if not _stand_in(mesh, x, "all-gather", out):
            _all_gather_single(out, x, group=mesh.get_group(a))
        x = out.view(n, *x.shape).movedim(0, dim).flatten(dim, dim + 1)
    return x


def reduce_scatter_axes(x, mesh, axes, dim: int = 0):
    """``x`` summed over ``axes``, this rank keeping its block along
    ``dim`` (the major axis first)."""
    sizes = axis_sizes(mesh)
    for a in _live(mesh, axes):
        parts = x.contiguous().unflatten(dim, (sizes[a], -1)).movedim(
            dim, 0).contiguous()
        out = parts.new_empty(parts.shape[1:])
        if not _stand_in(mesh, parts, "reduce-scatter", out):
            _reduce_scatter_single(out, parts.flatten(0, 1),
                                   group=mesh.get_group(a))
        x = out
    return x


def slice_axes(x, mesh, axes, dim: int = 0):
    """This rank's block of ``x`` along ``dim`` over ``axes`` (a view)."""
    live = _live(mesh, axes)
    n = axis_size(mesh, live)
    if n == 1:
        return x
    k = x.shape[dim] // n
    return x.narrow(dim, axis_index(mesh, live) * k, k)


def all_reduce_axes(x, mesh, axes):
    """``x`` summed over ``axes``, in place (returned)."""
    for a in _live(mesh, axes):
        if not _stand_in(mesh, x, "all-reduce", x):
            dist.all_reduce(x, group=mesh.get_group(a))
    return x


# ---------------------------------------------------------------------------
# the ambient mesh
# ---------------------------------------------------------------------------

_AMBIENT = [None]


@contextlib.contextmanager
def use_mesh(mesh):
    """Makes ``mesh`` the ambient mesh inside the block (the reference's
    ``with mesh:``); the one before comes back after it."""
    before = _AMBIENT[0]
    _AMBIENT[0] = mesh
    try:
        yield mesh
    finally:
        _AMBIENT[0] = before


def ambient():
    """The ambient mesh, or None outside ``use_mesh``."""
    return _AMBIENT[0]


def model_axis_divides(n: int) -> bool:
    """True iff the ambient mesh has a "model" axis whose size divides n."""
    m = ambient()
    if m is None or "model" not in m.mesh_dim_names:
        return False
    return n % axis_sizes(m)["model"] == 0


# ---------------------------------------------------------------------------
# gathering params to compute: each leaf read whole from this rank's block
# ---------------------------------------------------------------------------


class LeafPlan(NamedTuple):
    """How a param leaf is read on a mesh. ``gather``: (dim, axis) pairs,
    the block all-gathered along dim over axis, minor axes first; the
    gradient goes back through them, sliced over the model axis first
    (model ranks compute on the same rows, so their gradients are equal),
    then summed over each data axis (a reduce-scatter: the ranks' rows
    differ). ``sum``: axes the gradient is all-reduced over besides, the
    data axes the leaf is replicated over, and "model" for a leaf whose
    model ranks each hold part of its gradient. An entry may not mix data
    and other axes on one dim."""
    gather: tuple
    sum: tuple


def leaf_plan(spec, mesh, model_local=False, model_partial=False) -> LeafPlan:
    """The plan of a leaf of ``spec``: gathered over every axis its spec
    names, except "model" with ``model_local`` (the expert-parallel
    experts, which stay this rank's); its gradient also summed over the
    data axes it is replicated over, and over "model" with
    ``model_partial``."""
    gather, named_axes = [], set()
    data = data_axes(mesh)
    for i, e in enumerate(spec):
        if len({a in data for a in entry_axes(e)}) > 1:
            raise ValueError(f"spec {spec}: entry {e!r} mixes data and other "
                             "axes on one dim")
        for a in reversed(_live(mesh, e)):
            named_axes.add(a)
            if not (model_local and a == "model"):
                gather.append((i, a))
    sums = [a for a in _live(mesh, data) if a not in named_axes]
    if model_partial and _live(mesh, "model"):
        sums.append("model")
    return LeafPlan(tuple(gather), tuple(sums))


def drop_plan(plan: LeafPlan, n: int) -> LeafPlan:
    """The plan of a leaf's entries along its first ``n`` (stacked, never
    sharded) dims."""
    if any(i < n for i, _ in plan.gather):
        raise ValueError(f"a stacked dim is sharded: {plan}")
    return plan._replace(gather=tuple((i - n, a) for i, a in plan.gather))


class _GatherLeaf(torch.autograd.Function):
    """A leaf read whole from this rank's block (``LeafPlan``)."""

    @staticmethod
    def forward(ctx, x, mesh, plan):
        ctx.mesh, ctx.plan = mesh, plan
        for dim, a in plan.gather:
            x = all_gather_axes(x, mesh, a, dim)
        return x if plan.gather else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, data = ctx.mesh, data_axes(ctx.mesh)
        # the model slices first: the reduce-scatters then move less
        back = list(reversed(ctx.plan.gather))
        for dim, a in [p for p in back if p[1] not in data]:
            g = slice_axes(g, mesh, a, dim)
        for dim, a in [p for p in back if p[1] in data]:
            g = reduce_scatter_axes(g, mesh, a, dim)
        if ctx.plan.sum:
            g = all_reduce_axes(g.clone(memory_format=torch.contiguous_format),
                                mesh, ctx.plan.sum)
        return g, None, None


def gather_leaf(x, mesh, plan: LeafPlan):
    """``x`` whole, by its plan; ``x`` itself where the plan has nothing to
    do (every axis of size 1)."""
    if not plan.gather and not (plan.sum and x.requires_grad):
        return x
    return _GatherLeaf.apply(x, mesh, plan)


class Gathered:
    """A params tree whose leaves are read whole, each from this rank's
    block as its plan says, when the model code reads them: the model code
    runs unchanged on whole tensors. ``local`` is a nested dict of blocks,
    whose stacked entries (``Model.stacked``) may also be lists of
    per-entry dicts (``train.grad_leaves``); ``plans`` has the nesting of
    the dicts, with the stacked dims. ``layers.take`` of a stacked entry
    gives entry i, whose leaves are then gathered one entry at a time
    (inside the layer's checkpoint, so the recompute gathers again).
    Reads outside stacked entries are kept (``memo``): the tied embedding
    serves the lookup and the logits from one gather, and a stacked
    entry's per-entry views are made once a step."""

    def __init__(self, local, plans, mesh, memo=True):
        self._local, self._plans, self._mesh = local, plans, mesh
        self._memo = {} if memo else None
        self._entry_plans = None

    def _wrap(self, v, plan, memo):
        if isinstance(v, (list, tuple)):
            plan = tree_map(lambda p: drop_plan(p, 1), plan)
            return [self._wrap(x, plan, False) for x in v]
        if isinstance(v, dict):
            return Gathered(v, plan, self._mesh, memo)
        return gather_leaf(v, self._mesh, plan)

    def __getitem__(self, k):
        memo = self._memo
        if memo is not None and k in memo:
            return memo[k]
        out = self._wrap(self._local[k], self._plans[k], memo is not None)
        if memo is not None:
            memo[k] = out
        return out

    def __contains__(self, k):
        return k in self._local

    def take(self, i: int):
        """Entry i of stacked blocks, gathered one entry at a time."""
        if self._entry_plans is None:
            self._entry_plans = tree_map(lambda p: drop_plan(p, 1), self._plans)
        return Gathered(tree_map(lambda t: t[i], self._local),
                        self._entry_plans, self._mesh, memo=False)
