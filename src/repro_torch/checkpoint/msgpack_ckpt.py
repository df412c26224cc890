"""Param checkpoints in the reference's msgpack format
(``repro.checkpoint.msgpack_ckpt``), byte for byte, in both directions.

The file is one msgpack map ``{"step": int, "leaves": [leaf, ...],
"treedef": str}``, each leaf ``{"__nd__": True, "dtype": str, "shape":
[int, ...], "data": bin}`` (the raw C-order bytes; dtype "bfloat16" for
bf16), the leaves in ``jax.tree`` order (sorted dict keys, lists and tuples
in order) and ``treedef`` equal to jax's ``str(treedef)`` for the same
nested dicts and lists, e.g. ``PyTreeDef({'b1': *, 'w1': *})``.

This module carries its own encoder and decoder for the subset of msgpack
the reference writes (map, str, int, float, bool, nil, array, bin), with
msgpack-python's choices (the smallest int and length forms, str8 and bin
types, float64), so the bytes equal ``msgpack.packb(payload,
use_bin_type=True)``. ``save_checkpoint`` streams the file leaf by leaf
(one leaf's host copy at a time, so a 6.17 GB save never holds the file in
memory); ``load_checkpoint`` reads each leaf's bytes straight into a
buffer that becomes the tensor (``torch.frombuffer``, bf16 included).
``save_state`` and ``load_state_`` keep an optimizer state (its params,
surrogates, scalars and an EF residual) in the same format and read it
back into the state's own flat buffers.
"""
from __future__ import annotations

import os
import struct

import torch

_DTYPES = {name: getattr(torch, name) for name in (
    "float32", "float64", "float16", "bfloat16", "int8", "int16", "int32",
    "int64", "uint8", "bool")}


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# msgpack: the subset the reference writes
# ---------------------------------------------------------------------------


def _header(small_base, small_max, forms, n):
    """A length/type header: a fix form when n <= small_max, else the first
    of ``forms`` ((code, struct format, limit)) that holds n."""
    if small_base is not None and n <= small_max:
        return bytes([small_base | n])
    for code, fmt, limit in forms:
        if n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} too large")


def _str_header(n):
    return _header(0xA0, 31, ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16),
                              (0xDB, ">I", 1 << 32)), n)


def _bin_header(n):
    return _header(None, -1, ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16),
                              (0xC6, ">I", 1 << 32)), n)


def _array_header(n):
    return _header(0x90, 15, ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32)), n)


def _map_header(n):
    return _header(0x80, 15, ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32)), n)


def _int(v: int) -> bytes:
    if 0 <= v < 128 or -32 <= v < 0:
        return struct.pack(">b", v) if v < 0 else bytes([v])
    if v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < limit:
                return bytes([code]) + struct.pack(fmt, v)
    for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                             (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
        if v >= -limit:
            return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"msgpack: int {v} out of range")


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for None, bool, int, float,
    str, bytes-like, list/tuple and dict."""
    out = []
    _pack_into(obj, out.append)
    return b"".join(out)


def _pack_into(obj, write):
    if obj is None:
        write(b"\xc0")
    elif obj is True or obj is False:
        write(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        write(_int(obj))
    elif isinstance(obj, float):
        write(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        write(_str_header(len(raw)) + raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = memoryview(obj).cast("B")
        write(_bin_header(raw.nbytes))
        write(raw)
    elif isinstance(obj, (list, tuple)):
        write(_array_header(len(obj)))
        for x in obj:
            _pack_into(x, write)
    elif isinstance(obj, dict):
        write(_map_header(len(obj)))
        for k, v in obj.items():
            _pack_into(k, write)
            _pack_into(v, write)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def _read(f, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise ValueError("msgpack: truncated input")
    return b


def unpack(f):
    """One msgpack object from the binary file ``f`` (the subset above);
    str as str, bin as a writable bytearray read in place."""
    code = _read(f, 1)[0]
    if code <= 0x7F:
        return code
    if code >= 0xE0:
        return code - 0x100
    if 0x80 <= code <= 0x8F:
        return _unpack_map(f, code & 0x0F)
    if 0x90 <= code <= 0x9F:
        return [unpack(f) for _ in range(code & 0x0F)]
    if 0xA0 <= code <= 0xBF:
        return _read(f, code & 0x1F).decode("utf-8")
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if code in simple:
        return simple[code]
    fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
             0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if code in fixed:
        fmt = fixed[code]
        return struct.unpack(fmt, _read(f, struct.calcsize(fmt)))[0]
    lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
               0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
    if code not in lengths:
        raise ValueError(f"msgpack: unsupported type byte 0x{code:02x}")
    fmt = lengths[code]
    n = struct.unpack(fmt, _read(f, struct.calcsize(fmt)))[0]
    if code in (0xC4, 0xC5, 0xC6):
        buf = bytearray(n)
        if f.readinto(buf) != n:
            raise ValueError("msgpack: truncated input")
        return buf
    if code in (0xD9, 0xDA, 0xDB):
        return _read(f, n).decode("utf-8")
    if code in (0xDC, 0xDD):
        return [unpack(f) for _ in range(n)]
    return _unpack_map(f, n)


def _unpack_map(f, n):
    out = {}
    for _ in range(n):
        k = unpack(f)
        out[k] = unpack(f)
    return out


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def _flatten(tree):
    """Leaves in jax.tree order: sorted dict keys, lists and tuples in
    order; None is a node with no leaves."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _flatten(t)]
    if tree is None:
        return []
    return [tree]


def treedef_str(tree) -> str:
    """jax's ``str(jax.tree.structure(tree))`` for nested dicts, lists,
    tuples and None over tensor leaves."""
    def node(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {node(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(node(x) for x in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(node(x) for x in t)
            return "(" + inner + ("," if len(t) == 1 else "") + ")"
        return "None" if t is None else "*"
    return f"PyTreeDef({node(tree)})"


def _rebuild(like, it):
    if isinstance(like, dict):
        return {k: _rebuild(like[k], it) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(t, it) for t in like)
    if like is None:
        return None
    return next(it)


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------


def _leaf_bytes(t):
    """A leaf's raw C-order bytes, as a host uint8 array (one copy)."""
    host = t.detach().contiguous().cpu().reshape(-1)
    return host.view(torch.uint8).numpy()


def save_checkpoint(path: str, tree, step: int = 0):
    """Write ``tree`` (nested dicts/lists of tensors on any device) and
    ``step`` to ``path`` in the reference's format, leaf by leaf, through a
    temporary file renamed into place."""
    leaves = _flatten(tree)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        write = f.write
        write(_map_header(3))
        _pack_into("step", write)
        _pack_into(int(step), write)
        _pack_into("leaves", write)
        write(_array_header(len(leaves)))
        for leaf in leaves:
            write(_map_header(4))
            for k, v in (("__nd__", True), ("dtype", _dtype_name(leaf.dtype)),
                         ("shape", [int(d) for d in leaf.shape])):
                _pack_into(k, write)
                _pack_into(v, write)
            _pack_into("data", write)
            raw = _leaf_bytes(leaf)
            write(_bin_header(raw.nbytes))
            write(raw)
            del raw
        _pack_into("treedef", write)
        _pack_into(treedef_str(tree), write)
    os.replace(tmp, path)


def _tensor(obj):
    dtype = _DTYPES.get(obj["dtype"])
    if dtype is None:
        raise ValueError(f"checkpoint leaf dtype {obj['dtype']!r} is not "
                         f"one of {sorted(_DTYPES)}")
    data = obj["data"]
    flat = (torch.frombuffer(data, dtype=dtype) if len(data)
            else torch.empty((0,), dtype=dtype))
    return flat.reshape(obj["shape"])


def load_checkpoint(path: str, like, cast: bool = False):
    """``like``: a tree of the same structure (e.g. a fresh init); its
    leaves are replaced by the stored arrays in flatten order, on each like
    leaf's device, after the treedef string is checked. Stored dtypes must
    match ``like``'s unless ``cast=True``. Returns (tree, step)."""
    with open(path, "rb") as f:
        payload = unpack(f)
    want = _flatten(like)
    stored = payload["leaves"]
    if len(stored) != len(want):
        raise ValueError(f"checkpoint has {len(stored)} leaves, expected "
                         f"{len(want)}")
    if payload["treedef"] != treedef_str(like):
        raise ValueError("checkpoint treedef mismatch")
    if not cast:
        bad = [f"leaf {i}: stored {s['dtype']} != expected "
               f"{_dtype_name(w.dtype)}"
               for i, (s, w) in enumerate(zip(stored, want))
               if s["dtype"] != _dtype_name(w.dtype)]
        if bad:
            raise ValueError(
                "checkpoint dtype mismatch (pass cast=True to convert "
                "explicitly): " + "; ".join(bad))
    restored = [_tensor(s).to(w.dtype).reshape(w.shape).to(w.device)
                for s, w in zip(stored, want)]
    return _rebuild(like, iter(restored)), payload["step"]


# ---------------------------------------------------------------------------
# optimizer states
# ---------------------------------------------------------------------------


def _is_state(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _storage(field: str) -> bool:
    """A flat buffer that a state's views lie in (w_flat, g_flat, w_side,
    g_side, obj_flat, obj_side): saved through its views."""
    return field.endswith(("_flat", "_side"))


def state_tree(state) -> dict:
    """An optimizer state (``core.optimizer``'s, or a ``CommCarry`` of one)
    as a checkpoint tree: its fields by name, nested states as dicts, the
    round counter ``t`` as a 0-d int64 tensor. The flat buffers are left
    out: the params and surrogate views over them (a bf16 model's fp32
    leaves among them, from its side buffers) carry every value once."""
    out = {}
    for f in state._fields:
        v = getattr(state, f)
        if v is None or _storage(f):
            continue
        out[f] = (state_tree(v) if _is_state(v)
                  else torch.tensor(v, dtype=torch.int64) if isinstance(v, int)
                  else v)
    return out


def save_state(path: str, state, step: int = 0):
    """``save_checkpoint`` of ``state_tree(state)``."""
    save_checkpoint(path, state_tree(state), step)


def _restore_(state, tree):
    kw = {}
    for f, v in tree.items():
        old = getattr(state, f)
        if _is_state(old):
            kw[f] = _restore_(old, v)
        elif isinstance(old, int):
            kw[f] = int(v)
        else:
            for dst, src in zip(_flatten(old), _flatten(v), strict=True):
                dst.copy_(src)
    return state._replace(**kw)


def load_state_(path: str, state):
    """Reads a ``save_state`` file into ``state``'s own tensors, in place:
    its views, so into its flat buffers, and its 0-d tensors (dtypes and
    the tree as ``load_checkpoint`` checks them). Returns (the state with
    the stored ``t``, step)."""
    tree, step = load_checkpoint(path, state_tree(state))
    return _restore_(state, tree), step
