"""Pluggable row sinks and the run manifest (``repro.obs.sinks``).

A *row* is a flat JSON-serializable dict with a ``"kind"`` discriminator
(``round``, ``eval``, ``span``); a *sink* has ``emit(row)`` and ``close()``
(and optionally ``flush()``, called once a flush-chunk). ``MetricStream``
fans every row out to its sinks in order. The rows are the reference's, key
for key.

The *manifest* records what a run was, as one JSON document next to the
log: every key of the reference's manifest (``time``, ``git_sha``,
``jax_version``, ``backend``, ``device_count``, ``device_kind``,
``config``, ``codec``, ``topology``, and ``hlo_cost`` when a cost is given),
with this runtime's values (``jax_version`` is None: the port runs no JAX),
plus ``torch_version``. ``bench_json`` writes a payload and its manifest.
"""
from __future__ import annotations

import csv
import json
import os
import subprocess
import time
from typing import Optional

import torch

from repro_torch import device as device_lib


def _jsonable(v):
    """Best-effort conversion of a row/manifest value to JSON-serializable
    form (0-d tensors and numpy scalars -> python; unknown objects ->
    repr)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if hasattr(v, "item") and getattr(v, "ndim", None) == 0:
        return v.item()
    if hasattr(v, "_asdict"):          # NamedTuple configs
        return _jsonable(v._asdict())
    if hasattr(v, "__dict__") and type(v).__module__ != "builtins":
        try:
            return _jsonable(vars(v))
        except TypeError:
            pass
    return repr(v)


class JsonlSink:
    """One JSON object per line, buffered; flushed once a flush-chunk."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "w")

    def emit(self, row: dict):
        try:
            line = json.dumps(row)
        except (TypeError, ValueError):
            line = json.dumps(_jsonable(row))
        self._f.write(line + "\n")

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


class CsvSink:
    """Buffers rows and writes one CSV at close with the union of all keys
    (first-seen column order); missing cells are empty."""

    def __init__(self, path: str):
        self.path = path
        self._rows: list = []

    def emit(self, row: dict):
        self._rows.append(_jsonable(row))

    def close(self):
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        cols: list = []
        for r in self._rows:
            for k in r:
                if k not in cols:
                    cols.append(k)
        with open(self.path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=cols, restval="")
            w.writeheader()
            w.writerows(self._rows)


class StdoutSink:
    """`k=v` lines to stdout (the train loop's log format)."""

    def __init__(self, prefix: str = ""):
        self.prefix = prefix

    def emit(self, row: dict):
        body = " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in _jsonable(row).items())
        print((self.prefix + " " + body) if self.prefix else body, flush=True)

    def close(self):
        pass


class MemorySink:
    """Keeps rows in a list (tests, notebooks)."""

    def __init__(self):
        self.rows: list = []

    def emit(self, row: dict):
        self.rows.append(dict(row))

    def close(self):
        pass


# ---------------------------------------------------------------------------
# run manifest
# ---------------------------------------------------------------------------


def git_sha() -> Optional[str]:
    """HEAD sha of the checkout this package lives in, or None."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else None
    except (OSError, subprocess.SubprocessError):
        return None


def _topology_info(topology) -> Optional[dict]:
    if topology is None:
        return None
    return {"name": getattr(topology, "name", type(topology).__name__),
            "num_shards": getattr(topology, "num_shards", 1)}


def run_manifest(config=None, *, codec=None, topology=None, cost=None,
                 extra=None, device=None) -> dict:
    """Everything needed to interpret a metrics log, as one dict: the
    runtime (``device``, default the card: "gpu" and the card's name, or
    "cpu"), provenance (git sha, wall time), the protocol (config, codec,
    topology) and, with ``cost=``, a per-dispatch cost record."""
    dev = device_lib.given_or_card(device)
    on_card = dev.type == "cuda"
    man = {
        "time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "git_sha": git_sha(),
        "jax_version": None,
        "backend": "gpu" if on_card else "cpu",
        "device_count": torch.cuda.device_count() if on_card else 1,
        "device_kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "config": _jsonable(config),
        "codec": getattr(codec, "name", None) if codec is not None
                 else (codec if isinstance(codec, str) else None),
        "topology": _topology_info(topology),
        "torch_version": torch.__version__,
    }
    if cost is not None:
        man["hlo_cost"] = _jsonable(cost)
    if extra:
        man.update(_jsonable(dict(extra)))
    return man


def write_manifest(path: str, config=None, *, codec=None, topology=None,
                   cost=None, extra=None, device=None) -> dict:
    """Build ``run_manifest`` and write it to ``path`` as indented JSON."""
    man = run_manifest(config, codec=codec, topology=topology, cost=cost,
                       extra=extra, device=device)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(man, f, indent=1)
    return man


def bench_json(path: str, payload, *, manifest: Optional[dict] = None,
               **manifest_kwargs):
    """Payload to ``path``, run manifest to ``path + ".manifest.json"``."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(_jsonable(payload), f, indent=1)
    man = manifest if manifest is not None else run_manifest(**manifest_kwargs)
    with open(path + ".manifest.json", "w") as f:
        json.dump(_jsonable(man), f, indent=1)
    print(f"# wrote {path} (+ {os.path.basename(path)}.manifest.json)",
          flush=True)
