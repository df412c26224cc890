"""Phase labels, host spans and whole-run profiles (``repro.obs.trace``).

* ``phase(name)``: the protocol phase a block of a round belongs to
  (``round → client-compute → dp-privatize → codec-encode → aggregate``,
  the feature round's ``head-compute``). The reference's is a
  ``jax.named_scope``, free at run time. The port runs eagerly, where a
  ``torch.profiler.record_function`` costs host time on every call, and the
  rounds are bound by the host's launch rate; so ``phase`` labels the block
  only while a profiler is recording, and is a shared no-op context
  otherwise.
* ``HostSpans``: host wall-clock spans at dispatch boundaries, emitted as
  ``{"kind": "span", ...}`` rows through a stream and labelled on the
  profiler's timeline.
* ``profile(logdir)``: ``torch.profiler`` (host and CUDA activity) around
  a block, written to ``logdir`` as a Chrome trace (``trace.json``), where
  the reference writes an xprof/perfetto trace directory.
"""
from __future__ import annotations

import contextlib
import functools
import os
import time

import torch

# the canonical phase names, in protocol order; free-form names are allowed
PHASES = ("round", "client-compute", "codec-encode", "collective",
          "aggregate", "head-compute", "batch-select", "surrogate-solve")

_NULL = contextlib.nullcontext()


def phase(name: str):
    """A context labelling the enclosed block ``name`` on a profile: a
    ``record_function`` while a profiler is recording, else a no-op."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


def scoped(name: str, fn=None):
    """Wrap fn so every call runs under ``phase(name)``; usable directly,
    ``scoped("round", step_fn)``, or as a decorator."""
    if fn is None:
        return lambda f: scoped(name, f)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with phase(name):
            return fn(*args, **kwargs)
    return wrapped


class HostSpans:
    """Host-side wall-clock spans at dispatch boundaries. Each completed span
    appends ``{"kind": "span", "span": name, "dur_s": ..., **attrs}`` to
    :attr:`spans` and, with a stream attached (anything with
    ``emit_event(row)``), emits the row through it."""

    def __init__(self, stream=None):
        self.stream = stream
        self.spans: list = []

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        t0 = time.perf_counter()
        with phase(name):
            yield
        row = {"kind": "span", "span": name,
               "dur_s": time.perf_counter() - t0}
        row.update(attrs)
        self.spans.append(row)
        if self.stream is not None:
            self.stream.emit_event(row)


@contextlib.contextmanager
def profile(logdir: str):
    """Profile the enclosed block with ``torch.profiler`` (CPU, and CUDA
    when a card is present) and write ``logdir/trace.json``, a Chrome trace
    holding the ``phase`` labels and every ``HostSpans`` span; open it in
    ui.perfetto.dev or chrome://tracing."""
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
