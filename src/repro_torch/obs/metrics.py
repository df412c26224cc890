"""``MetricStream``: per-round metrics streamed to host sinks while the
rounds run (``repro.obs.metrics``).

The rounds keep their metrics on the device (``core/rounds.py``: a round
never reads a value back). The stream runs K rounds as ceil(K/F) chunks of
F = ``flush_every`` rounds through the same engine (``rounds.loop_rounds``,
so trajectories and stacked metrics are unchanged), and at each chunk's end
stacks the chunk's metrics into one (F, M) fp32 device matrix, copies it
and the (F,) round numbers into pinned host memory with
``non_blocking=True``, records a CUDA event, and queues the three. A daemon
*drainer* thread waits on the event (never the dispatch thread), builds the
rows and feeds the sinks, so the host goes on launching the next chunk
while rows reach the file. On the CPU the copy is a plain one and there is
no event.

Rows are the reference's: ``{<metric>: float, ..., "kind": "round", "t":
<global round>}``, metric names sorted, each value cast to float32 and then
to a Python float; ``log_every`` thins round rows on the host by their t.
``emit_event`` interleaves other rows (eval results, host spans) in
dispatch order through the same queue; a 0-d device tensor in such a row is
staged like a chunk's metrics and becomes a float in the drainer. ``sync``
waits until every queued row has reached the sinks; ``close`` syncs and
closes them.
"""
from __future__ import annotations

import queue
import threading
import weakref

import torch


def _stage(tensors, dtype):
    """Stack device values into one tensor of ``dtype`` and start its copy
    to host memory: (host tensor, CUDA event or None). Pinned memory and a
    non-blocking copy on the card, so the caller never waits."""
    dev = tensors[0].device
    stacked = torch.stack([t.to(dtype) for t in tensors])
    if dev.type != "cuda":
        return stacked, None
    host = torch.empty(stacked.shape, dtype=dtype, pin_memory=True)
    host.copy_(stacked, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(dev))
    return host, event


def _drain_loop(stream_ref, q):
    """Daemon drainer: waits on each queued copy, builds rows and feeds the
    sinks, off the dispatch thread. Holds only a weakref to the stream; exits
    once the stream is collected."""
    while True:
        try:
            item = q.get(timeout=1.0)
        except queue.Empty:
            if stream_ref() is None:
                return
            continue
        try:
            stream = stream_ref()
            if stream is not None:
                kind, *rest = item
                if kind == "rounds":
                    stream._flush_rows(*rest)
                else:
                    row = _event_row(*rest)
                    with stream._lock:
                        stream._emit(row)
                        stream._flush_sinks()
        finally:
            q.task_done()


def _event_row(row, names, staged):
    """An event row with its staged tensor values made Python floats."""
    if names:
        host, event = staged
        if event is not None:
            event.synchronize()
        row = dict(row)
        row.update(zip(names, host.tolist()))
    return row


class MetricStream:
    """Streams per-round scalar metrics to host sinks while the rounds run.

    Use through the drivers (``run_rounds(..., obs=stream)``, any
    ``core.algorithms`` / ``core.baselines`` / ``local_updates`` driver's
    ``obs=``, ``train_loop(log_jsonl=)``) or call :meth:`run` in place of
    ``rounds.loop_rounds``; the returned ``(state, stacked metrics)`` are
    the engine's.

    sinks: rows go to each in order and are kept in :attr:`rows`.
    log_every: emit every Nth round row (by the global round t); event rows
    are never thinned. flush_every: rounds a flush-chunk (capped at the
    dispatch's size)."""

    def __init__(self, sinks=(), log_every: int = 1, flush_every: int = 200,
                 name: str = "run"):
        self.sinks = tuple(sinks)
        self.log_every = max(1, int(log_every))
        self.flush_every = max(1, int(flush_every))
        self.name = name
        self.rows: list = []
        self._lock = threading.Lock()
        self._queue = None

    # -- host side ----------------------------------------------------------

    def _emit(self, row: dict):
        self.rows.append(row)
        for s in self.sinks:
            s.emit(row)

    def _flush_sinks(self):
        for s in self.sinks:
            f = getattr(s, "flush", None)
            if f is not None:
                f()

    def _ensure_drainer(self):
        if self._queue is None:
            self._queue = queue.Queue()
            threading.Thread(target=_drain_loop,
                             args=(weakref.ref(self), self._queue),
                             daemon=True,
                             name=f"obs-drain-{self.name}").start()
        return self._queue

    def _flush_rows(self, names, t_staged, mat_staged):
        """Drainer target: one chunk's staged (1, F) round numbers and
        (M, F) fp32 metrics, waited on here, become F rows in round order."""
        for _, event in (t_staged, mat_staged):
            if event is not None:
                event.synchronize()
        t_list = t_staged[0][0].tolist()
        vals = mat_staged[0].t().tolist()
        with self._lock:
            for i, t in enumerate(t_list):
                t = int(t)
                if t % self.log_every:
                    continue
                # reserved keys last, so a metric named "t" or "kind" cannot
                # shadow the row schema
                row = dict(zip(names, vals[i]))
                row["kind"] = "round"
                row["t"] = t
                self._emit(row)
            self._flush_sinks()

    def emit_event(self, row: dict):
        """Append a non-round row (eval result, host span) in order with the
        streamed round rows. 0-d tensor values are staged to the host without
        a wait and become Python floats in the drainer."""
        row = dict(row)
        names = [k for k, v in row.items() if isinstance(v, torch.Tensor)]
        staged = (_stage([row[k].reshape(()) for k in names], torch.float64)
                  if names else None)
        if names or self._queue is not None:
            self._ensure_drainer().put(("event", row, names, staged))
        else:
            with self._lock:
                self._emit(row)
                self._flush_sinks()

    def sync(self):
        """Block until every queued row has reached the sinks."""
        if self._queue is not None:
            self._queue.join()

    def close(self):
        """Drain pending rows and close every sink."""
        self.sync()
        for s in self.sinks:
            s.close()

    # -- the rounds ---------------------------------------------------------

    def run(self, step_fn, state, inputs, driver: str = "scan"):
        """``rounds.loop_rounds(step_fn, state, inputs)`` in flush-chunks,
        queueing each chunk's metrics for the drainer. ``driver`` is "scan"
        or "loop" (the port runs both as the same loop). Returns as soon as
        the last chunk is launched; rows appear as the chunks complete."""
        from repro_torch.core import rounds as rounds_lib

        if driver not in rounds_lib.ENGINES:
            raise ValueError(f"unknown driver {driver!r} (choose scan|loop)")
        k = inputs.num_rounds
        f = min(self.flush_every, k)
        parts = []
        for c0 in range(0, k, f):
            chunk = (inputs if f == k else
                     type(inputs)(*(x[c0:c0 + f] for x in inputs)))
            state, ms = rounds_lib.loop_rounds(step_fn, state, chunk)
            if ms:
                names = tuple(sorted(ms))
                self._ensure_drainer().put((
                    "rounds", names, _stage([chunk.t], torch.int64),
                    _stage([ms[n] for n in names], torch.float32)))
            parts.append(ms)
        if not parts or not parts[0]:
            return state, {}
        if len(parts) == 1:
            return state, parts[0]
        return state, {key: torch.cat([p[key] for p in parts])
                       for key in parts[0]}
