"""Spans and counters of the port, on the clock of ``torch.profiler``'s
chrome trace.

Tracing is off by default.  Off, ``span`` costs one read of a module-level
boolean and returns one shared null context: it reads no clock, records
nothing and touches no device.  ``enable()`` turns it on, ``drain()`` takes
what was recorded and ``disable()`` turns it off again.

On, a span records its name, its start and end in nanoseconds of
``time.time_ns()`` (CLOCK_REALTIME: a chrome trace event's ``ts``, in
microseconds, plus the trace's ``baseTimeNanoseconds`` / 1000 is the same
clock), the native id of its thread (the ``tid`` the profiler writes), its
parent (the span open around it on the same thread) and the optimizer step
it belongs to.  The ``step`` span sets that step: spans inside it carry its
``step`` attribute, and spans after it, up to the next ``step`` span (the
next step's input wait), the step after it.  A ``step`` span also records,
as it ends, the step's launches of each hand-written kernel (the kernel
modules' ``LAUNCHES`` counters, ``launch_counts``) as counter samples
named ``launches.<kernel>``.  Records go into a bounded buffer that keeps
the newest ``capacity``.

While a ``torch.profiler`` is active, a span also opens
``torch.profiler.record_function(name)``, so that it shows in the
profiler's own trace; ``add_to_trace`` adds the counter samples to such a
trace as chrome counter tracks, and the spans of threads it did not trace.

Spans and counters (names below, each with its reader in PERF.md):

  * ``step``: a whole step function (``train.step_utils``,
    ``tasks.image``, ``tasks.video``);
  * ``input.wait``, ``input.queue_depth`` (counter): the trainer's take of
    a prefetched batch (``data.prefetch``); ``input.h2d``: the prefetch
    thread's pin and copy of a batch; ``input.decode``: a loader's
    assembly of one batch, on the prefetch thread (``data.video``,
    ``data.cc3m``);
  * ``frozen.vae_encode``, ``frozen.tower``: the frozen encoders
    (``models.vae.vae_encode``, ``tasks.conditioning.tower_features``);
  * ``dit.forward``, ``dit.double`` / ``dit.single`` (attribute
    ``index``), ``dit.attention`` and its backward's two marks
    ``dit.attention.bwd_begin`` / ``dit.attention.bwd_end`` (zero-length
    spans dropped by identity autograd functions on the attention's output
    and inputs; the kernels launched between them on one thread are its
    backward);
  * ``loss`` (``tasks.image.masked_loss``), ``backward`` (around
    ``loss.backward()``);
  * ``optim.apply``, ``optim.reduce``, ``optim.gather``
    (``train.state.apply_gradients``).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional

import torch

STEP = "step"
INPUT_WAIT = "input.wait"
INPUT_H2D = "input.h2d"
INPUT_DECODE = "input.decode"
FROZEN_VAE = "frozen.vae_encode"
FROZEN_TOWER = "frozen.tower"
DIT_FORWARD = "dit.forward"
DIT_DOUBLE = "dit.double"
DIT_SINGLE = "dit.single"
DIT_ATTENTION = "dit.attention"
DIT_ATTENTION_BWD_BEGIN = "dit.attention.bwd_begin"
DIT_ATTENTION_BWD_END = "dit.attention.bwd_end"
LOSS = "loss"
BACKWARD = "backward"
OPTIM_APPLY = "optim.apply"
OPTIM_REDUCE = "optim.reduce"
OPTIM_GATHER = "optim.gather"
FROZEN = (FROZEN_VAE, FROZEN_TOWER)

INPUT_QUEUE_DEPTH = "input.queue_depth"
LAUNCHES_PREFIX = "launches."

CAPACITY = 1 << 16


@dataclass(frozen=True)
class Span:
    name: str
    start_ns: int
    end_ns: int
    tid: int
    id: int
    parent: Optional[int]
    step: Optional[int]
    attrs: Dict[str, object] = field(default_factory=dict)


@dataclass(frozen=True)
class Sample:
    name: str
    t_ns: int
    value: float
    tid: int
    step: Optional[int]


@dataclass
class Drained:
    spans: List[Span]
    samples: List[Sample]
    dropped: int


class _Recorder:
    """The records of one enabled stretch: a bounded buffer shared by every
    thread, each thread's stack of open spans, the current step."""

    def __init__(self, capacity: int):
        self.buf: collections.deque = collections.deque(maxlen=capacity)
        self.added = 0
        self.ids = itertools.count(1)
        self.local = threading.local()
        self.step: Optional[int] = None
        self.lock = threading.Lock()

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def add(self, record) -> None:
        with self.lock:
            self.added += 1
            self.buf.append(record)


_on = False
_rec = _Recorder(CAPACITY)
_NULL = contextlib.nullcontext()


def enabled() -> bool:
    return _on


def enable(capacity: int = CAPACITY) -> None:
    """Start recording into a fresh buffer of ``capacity`` records.  The
    first ``record_function`` of a process takes about a millisecond more
    than the next: it is taken here, not in the first span."""
    global _on, _rec
    with torch.profiler.record_function("tracing.enable"):
        pass
    _rec = _Recorder(capacity)
    _on = True


def disable() -> None:
    global _on
    _on = False


def drain() -> Drained:
    """Take the records so far (spans and counter samples, each in the order
    they ended) and empty the buffer; ``dropped`` counts the records the
    bound pushed out."""
    rec = _rec
    with rec.lock:
        items = list(rec.buf)
        rec.buf.clear()
        dropped, rec.added = rec.added - len(items), 0
    return Drained([r for r in items if isinstance(r, Span)],
                   [r for r in items if isinstance(r, Sample)], dropped)


class _Open:
    __slots__ = ("rec", "name", "attrs", "id", "parent", "step", "start", "rf", "launches")

    def __init__(self, rec: _Recorder, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        rec = self.rec
        stack = rec.stack()
        self.parent = stack[-1].id if stack else None
        self.id = next(rec.ids)
        if self.name == STEP:
            rec.step = self.attrs.get("step")
            self.launches = launch_counts()
        self.step = rec.step
        stack.append(self)
        self.rf = None
        self.start = time.time_ns()
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        end = time.time_ns()
        rec = self.rec
        rec.stack().pop()
        tid = threading.get_native_id()
        rec.add(Span(self.name, self.start, end, tid, self.id, self.parent, self.step,
                     self.attrs))
        if self.name == STEP:
            now = launch_counts()
            for k, v in now.items():
                rec.add(Sample(LAUNCHES_PREFIX + k, end, v - self.launches.get(k, 0), tid,
                               self.step))
            if self.step is not None:
                rec.step = self.step + 1
        return False


def span(name: str, **attrs):
    """A context manager recording the span ``name`` while tracing is on; a
    shared null context while it is off."""
    if not _on:
        return _NULL
    return _Open(_rec, name, attrs)


def count(name: str, value: float) -> None:
    """Record a counter sample ``name`` = ``value`` now (tracing on only)."""
    if not _on:
        return
    rec = _rec
    rec.add(Sample(name, time.time_ns(), float(value), threading.get_native_id(), rec.step))


def mark(name: str) -> None:
    """Record the zero-length span ``name`` now, under the thread's
    innermost open span (tracing on only)."""
    if not _on:
        return
    rec = _rec
    stack = rec.stack()
    if torch.autograd._profiler_enabled():
        with torch.profiler.record_function(name):
            pass
    t = time.time_ns()
    rec.add(Span(name, t, t, threading.get_native_id(), next(rec.ids),
                 stack[-1].id if stack else None, rec.step))


class _BackwardMark(torch.autograd.Function):
    """Identity whose backward drops the mark ``name``."""

    @staticmethod
    def forward(ctx, name, *xs):
        ctx.name = name
        out = tuple(x.view_as(x) for x in xs)
        return out if len(out) > 1 else out[0]

    @staticmethod
    def backward(ctx, *grads):
        mark(ctx.name)
        return (None, *grads)


def backward_mark(name: str, *xs: torch.Tensor):
    """``xs`` unchanged, through an identity autograd function whose
    backward drops the mark ``name``; call only while tracing is on and
    autograd records."""
    return _BackwardMark.apply(name, *xs)


def each(name: str, items: Iterable) -> Iterator:
    """``items``, each ``next()`` of it inside the span ``name`` (a
    generator's work per item, on the thread that iterates it)."""
    it = iter(items)
    end = object()
    try:
        while True:
            with span(name):
                item = next(it, end)
            if item is end:
                return
            yield item
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch counter in this process, by its ``LAUNCHES`` key."""
    from .core.kernels import adamw, flash_attention, int8_dw, rowquant, short_attention
    return {k: v for m in (short_attention, flash_attention, adamw, rowquant, int8_dw)
            for k, v in m.LAUNCHES.items()}


def add_to_trace(path: str, drained: Drained) -> None:
    """Add the drained records to the chrome trace at ``path`` (written by
    ``torch.profiler``), on its clock: the counter samples as counter tracks
    (``"ph": "C"``), and the spans of the threads the profiler did not
    trace (the prefetch thread's: it traces the thread that started it and
    the autograd engine's) as ``user_annotation`` ranges."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    traced = {e.get("tid") for e in events if e.get("cat") == "user_annotation"}
    added = [{"ph": "X", "cat": "user_annotation", "name": s.name, "pid": pid, "tid": s.tid,
              "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3}
             for s in drained.spans if s.tid not in traced]
    added += [{"ph": "C", "name": s.name, "pid": pid, "tid": s.tid,
               "ts": (s.t_ns - base) / 1e3, "args": {"value": s.value}}
              for s in drained.samples]
    events.extend(added)
    with open(path, "w") as f:
        json.dump(trace, f)
