"""The benchmark's own spans around the program's layers, and the reading
of a profiler trace into per-span device time.

Spans are ``torch.profiler.record_function`` ranges opened by wrappers that
the harness sets at set-up, in a ``--trace 1`` run only, around calls the
program makes by name (no program file is edited):

  * ``bench.frozen_fwd``: ``models.vae.vae_encode`` and the tasks'
    ``tower_features`` (the frozen VAE encode and tower forward);
  * ``bench.dit_fwd``: ``models.dit.dit_forward`` (bound by the loss
    factories when the trainer is built, so set before it);
  * ``bench.attn_fwd``: the DiT's attention entry as ``models.dit`` binds it
    (RoPE, the products, the head merge), whatever kernel implements it;
    its backward is bracketed by two zero-length marks,
    ``bench.attn_bwd_begin`` and ``bench.attn_bwd_end``, set by identity
    autograd functions on the entry's output and inputs, so that the
    kernels the autograd thread launches between them are the entry's
    backward;
  * ``bench.optimizer``: the trainer's ``optimizer.apply``;
  * ``bench.stretch``: the profiled steps, synchronized at both ends.

Tracing the host's every op slows the host severalfold, so the device's
busy time per step is read from a second stretch traced on the device
alone (``device_busy``); even that slows a host-bound step, so the idle
share takes its wall time from the unprofiled part of the window.

A kernel belongs to a span when the host call that launched it (the
trace's launch correlation) lies inside the span on the same thread.  The
backward is every kernel launched from the autograd engine's threads.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import json
from collections import defaultdict
from typing import Dict, List, Tuple

import torch
from torch.profiler import record_function

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class _Mark(torch.autograd.Function):
    """Identity whose backward drops a zero-length span named ``name``."""

    @staticmethod
    def forward(ctx, name, *xs):
        ctx.name = name
        out = tuple(x.view_as(x) for x in xs)
        return out if len(out) > 1 else out[0]

    @staticmethod
    def backward(ctx, *grads):
        with record_function(ctx.name):
            pass
        return (None, *grads)


class Spans:
    """Installs the wrappers and restores the originals on ``close``."""

    def __init__(self):
        self._saved: List[Tuple[object, str, object]] = []
        self.attn_shapes: List[Tuple[int, int, int, int]] = []

    def _wrap(self, owner, attr: str, make):
        orig = getattr(owner, attr)
        self._saved.append((owner, attr, orig))
        setattr(owner, attr, make(orig))

    @staticmethod
    def _span(name):
        def make(fn):
            @functools.wraps(fn)
            def run(*a, **kw):
                with record_function(name):
                    return fn(*a, **kw)
            return run
        return make

    def install_program(self) -> None:
        """Wrap the program's module-level entries; call before the
        ``Trainer`` is built."""
        from genhancer_tpu_torch.models import dit, vae
        from genhancer_tpu_torch.tasks import image, video
        self._wrap(vae, "vae_encode", self._span("bench.frozen_fwd"))
        self._wrap(image, "tower_features", self._span("bench.frozen_fwd"))
        self._wrap(video, "tower_features", self._span("bench.frozen_fwd"))
        self._wrap(dit, "dit_forward", self._span("bench.dit_fwd"))
        self._wrap(dit, "attention", self._attention)

    def install_optimizer(self, optimizer) -> None:
        self._wrap(optimizer, "apply", self._span("bench.optimizer"))

    def _attention(self, fn):
        shapes = self.attn_shapes

        @functools.wraps(fn)
        def run(q, k, v, cos, sin):
            shapes.append(tuple(q.shape))
            if torch.is_grad_enabled():
                q, k, v = _Mark.apply("bench.attn_bwd_end", q, k, v)
            with record_function("bench.attn_fwd"):
                out = fn(q, k, v, cos, sin)
            return _Mark.apply("bench.attn_bwd_begin", out) if torch.is_grad_enabled() else out
        return run

    def close(self) -> None:
        for owner, attr, orig in reversed(self._saved):
            setattr(owner, attr, orig)
        self._saved.clear()


@contextlib.contextmanager
def stretch():
    """The profiled steps: synchronized at both ends."""
    torch.cuda.synchronize()
    with record_function("bench.stretch"):
        yield
        torch.cuda.synchronize()


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def read_trace(path: str) -> dict:
    """Per-span device seconds, busy and window seconds, the costliest
    device operations and the idle gaps by the main thread's open CPU op,
    from a chrome trace written by ``torch.profiler``.  Times in seconds."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    stretch_ev = [e for e in events if e.get("cat") == "user_annotation"
                  and e["name"] == "bench.stretch"]
    if not stretch_ev:
        raise RuntimeError("the trace holds no bench.stretch span")
    st = stretch_ev[0]
    t0, t1, main = st["ts"], st["ts"] + st["dur"], st["tid"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and t0 <= e["ts"] and e["ts"] + e["dur"] <= t1 + 1.0]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    ann = defaultdict(list)           # (tid, name) -> sorted [(start, end)]
    marks = defaultdict(list)         # (tid, name) -> sorted [ts]
    for e in events:
        if e.get("cat") != "user_annotation":
            continue
        if e["name"] in ("bench.attn_bwd_begin", "bench.attn_bwd_end"):
            marks[(e["tid"], e["name"])].append(e["ts"])
        elif e["name"].startswith("bench."):
            ann[(e["tid"], e["name"])].append((e["ts"], e["ts"] + e["dur"]))
    bwd_tids = {e["tid"] for e in events if e.get("cat") == "cpu_op"
                and e["name"].startswith("autograd::engine::evaluate_function")}
    for tid in {t for t, _ in marks}:     # pair each begin with the next end
        begins = sorted(marks[(tid, "bench.attn_bwd_begin")])
        ends = sorted(marks[(tid, "bench.attn_bwd_end")])
        for b in begins:
            i = bisect.bisect_left(ends, b)
            if i < len(ends):
                ann[(tid, "bench.attn_bwd")].append((b, ends[i]))
    for key in ann:
        ann[key].sort()

    def inside(tid, name, ts) -> bool:
        spans = ann.get((tid, name), ())
        i = bisect.bisect_right(spans, (ts, float("inf"))) - 1
        return i >= 0 and spans[i][0] <= ts <= spans[i][1]

    span_s: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    for e in device:
        d = e["dur"] * 1e-6
        by_name[e["name"]] += d
        ln = launches.get(e.get("args", {}).get("correlation"))
        if ln is None:
            continue
        tid, ts = ln["tid"], ln["ts"]
        if tid in bwd_tids:
            span_s["backward"] += d
        for name in ("frozen_fwd", "dit_fwd", "attn_fwd", "attn_bwd", "optimizer"):
            if inside(tid, f"bench.{name}", ts):
                span_s[name] += d
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in device])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps = []
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    host_ops = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                       if e.get("tid") == main and e.get("cat") in ("cpu_op", "user_annotation",
                                                                    "python_function")
                       and e["name"] != "bench.stretch"), key=lambda x: x[0])
    starts = [h[0] for h in host_ops]
    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        j = bisect.bisect_right(starts, a)
        open_ops = [h for h in host_ops[max(0, j - 4000):j] if h[1] >= a]
        name = min(open_ops, key=lambda h: h[1] - h[0])[2] if open_ops else "(no op open)"
        idle[name] += (b - a) * 1e-6
    return {"span_s": dict(span_s), "busy_s": busy_s, "window_s": (t1 - t0) * 1e-6,
            "device_ops": sorted(by_name.items(), key=lambda x: -x[1])[:10],
            "idle_gaps": sorted(idle.items(), key=lambda x: -x[1])[:10]}


def profile(fn, trace_path: str) -> dict:
    """Run ``fn`` under ``torch.profiler`` (CPU and CUDA) inside
    ``stretch``, write the chrome trace to ``trace_path`` and read it."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with stretch():
            fn()
    prof.export_chrome_trace(trace_path)
    return read_trace(trace_path)


def device_busy(fn, trace_path: str) -> dict:
    """Run ``fn`` between two synchronizes under a CUDA-only profiler, whose
    cost on the host is small, and return the stretch's host seconds
    (``window_s``) and the union of its device operations (``busy_s``)."""
    import time
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        device = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in device])
    return {"busy_s": sum(b - a for a, b in busy) * 1e-6, "window_s": window_s}
