"""The program's own spans and counters (``genhancer_tpu_torch.tracing``)
over a stretch traced on the device alone, and the device's idle time put
down to what the host was doing.

    python3 -m benchmark.program_spans --workload <cell> --seeds a,b,... [--seconds s]

runs the cell's ``--trace 1`` run once per seed, with its device-only
stretch (``spans.device_busy``) traced by ``stretch`` instead, and prints
one line per seed: ``correct``, the numbers below per optimizer step, the
idle split and the device ms by program span, and the run's per-layer
metrics.  The benchmark's own runs (``benchmark.run``) do not run it.

``stretch`` runs the steps under a profiler that traces the device alone
(as ``spans.device_busy`` does, so the host runs at near its real speed)
with the program's tracing on, then drains the spans.  Their stamps and the
trace's events share a clock: a span's nanoseconds less the trace's
``baseTimeNanoseconds``, over 1000, is an event's ``ts``.

Per optimizer step (the main thread's ``step`` spans in the stretch):

  * ``host_step_s``: host seconds inside ``step``;
  * ``frozen_host_s``: host seconds inside ``frozen.vae_encode`` and
    ``frozen.tower``;
  * the idle split: each interval of the stretch in which no device
    operation ran, cut where the main thread's innermost open program span
    changes, each part put down to that span: ``input.wait`` to the input
    (``idle_input_s``), any other span to the launch (``idle_launch_s``),
    none to the harness's own code (``idle_harness_s``); the three add up
    to the stretch's idle time;
  * ``launches``: the calls that put work on the device (kernel launches,
    copies, sets: CUDA API calls named ``*Launch*``,
    ``*Memcpy*``, ``*Memset*``) made inside a ``step`` span by the main
    thread or the autograd engine's (the threads of the
    ``dit.attention.bwd_*`` marks); the prefetch thread's copies of the
    next batch are left out.  The calls, not the device's records of the
    operations: the profiler drops the records of the last operations of a
    stretch (``launches_unrecorded``, §5 of PERF.md).  Where the trace has
    no runtime calls, the device operations by their own start.

A program without the tracing module (an older commit) gives None, and
the stretch does not run.
"""

from __future__ import annotations

import bisect
import json
import sys
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .spans import DEVICE_CATS, _union

HARNESS = "(no program span)"


def stretch(fn, trace_path: str, log=print) -> Optional[dict]:
    """Run ``fn`` between two synchronizes under a CUDA-only profiler with
    the program's tracing on; return ``read`` of the trace and the spans,
    or None where the program has no tracing module."""
    try:
        from genhancer_tpu_torch import tracing
    except ImportError:
        log("program spans: the program has no tracing module; no stretch")
        return None
    main = threading.get_native_id()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        tracing.enable()
        try:
            t0 = time.time_ns()
            fn()
            torch.cuda.synchronize()
            t1 = time.time_ns()
        finally:
            tracing.disable()
    drained = tracing.drain()
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        trace = json.load(f)
    res = read(trace, drained.spans, main, t0, t1)
    if res is None:
        log("program spans: no device operation lies in the stretch on the spans' clock")
        return None
    res["dropped"] = drained.dropped
    n = max(res["steps"], 1)
    log(f"program spans: launch calls in the stretch whose device operation the trace "
        f"lacks {res['launches_unrecorded']}")
    log("program spans: device idle ms per step by the main thread's innermost span: "
        + ", ".join(f"{k} {1e3 * v / n:.3f}" for k, v in
                    sorted(res["idle_by_span"].items(), key=lambda x: -x[1])))
    log(f"program spans: per step idle {1e3 * res['idle_s'] / n:.3f} ms = input "
        f"{1e3 * res['idle_input_s'] / n:.3f} + launch {1e3 * res['idle_launch_s'] / n:.3f}"
        f" + harness {1e3 * res['idle_harness_s'] / n:.3f}; host in step "
        f"{1e3 * res['host_step_s'] / n:.3f}, in frozen {1e3 * res['frozen_host_s'] / n:.3f};"
        f" launches {res['launches'] / n:.1f}; device ms by span: "
        + ", ".join(f"{k} {1e3 * v / n:.3f}" for k, v in sorted(res["device_s"].items())))
    return res


def _us(ns: int, base_ns: int) -> float:
    return (ns - base_ns) / 1e3


def is_launch(e: dict) -> bool:
    """A CUDA API call that puts work on the device: a kernel launch, a
    copy or a set."""
    n = e.get("name", "")
    return (e.get("cat") in ("cuda_runtime", "cuda_driver")
            and ("Launch" in n or "Memcpy" in n or "Memset" in n))


def segments(spans: Sequence[Tuple[float, float, str]]) -> List[Tuple[float, float, str]]:
    """The timeline of one thread's nested spans ``(start, end, name)`` cut
    into ``(a, b, innermost open span's name)``, ``HARNESS`` where none is
    open, from minus to plus infinity."""
    out: List[Tuple[float, float, str]] = []
    stack: List[Tuple[float, float, str]] = []
    t = float("-inf")

    def emit(a, b, name):
        if b > a:
            out.append((a, b, name))

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][1] <= s:
            top = stack.pop()
            emit(t, top[1], top[2])
            t = top[1]
        emit(t, s, stack[-1][2] if stack else HARNESS)
        stack.append((s, e, name))
        t = s
    while stack:
        top = stack.pop()
        emit(t, top[1], top[2])
        t = top[1]
    emit(t, float("inf"), HARNESS)
    return out


def split_gaps(gaps: Sequence[Tuple[float, float]],
               segs: Sequence[Tuple[float, float, str]]) -> Dict[str, float]:
    """Each gap's length cut over the segments it overlaps, by name."""
    starts = [a for a, _, _ in segs]
    out: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(segs) and segs[i][0] < b:
            lo, hi = max(a, segs[i][0]), min(b, segs[i][1])
            if hi > lo:
                out[segs[i][2]] += hi - lo
            i += 1
    return dict(out)


def _inside(intervals: List[Tuple[float, float]], x: float) -> bool:
    i = bisect.bisect_right(intervals, (x, float("inf"))) - 1
    return i >= 0 and intervals[i][0] <= x <= intervals[i][1]


def autograd_threads(spans: Sequence[Tuple[str, int, float, float]]) -> set:
    """The threads of ``spans`` (``(name, tid, start, end)``) that drop the
    attention's backward marks: the autograd engine's."""
    from genhancer_tpu_torch import tracing
    return {tid for name, tid, _, _ in spans
            if name in (tracing.DIT_ATTENTION_BWD_BEGIN, tracing.DIT_ATTENTION_BWD_END)}


def device_by_span(events: List[dict], spans: Sequence[Tuple[str, int, float, float]],
                   main: int, lo: float, hi: float) -> Dict[str, float]:
    """Device seconds of the operations in [lo, hi] by program span: each
    operation counts under every span open around its launch on the
    launching thread and, where that thread is the autograd engine's
    (``autograd_threads``), under those open on the main thread then (an
    input thread's copies stay out of them); ``dit.attention.bwd`` is the
    launches between a ``dit.attention.bwd_begin`` mark and the next
    ``dit.attention.bwd_end`` on one thread.  ``spans`` are ``(name, tid,
    start, end)`` in the trace's microseconds."""
    from genhancer_tpu_torch import tracing
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    by_tid: Dict[int, List[Tuple[float, float, str]]] = defaultdict(list)
    marks: Dict[Tuple[int, str], List[float]] = defaultdict(list)
    for name, tid, s, e in spans:
        if name in (tracing.DIT_ATTENTION_BWD_BEGIN, tracing.DIT_ATTENTION_BWD_END):
            marks[(tid, name)].append(s)
        else:
            by_tid[tid].append((s, e, name))
    for tid in {t for t, _ in marks}:
        ends = sorted(marks[(tid, tracing.DIT_ATTENTION_BWD_END)])
        for b in marks[(tid, tracing.DIT_ATTENTION_BWD_BEGIN)]:
            i = bisect.bisect_left(ends, b)
            if i < len(ends):
                by_tid[tid].append((b, ends[i], tracing.DIT_ATTENTION + ".bwd"))
    for v in by_tid.values():
        v.sort()
    autograd = autograd_threads(spans)

    def open_at(tid, x):
        return {n for s, e, n in by_tid.get(tid, ()) if s <= x <= e}

    out: Dict[str, float] = defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        if not (lo <= e["ts"] and e["ts"] + e["dur"] <= hi + 1.0):
            continue
        ln = launches.get(e.get("args", {}).get("correlation"))
        if ln is None:
            continue
        names = open_at(ln["tid"], ln["ts"])
        if ln["tid"] in autograd:
            names |= open_at(main, ln["ts"])
        for n in names:
            out[n] += e["dur"] * 1e-6
    return dict(out)


def read(trace: dict, spans, main: int, t0_ns: int, t1_ns: int) -> Optional[dict]:
    """The stretch's numbers (module docstring) from its chrome trace and
    the drained spans (``tracing.Span``); seconds over the whole stretch.
    None where no device operation lies in the stretch."""
    from genhancer_tpu_torch import tracing
    events = trace["traceEvents"]
    base = int(trace.get("baseTimeNanoseconds", 0))
    lo, hi = _us(t0_ns, base), _us(t1_ns, base)
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
              and lo <= e["ts"] and e["ts"] + e["dur"] <= hi + 1.0]
    if not device:
        return None
    sp = [(s.name, s.tid, _us(s.start_ns, base), _us(s.end_ns, base)) for s in spans]
    main_sp = [(s, e, n) for n, tid, s, e in sp if tid == main and s >= lo and e <= hi]
    steps = sorted((s, e) for s, e, n in main_sp if n == tracing.STEP)
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in device])
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    by_span = split_gaps(gaps, segments([x for x in main_sp if x[0] < x[1]]))
    idle_input = by_span.get(tracing.INPUT_WAIT, 0.0)
    idle_harness = by_span.get(HARNESS, 0.0)
    idle = sum(b - a for a, b in gaps)
    frozen = _union([(s, e) for s, e, n in main_sp if n in tracing.FROZEN])
    calls = [e for e in events if is_launch(e) and lo <= e["ts"] <= hi]
    recorded = {e.get("args", {}).get("correlation") for e in events
                if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS}
    own = {main} | autograd_threads(sp)
    if calls:
        launches = sum(1 for e in calls if e["tid"] in own and _inside(steps, e["ts"]))
    else:
        launches = sum(1 for e in device if _inside(steps, e["ts"]))
    return {"steps": len(steps), "window_s": (hi - lo) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6, "idle_s": idle * 1e-6,
            "idle_by_span": {k: v * 1e-6 for k, v in by_span.items()},
            "idle_input_s": idle_input * 1e-6, "idle_harness_s": idle_harness * 1e-6,
            "idle_launch_s": (sum(by_span.values()) - idle_input - idle_harness) * 1e-6,
            "host_step_s": sum(e - s for s, e in steps) * 1e-6,
            "frozen_host_s": sum(e - s for s, e in frozen) * 1e-6,
            "launches": launches,
            "launches_unrecorded": sum(1 for e in calls
                                       if e.get("args", {}).get("correlation") not in recorded),
            "device_s": device_by_span(events, sp, main, lo, hi)}


def main(argv=None) -> int:
    import argparse
    from . import run as bench_run  # noqa: F401  (the build and kernel caches' paths)
    from . import harness, spans
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    seconds = cell.run_seconds if args.seconds is None else args.seconds

    def log(m):
        print(m, file=sys.stderr)

    kept: List[dict] = []

    def busy_with_spans(fn, trace_path: str) -> dict:
        res = stretch(fn, trace_path, log)
        if res is None:
            raise RuntimeError("the program's spans read nothing in the stretch")
        kept.append(res)
        return {"busy_s": res["busy_s"], "window_s": res["window_s"]}

    spans.device_busy = busy_with_spans
    for seed in [int(x) for x in args.seeds.split(",")]:
        kept.clear()
        res = harness.run(cell, seed, seconds, True, log=log)
        p = kept[0]
        ms = 1e3 / p["steps"]
        print(json.dumps({
            "seed": seed, "correct": res["correct"], "steps": p["steps"],
            "host_step_ms": ms * p["host_step_s"], "frozen_host_ms": ms * p["frozen_host_s"],
            "idle_ms": ms * p["idle_s"], "idle_launch_ms": ms * p["idle_launch_s"],
            "idle_input_ms": ms * p["idle_input_s"], "idle_harness_ms": ms * p["idle_harness_s"],
            "launches_per_step": p["launches"] / p["steps"],
            "launches_unrecorded": p["launches_unrecorded"], "dropped": p["dropped"],
            "idle_by_span_ms": {k: ms * v for k, v in p["idle_by_span"].items()},
            "device_ms": {k: ms * v for k, v in p["device_s"].items()},
            "metrics": {k: v["value"] for k, v in res["metrics"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
