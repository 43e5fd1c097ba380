"""The idle split of ``program_spans``: on a synthetic trace a device gap
inside a planted program span is put down to it, the parts add up to the
idle time, and the launches count per step by the calls of the main and
autograd threads, recorded on the device or not; on the card a
20 ms host sleep inside a span between two kernels reads as a gap of 19-21
ms under that span (``python -m pytest -m cuda
benchmark/tests/test_bench_program_spans.py``)."""

import time

import pytest
import torch

from benchmark import program_spans
from genhancer_tpu_torch import tracing

BASE = 1_700_000_000_000_000_000      # the trace's baseTimeNanoseconds
MAIN, AUTOGRAD = 11, 12


def _span(name, a_us, b_us, tid=MAIN):
    return tracing.Span(name, BASE + int(a_us * 1000), BASE + int(b_us * 1000), tid, 0,
                        None, 0)


def _op(ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": dur, "tid": 7,
            "args": {"correlation": corr}}


def _launch(ts, corr, tid=MAIN):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "tid": tid, "args": {"correlation": corr}}


def test_a_gap_inside_a_planted_span_is_put_down_to_it():
    # stretch 0-1000 us; step 100-900 with input.wait 0-100 before it; the
    # device runs 150-300, 500-600 and 650-950; the host sleeps 300-480 in
    # frozen.tower and launches the backward 600-900 from the autograd thread
    spans = [_span(tracing.INPUT_WAIT, 0, 100), _span(tracing.STEP, 100, 900),
             _span(tracing.FROZEN_TOWER, 120, 480), _span(tracing.BACKWARD, 600, 900),
             _span(tracing.DIT_ATTENTION_BWD_BEGIN, 640, 640, AUTOGRAD),
             _span(tracing.DIT_ATTENTION_BWD_END, 700, 700, AUTOGRAD)]
    events = [_op(150, 150, 1), _op(500, 100, 2), _op(650, 300, 3),
              _launch(140, 1), _launch(490, 2), _launch(645, 3, AUTOGRAD),
              _launch(960, 4)]
    trace = {"baseTimeNanoseconds": BASE, "traceEvents": events + [_op(970, 10, 4)]}
    r = program_spans.read(trace, spans, MAIN, BASE, BASE + 1_000_000)
    assert r["steps"] == 1
    by = {k: round(v * 1e6, 6) for k, v in r["idle_by_span"].items()}
    # 0-150: input.wait 0-100, step 100-120, frozen.tower 120-150; 300-500
    # frozen.tower to 480, then step; 600-650 backward; 950-970 and
    # 980-1000 nothing open
    assert by == {tracing.INPUT_WAIT: 100.0, tracing.STEP: 40.0,
                  tracing.FROZEN_TOWER: 210.0, tracing.BACKWARD: 50.0,
                  program_spans.HARNESS: 40.0}
    assert r["idle_s"] == pytest.approx(440e-6)
    assert r["idle_input_s"] + r["idle_launch_s"] + r["idle_harness_s"] == \
        pytest.approx(r["idle_s"])
    assert r["idle_input_s"] == pytest.approx(100e-6)
    assert r["idle_launch_s"] == pytest.approx(300e-6)
    assert r["host_step_s"] == pytest.approx(800e-6)
    assert r["frozen_host_s"] == pytest.approx(360e-6)
    assert r["launches"] == 3                     # the launch at 960 is outside the step
    dev = {k: round(v * 1e6, 6) for k, v in r["device_s"].items()}
    assert dev[tracing.FROZEN_TOWER] == 150.0 and dev[tracing.BACKWARD] == 300.0
    assert dev[tracing.STEP] == 550.0 and dev[tracing.DIT_ATTENTION + ".bwd"] == 300.0


def test_launches_count_the_main_and_autograd_threads_calls_recorded_or_not():
    # step 100-900; the main thread launches at 140 and 490 and copies at
    # 700, whose operation the profiler did not record; the autograd thread
    # launches at 645; the prefetch thread copies at 155; a call that puts
    # nothing on the device (cudaFuncGetAttributes) and a launch after the
    # step do not count
    spans = [_span(tracing.STEP, 100, 900), _span(tracing.INPUT_H2D, 150, 160, 13),
             _span(tracing.DIT_ATTENTION_BWD_BEGIN, 640, 640, AUTOGRAD)]
    copy = dict(_launch(700, 5), name="cudaMemcpyAsync")
    attr = dict(_launch(300, 6), name="cudaFuncGetAttributes")
    events = [_op(150, 150, 1), _op(500, 100, 2), _op(650, 100, 3), _op(200, 10, 4),
              _op(950, 10, 7), _launch(140, 1), _launch(490, 2), _launch(645, 3, AUTOGRAD),
              dict(_launch(155, 4, 13), name="cudaMemcpyAsync"), copy, attr, _launch(940, 7)]
    trace = {"baseTimeNanoseconds": BASE, "traceEvents": events}
    r = program_spans.read(trace, spans, MAIN, BASE, BASE + 1_000_000)
    assert r["launches"] == 4
    assert r["launches_unrecorded"] == 1


def test_no_device_operation_on_the_spans_clock_reads_none():
    trace = {"baseTimeNanoseconds": BASE, "traceEvents": [_op(5e9, 10, 1)]}
    assert program_spans.read(trace, [], MAIN, BASE, BASE + 1_000_000) is None


def test_segments_cut_nested_spans_by_the_innermost():
    segs = program_spans.segments([(0, 10, "a"), (2, 4, "b"), (4, 6, "c"), (8, 10, "d")])
    inner = [(a, b, n) for a, b, n in segs if a != float("-inf") and b != float("inf")]
    assert inner == [(0, 2, "a"), (2, 4, "b"), (4, 6, "c"), (6, 8, "a"), (8, 10, "d")]


@pytest.mark.cuda
def test_a_host_sleep_in_a_span_reads_as_a_gap_under_it(card, tmp_path):
    x = torch.randn(256, 256, device=card)
    for _ in range(3):
        x @ x
    torch.cuda.synchronize()

    def fn():
        with tracing.span(tracing.STEP, step=0):
            y = x @ x
            with tracing.span(tracing.FROZEN_TOWER):
                end = time.perf_counter() + 0.02     # a busy wait: no oversleep
                while time.perf_counter() < end:
                    pass
            (y @ x).sum()

    res = program_spans.stretch(fn, str(tmp_path / "p.json"), log=print)
    assert res is not None and res["steps"] == 1
    assert 0.019 <= res["idle_by_span"][tracing.FROZEN_TOWER] <= 0.021, res["idle_by_span"]
    assert res["idle_input_s"] + res["idle_launch_s"] + res["idle_harness_s"] == \
        pytest.approx(res["idle_s"])
