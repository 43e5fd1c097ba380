"""The harness's set-up and its trace reading, on the CPU: a cell whose
workload file asks for ``precomputed: features`` builds the stage-1
features cache from the seed's frozen weights and trains from it, the
reference working out the cache's crops again from the raw shards; and the
reading of a profiler trace into per-span device time, busy time and idle
gaps."""

import json

import pytest
import torch

from benchmark import harness, spans
from benchmark.tests import tiny

torch.set_num_threads(2)


def test_a_features_cache_cell_builds_its_cache_and_is_correct(monkeypatch, tmp_path):
    tiny.patch_registry(monkeypatch)
    built = []
    orig = harness.build_features_cache

    def spy(*a, **kw):
        out = orig(*a, **kw)
        built.append(out)
        return out
    monkeypatch.setattr(harness, "build_features_cache", spy)
    res = harness.run(tiny.cell("image", precomputed="features"), 2 ** 31 + 77, 0.5, False,
                      device="cpu", log=lambda m: None)
    assert len(built) == 1
    assert res["correct"], res["checks"]


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def test_read_trace(tmp_path):
    ev = [
        _ev("user_annotation", "bench.stretch", 0, 100),
        _ev("user_annotation", "bench.dit_fwd", 10, 20),
        _ev("user_annotation", "bench.attn_fwd", 12, 5),
        _ev("cuda_runtime", "cudaLaunchKernel", 11, 1, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 13, 1, correlation=2),
        _ev("cpu_op", "aten::mm", 40, 10),
        _ev("cpu_op", "autograd::engine::evaluate_function: MmBackward0", 50, 5, tid=2),
        _ev("user_annotation", "bench.attn_bwd_begin", 52, 0, tid=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 53, 1, tid=2, correlation=3),
        _ev("user_annotation", "bench.attn_bwd_end", 54, 0, tid=2),
        _ev("kernel", "gemm", 20, 10, tid=7, correlation=1),
        _ev("kernel", "attn", 30, 10, tid=7, correlation=2),
        _ev("kernel", "attn_bwd", 60, 20, tid=7, correlation=3),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    r = spans.read_trace(str(path))
    assert r["span_s"]["dit_fwd"] == pytest.approx(20e-6)
    assert r["span_s"]["attn_fwd"] == pytest.approx(10e-6)
    assert r["span_s"]["attn_bwd"] == pytest.approx(20e-6)
    assert r["span_s"]["backward"] == pytest.approx(20e-6)
    assert r["busy_s"] == pytest.approx(40e-6) and r["window_s"] == pytest.approx(100e-6)
    assert r["device_ops"][0] == ("attn_bwd", pytest.approx(20e-6))
    gaps = dict(r["idle_gaps"])
    # 0-20 and 80-100 with nothing open at their start, 40-60 under aten::mm
    assert gaps["aten::mm"] == pytest.approx(20e-6)
    assert gaps["(no op open)"] == pytest.approx(40e-6)
