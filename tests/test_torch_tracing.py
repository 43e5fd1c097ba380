"""The port's spans and counters (``genhancer_tpu_torch.tracing``) on the CPU:
off they record nothing, read no clock and leave a step's numbers bit for bit
as they are; on they nest, carry the optimizer step across an accumulated
step's micro-batches, name the prefetch thread by its native id, keep a
bounded buffer, sit on ``torch.profiler``'s clock, and a tiny video stage-1
step emits each span as often as its layers run.  Also the trainer's
``--profile`` file and its ``step_time``."""

import json
import threading
import time

import numpy as np
import pytest
import torch
import yaml

from genhancer_tpu_torch import registry, tracing
from genhancer_tpu_torch.data import native_decode, testing
from genhancer_tpu_torch.data.prefetch import DevicePrefetcher
from genhancer_tpu_torch.models import dit as tdit
from genhancer_tpu_torch.models import vae as tvae
from genhancer_tpu_torch.models.towers import clip as tclip
from genhancer_tpu_torch.train import trainer as trainer_m
from genhancer_tpu_torch.train.config import load_config

torch.set_num_threads(1)

DIT = tdit.DiTConfig(in_channels=16, vec_in_dim=24, context_in_dim=32, hidden_size=64,
                     num_heads=4, depth=2, depth_single_blocks=1, axes_dim=(4, 6, 6))
VAE = tvae.VAEConfig(resolution=32, ch=8, ch_mult=(1, 2), num_res_blocks=1, z_channels=4)
TOWER = tclip.CLIPConfig(vision=tclip.CLIPVisionConfig(
    hidden_size=16, intermediate_size=32, num_layers=1, num_heads=2, image_size=32,
    patch_size=16), projection_dim=24)
ACCUM = 2


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and an empty buffer."""
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def _patch(mp) -> None:
    mp.setattr(registry, "build_dit_config", lambda name: DIT)
    mp.setattr(registry, "build_vae_config", lambda name, ae_path=None: VAE)
    mp.setattr(registry, "tower_family_and_config",
               lambda tower, size, clip_type=None: ("clip", TOWER))
    mp.setattr(native_decode, "available", lambda: False)


def _video_cfg(root, **overrides):
    shards = root / "videos"
    for i in range(2):
        testing.make_video_shard(str(shards / f"s{i}.tar"), 4, [6, 7, 8, 9], 40, seed=i)
    cfg = {"task": "video_sliding_stage1", "tower": "openai_clip", "model_name": "flux-dev",
           "data_config": {"train_batch_size": 2, "num_workers": 1, "img_size": 32,
                           "video_dir": str(shards), "seed": 0,
                           "return_mode": "full_frames", "max_frames_per_video": 200},
           "clip_config": {"clip_image_size": 32, "clip_dim": 24, "t5_dim": 32},
           "window_cond": 3, "window_stride": 1, "max_windows_per_video": 2,
           "output_dir": str(root / "out"), "max_train_steps": 100,
           "checkpointing_steps": 0, "learning_rate": 1e-3, "mixed_precision": "fp32",
           "vae_dtype": "fp32", "gradient_accumulation_steps": ACCUM,
           "report_to": "none", "log_interval": 1}
    cfg.update(overrides)
    path = root / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return load_config(str(path))


def _first_batch(trainer):
    batches = trainer._batches()
    try:
        batch = next(batches)
    finally:
        batches.close()
    batch.pop("__extras__", None)
    return batch


# ---------------------------------------------------------------------------
# off
# ---------------------------------------------------------------------------

def test_off_a_span_is_the_shared_null_context_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("a clock was read with tracing off")
    monkeypatch.setattr(time, "time_ns", no_clock)
    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    a, b = tracing.span(tracing.STEP, step=3), tracing.span(tracing.LOSS)
    assert a is b
    with a:
        tracing.count(tracing.INPUT_QUEUE_DEPTH, 2)
        tracing.mark(tracing.DIT_ATTENTION_BWD_BEGIN)
    d = tracing.drain()
    assert d.spans == [] and d.samples == [] and d.dropped == 0


@pytest.fixture(scope="module")
def video_step(tmp_path_factory):
    """A tiny video stage-1 trainer's first accumulated step, run twice on
    trainers built alike: with tracing off and with it on (drained); each
    run is (trainer, metrics, drained records, the batch).  The loaders are
    closed: a later step reuses the batch."""
    root = tmp_path_factory.mktemp("video")
    with pytest.MonkeyPatch.context() as mp:
        _patch(mp)
        cfg = _video_cfg(root)
        runs = []
        for on in (False, True):
            trainer = trainer_m.Trainer(cfg, device="cpu")
            batch = _first_batch(trainer)
            trainer._seed(0)
            if on:
                tracing.enable()
            try:
                trainer.state, m = trainer.step_fn(trainer.state, batch, trainer.generator)
            finally:
                tracing.disable()
            runs.append((trainer, m, tracing.drain() if on else None, batch))
            trainer.loader.close()
    return runs


def test_off_and_on_steps_are_bit_identical(video_step):
    (off, m_off, _, _), (on, m_on, drained, _) = video_step
    assert drained.spans
    assert torch.equal(m_off["loss"], m_on["loss"])
    assert torch.equal(m_off["grad_norm"], m_on["grad_norm"])
    for k, p in off.state.trainable.items():
        assert torch.equal(p.detach(), on.state.trainable[k].detach()), k
    for part in ("mu", "nu"):
        for k, v in off.state.opt_state[part].items():
            assert torch.equal(v, on.state.opt_state[part][k]), (part, k)


def test_an_image_step_is_bit_identical_off_and_on(tmp_path, monkeypatch):
    _patch(monkeypatch)
    shards = tmp_path / "images"
    for i in range(2):
        testing.make_image_shard(str(shards / f"s{i}.tar"), 4, 48, seed=i)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump({
        "task": "image_stage1", "tower": "openai_clip",
        "data_config": {"train_batch_size": 2, "num_workers": 1, "img_size": 32,
                        "img_dir": str(shards), "seed": 0},
        "clip_config": {"clip_image_size": 32, "clip_dim": 24, "t5_dim": 32},
        "output_dir": str(tmp_path / "out"), "max_train_steps": 10, "learning_rate": 1e-3,
        "mixed_precision": "bf16", "report_to": "none", "checkpointing_steps": 0}))
    cfg = load_config(str(path))
    out = []
    for on in (False, True):
        trainer = trainer_m.Trainer(cfg, device="cpu")
        batch = _first_batch(trainer)
        trainer._seed(0)
        if on:
            tracing.enable()
        trainer.state, m = trainer.step_fn(trainer.state, batch, trainer.generator)
        tracing.disable()
        out.append((trainer, m))
        trainer.loader.close()
    names = {s.name for s in tracing.drain().spans}
    assert {tracing.STEP, tracing.FROZEN_TOWER, tracing.DIT_FORWARD, tracing.LOSS} <= names
    (a, ma), (b, mb) = out
    assert torch.equal(ma["loss"], mb["loss"])
    for k, p in a.state.trainable.items():
        assert torch.equal(p.detach(), b.state.trainable[k].detach()), k


# ---------------------------------------------------------------------------
# on: nesting, steps, threads, the buffer, the counters
# ---------------------------------------------------------------------------

def test_spans_nest_on_their_thread():
    tracing.enable()
    with tracing.span(tracing.STEP, step=7) as step:
        with tracing.span(tracing.DIT_FORWARD) as fwd:
            with tracing.span(tracing.DIT_DOUBLE, index=1):
                pass
        with tracing.span(tracing.LOSS):
            pass
    spans = {s.name: s for s in tracing.drain().spans}
    assert spans[tracing.STEP].parent is None
    assert spans[tracing.DIT_FORWARD].parent == step.id
    assert spans[tracing.DIT_DOUBLE].parent == fwd.id
    assert spans[tracing.DIT_DOUBLE].attrs == {"index": 1}
    assert spans[tracing.LOSS].parent == step.id
    for s in spans.values():
        assert s.start_ns <= s.end_ns and s.tid == threading.get_native_id()
        assert s.step == 7
    outer = spans[tracing.STEP]
    assert all(outer.start_ns <= s.start_ns and s.end_ns <= outer.end_ns
               for s in spans.values())


def test_an_accumulated_steps_spans_share_its_step(video_step):
    _, _, drained, _ = video_step[1]
    steps = [s for s in drained.spans if s.name == tracing.STEP]
    assert len(steps) == 1 and steps[0].attrs == {"step": 0}
    inside = [s for s in drained.spans if s.name != tracing.STEP]
    assert inside and all(s.step == 0 for s in inside)
    assert all(s.step == 0 for s in drained.samples)


def test_a_step_span_sets_the_next_step_when_it_ends():
    tracing.enable()
    with tracing.span(tracing.STEP, step=4):
        pass
    with tracing.span(tracing.INPUT_WAIT):
        pass
    tracing.count(tracing.INPUT_QUEUE_DEPTH, 1)
    d = tracing.drain()
    assert [s.step for s in d.spans] == [4, 5]
    assert d.samples[-1].step == 5


def test_the_prefetch_thread_records_under_its_native_id():
    batches = [{"x": np.full((2, 3), i, np.float32)} for i in range(3)]
    tracing.enable()
    pf = DevicePrefetcher(iter(batches), "cpu", depth=2)
    try:
        got = [next(pf) for _ in range(3)]
    finally:
        pf.close()
    assert [int(b["x"][0, 0]) for b in got] == [0, 1, 2]
    d = tracing.drain()
    worker = pf.thread.native_id
    h2d = [s for s in d.spans if s.name == tracing.INPUT_H2D]
    waits = [s for s in d.spans if s.name == tracing.INPUT_WAIT]
    assert len(h2d) == 3 and {s.tid for s in h2d} == {worker}
    assert len(waits) == 3 and {s.tid for s in waits} == {threading.get_native_id()}
    depth = [s for s in d.samples if s.name == tracing.INPUT_QUEUE_DEPTH]
    assert len(depth) == 3 and all(0 <= s.value <= 2 for s in depth)


def test_the_buffer_keeps_the_newest_records_and_counts_the_dropped():
    tracing.enable(capacity=5)
    for i in range(8):
        with tracing.span(tracing.DIT_SINGLE, index=i):
            pass
    d = tracing.drain()
    assert [s.attrs["index"] for s in d.spans] == [3, 4, 5, 6, 7]
    assert d.dropped == 3
    assert tracing.drain().spans == [] and tracing.drain().dropped == 0


def test_counters_record_value_time_thread_and_step():
    tracing.enable()
    t0 = time.time_ns()
    tracing.count(tracing.INPUT_QUEUE_DEPTH, 2)
    (s,) = tracing.drain().samples
    assert s.name == tracing.INPUT_QUEUE_DEPTH and s.value == 2.0
    assert t0 <= s.t_ns <= time.time_ns() and s.tid == threading.get_native_id()


def test_a_step_records_its_kernel_launches(monkeypatch):
    from genhancer_tpu_torch.core.kernels import flash_attention as F
    monkeypatch.setitem(F.LAUNCHES, "flash_attention", 10)
    tracing.enable()
    with tracing.span(tracing.STEP, step=0):
        F.LAUNCHES["flash_attention"] += 3
    d = tracing.drain()
    got = {s.name: s.value for s in d.samples}
    assert set(got) == {tracing.LAUNCHES_PREFIX + k for k in tracing.launch_counts()}
    assert got[tracing.LAUNCHES_PREFIX + "flash_attention"] == 3
    assert sum(got.values()) == 3 and all(s.step == 0 for s in d.samples)


def test_launch_counts_live_in_tracing():
    from genhancer_tpu_torch.parallel import testing as ptesting
    assert ptesting.launch_counts is tracing.launch_counts
    assert "flash_attention" in tracing.launch_counts()


def test_each_times_every_item_and_closes_its_source():
    closed = []

    def source():
        try:
            for i in range(4):
                yield i
        finally:
            closed.append(True)

    tracing.enable()
    it = tracing.each(tracing.INPUT_DECODE, source())
    assert [next(it), next(it)] == [0, 1]
    it.close()
    assert closed == [True]
    assert [s.name for s in tracing.drain().spans] == [tracing.INPUT_DECODE] * 2
    assert list(tracing.each(tracing.INPUT_DECODE, range(3))) == [0, 1, 2]


# ---------------------------------------------------------------------------
# the clock
# ---------------------------------------------------------------------------

CLOCK_US = 500.0


def test_spans_sit_on_the_profilers_clock(video_step, tmp_path):
    """Each drained span, shifted by the trace's base time, holds its own
    ``record_function`` event and the aten ops that event holds, within
    0.5 ms."""
    trainer, _, _, batch = video_step[1]
    trainer._seed(1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tracing.enable()
        trainer.state, _ = trainer.step_fn(trainer.state, batch, trainer.generator)
        tracing.disable()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace.get("baseTimeNanoseconds", 0))
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    spans = [s for s in tracing.drain().spans if s.start_ns < s.end_ns]
    annotations = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            annotations.setdefault((e["name"], e["tid"]), []).append(e)
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    checked = set()
    for s in spans:
        a, b = (s.start_ns - base) / 1e3, (s.end_ns - base) / 1e3
        own = [e for e in annotations.get((s.name, s.tid), ())
               if abs(e["ts"] - a) < CLOCK_US and abs(e["ts"] + e["dur"] - b) < CLOCK_US]
        assert len(own) == 1, (s.name, a, b)
        e = own[0]
        inner = [o for o in ops if o["tid"] == s.tid and e["ts"] <= o["ts"]
                 and o["ts"] + o["dur"] <= e["ts"] + e["dur"]]
        for o in inner:
            assert a - CLOCK_US <= o["ts"] and o["ts"] + o["dur"] <= b + CLOCK_US, s.name
        checked.add(s.name)
    assert {tracing.STEP, tracing.FROZEN_VAE, tracing.FROZEN_TOWER, tracing.DIT_FORWARD,
            tracing.DIT_ATTENTION, tracing.BACKWARD, tracing.OPTIM_APPLY} <= checked


# ---------------------------------------------------------------------------
# a tiny video stage-1 step, accumulation 2
# ---------------------------------------------------------------------------

BLOCKS = DIT.depth + DIT.depth_single_blocks
EXPECTED = {
    tracing.STEP: 1,
    tracing.FROZEN_VAE: ACCUM,
    tracing.FROZEN_TOWER: ACCUM,
    tracing.DIT_FORWARD: ACCUM,
    tracing.DIT_DOUBLE: ACCUM * DIT.depth,
    tracing.DIT_SINGLE: ACCUM * DIT.depth_single_blocks,
    tracing.DIT_ATTENTION: ACCUM * BLOCKS,
    tracing.DIT_ATTENTION_BWD_BEGIN: ACCUM * BLOCKS,
    tracing.DIT_ATTENTION_BWD_END: ACCUM * BLOCKS,
    tracing.LOSS: ACCUM,
    tracing.BACKWARD: ACCUM,
    tracing.OPTIM_APPLY: 1,
    tracing.OPTIM_REDUCE: 0,
    tracing.OPTIM_GATHER: 0,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_a_video_step_emits_each_span_as_often_as_its_layer_runs(video_step, name):
    _, _, drained, _ = video_step[1]
    assert sum(s.name == name for s in drained.spans) == EXPECTED[name]


def test_the_attention_backward_marks_lie_in_the_backward(video_step):
    _, _, drained, _ = video_step[1]
    bwd = [s for s in drained.spans if s.name == tracing.BACKWARD]
    for s in drained.spans:
        if s.name in (tracing.DIT_ATTENTION_BWD_BEGIN, tracing.DIT_ATTENTION_BWD_END):
            assert s.start_ns == s.end_ns
            assert any(b.start_ns <= s.start_ns <= b.end_ns for b in bwd), s.name


# ---------------------------------------------------------------------------
# the trainer: --profile and step_time
# ---------------------------------------------------------------------------

def test_profile_writes_the_program_spans_and_the_counter_tracks(tmp_path, monkeypatch):
    _patch(monkeypatch)
    cfg = _video_cfg(tmp_path, max_train_steps=5)
    trainer = trainer_m.Trainer(cfg, profile=True, device="cpu")
    trainer.train()
    assert not tracing.enabled()
    trace = json.loads((tmp_path / "out" / "profile.json").read_text())
    events = trace["traceEvents"]
    ann = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            ann.setdefault(e["name"], []).append(e)
    assert len(ann[tracing.STEP]) == 3                      # steps 2-4
    for name in (tracing.FROZEN_TOWER, tracing.DIT_FORWARD, tracing.BACKWARD,
                 tracing.OPTIM_APPLY, tracing.INPUT_WAIT, tracing.LOSS):
        assert name in ann, name
    main = ann[tracing.STEP][0]["tid"]
    assert {e["tid"] for e in ann[tracing.INPUT_H2D]} - {main}
    counters = {}
    for e in events:
        if e.get("ph") == "C":
            counters.setdefault(e["name"], []).append(e)
    assert tracing.INPUT_QUEUE_DEPTH in counters
    assert len(counters[tracing.LAUNCHES_PREFIX + "flash_attention"]) == 3
    t0 = min(e["ts"] for e in ann[tracing.STEP])
    t1 = max(e["ts"] + e["dur"] for e in ann[tracing.STEP])
    for e in counters[tracing.LAUNCHES_PREFIX + "flash_attention"]:
        assert t0 <= e["ts"] <= t1 + CLOCK_US


class _Deferred:
    """A loss whose read waits for the work queued since the last read, as a
    device's does: ``WORK_S`` a step."""

    pending = 0

    def __float__(self):
        time.sleep(_Deferred.pending * WORK_S)
        _Deferred.pending = 0
        return 1.0


WORK_S = 0.03


@pytest.mark.parametrize("log_interval,profile", [(1, False), (3, False), (3, True)])
def test_step_time_is_the_mean_step_time(tmp_path, monkeypatch, log_interval, profile):
    """Each interval's data waits, and under ``--profile`` the profiler's
    start (step 2) and export (step 4, inside the second interval at
    ``log_interval`` 3), stay out of ``step_time``."""
    _patch(monkeypatch)
    cfg = _video_cfg(tmp_path, max_train_steps=6, log_interval=log_interval)
    trainer = trainer_m.Trainer(cfg, profile=profile, device="cpu")
    _Deferred.pending = 0
    add_to_trace = tracing.add_to_trace

    def slow_export(path, drained):       # an export that outlasts the interval's steps
        time.sleep(10 * WORK_S)
        add_to_trace(path, drained)

    monkeypatch.setattr(tracing, "add_to_trace", slow_export)

    def step_fn(state, batch, generator):
        _Deferred.pending += 1
        return state, {"loss": _Deferred(), "grad_norm": torch.tensor(0.0)}

    trainer.step_fn = step_fn
    trainer.train()
    times = [h["step_time"] for h in trainer.history]
    assert len(times) == 6 // log_interval
    for t in times:
        assert WORK_S * 0.95 <= t <= WORK_S * 1.6, times
