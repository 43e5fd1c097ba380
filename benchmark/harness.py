"""One run of one cell: set-up, the measured window, the traced stretch, the
check against the reference.

Set-up builds the port's ``Trainer`` from the cell's configuration file,
overwrites its weights with the seed's (``weights``), takes its prefetched
batches (``Trainer._batches``: the loader, its decode threads and the
device thread of ``data/prefetch.py``) and runs the checked steps through
``trainer.step_fn`` with the benchmark's own random draws.  Those steps warm
up every shape the cell uses; the window then continues the same state
with the trainer's own draws (``_seed`` per step, as ``_train_loop`` seeds
them), syncing on the loss every ``log_interval`` steps as the trainer does,
and ends on a synchronize.  No checkpoint is written and no tracker runs.

After the window the program's state is freed and the reference follows the
checked steps from the same weights and draws and from the recorded batches'
inputs, decoded again from the raw shards where it can tell which frames a
row holds (``reference_inputs``; ``compare``).
"""

from __future__ import annotations

import collections
import contextlib
import gc
import importlib
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from . import compare, flops, spans, weights
from .reference import crops
from .reference import model as ref_model
from .reference import step as ref_step
from .traffic import generate

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "genhancer_tpu")


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` of JAX or the JAX package, each
    compared whole (``genhancer_tpu_torch`` is not ``genhancer_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# the cell's files
# ---------------------------------------------------------------------------

@dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    workload: dict
    run_seconds: int
    manifest: dict = field(repr=False, default_factory=dict)

    @property
    def model(self) -> dict:
        return self.config["model"]


def load_manifest() -> dict:
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


def load_cell(name: str) -> Cell:
    """The workload ``name`` of ``BENCHMARK.json`` with its configuration
    and workload files, found by name."""
    manifest = load_manifest()
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(entries)}")
    entry = entries[name]
    conf = {c["name"]: c for c in manifest["configs"]}[entry["config"]]
    with open(REPO / conf["file"]) as f:
        config = json.load(f)
    with open(HERE / "workloads" / f"{name}.json") as f:
        workload = json.load(f)
    return Cell(name, entry, config, workload, int(manifest["run_seconds"]), manifest)


def per_layer_readers(cell: Cell) -> Dict[str, object]:
    """``{metric: module}`` of the cell's per-layer metrics
    (``metrics/<name>.py``, each with ``read(ctx)``)."""
    out = {}
    for m in cell.manifest["per_layer"]:
        if cell.name in m.get("workloads", [cell.name]):
            out[m["name"]] = importlib.import_module(f"benchmark.metrics.{m['name']}")
    return out


def train_config(cell: Cell, data_dir: str, out_dir: str, seed: int):
    """The ``Trainer``'s config: the configuration file's copy of the
    shipped YAML, its overrides, the cell's data, the run's seed."""
    from genhancer_tpu_torch.train.config import Config
    cfg = Config._wrap(json.loads(json.dumps(cell.config["train_config"])))
    cfg = cfg.merged_with(cell.config.get("overrides", {}))
    data_key = "video_dir" if cell.workload["data"]["kind"] == "videos" else "img_dir"
    cfg = cfg.merged_with({"output_dir": out_dir, "seed": seed,
                           "data_config": {data_key: data_dir, "seed": seed}})
    if cell.workload.get("precomputed"):
        cfg = cfg.merged_with({"data_config": {"precomputed": True}})
    return cfg


def check_spec(spec, model: dict) -> None:
    """The program's task spec against the configuration file's sizes."""
    import dataclasses
    got = {"dit": dataclasses.asdict(spec.dit_cfg), "vae": dataclasses.asdict(spec.vae_cfg)}
    vis = spec.tower_cfg.vision
    got["tower"] = {**dataclasses.asdict(vis), "projection_dim": spec.tower_cfg.projection_dim}
    for part in ("dit", "vae", "tower"):
        for k, v in model[part].items():
            have = got[part].get(k)
            if (list(have) if isinstance(have, tuple) else have) != v:
                raise RuntimeError(f"the program runs {part}.{k} = {have}, "
                                   f"the configuration file gives {v}")
    if spec.img_size != model["img_size"] or spec.guidance != model["guidance"]:
        raise RuntimeError("the program's image size or guidance differs from the file's")


# ---------------------------------------------------------------------------
# the feed
# ---------------------------------------------------------------------------

class Recorder:
    """The trainer's loader, passed through: keeps host copies of the first
    ``keep`` batches' arrays (and captions) for the reference, and the
    training rows of every batch (its ``valid`` rows, else all)."""

    def __init__(self, loader, keep: int):
        self.loader, self.keep = loader, keep
        self.kept: List[dict] = []
        self.rows: collections.deque = collections.deque()

    def __iter__(self):
        for b in self.loader:
            arrays = {k: v for k, v in b.items() if isinstance(v, np.ndarray)}
            if len(self.kept) < self.keep:
                self.kept.append({**{k: v.copy() for k, v in arrays.items()},
                                  "text": list(b.get("text", []))})
            valid = arrays.get("valid")
            self.rows.append(int(valid.sum()) if valid is not None
                             else len(next(iter(arrays.values()))))
            yield b

    def close(self) -> None:
        self.loader.close()


def make_draws(model: dict, seed: int, step: int, micro: int, rows: int, device) -> dict:
    """The random draws of one micro-batch: ``t`` (logit-normal, taken to a
    value of the compute dtype), ``x0`` [B, L, C] and ``vae_noise`` [B, h, w,
    z], from a generator on the device seeded by (seed, step, micro)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + step * 101 + micro + 7) % (1 << 63))
    lat = ref_model.latent_size(model)
    z = model["vae"]["z_channels"]
    cd = ref_step.DTYPES[model["compute_dtype"]]
    n = torch.randn(rows, generator=g, device=device) * model.get("logit_normal_scale", 1.0)
    t = torch.sigmoid(n).to(cd).to(torch.float32)
    x0 = torch.randn(rows, (lat // 2) ** 2, 4 * z, generator=g, device=device)
    noise = torch.randn(rows, lat, lat, z, generator=g, device=device)
    return {"t": t, "x0": x0, "vae_noise": noise}


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def reference_inputs(cell: Cell, kept: List[dict], data_dir: str, seed: int):
    """The reference's inputs of the recorded micro-batches, and the number
    of their training rows that are not the reference's own decode of the
    raw shards (None where that is not checked).

    Where the program trained from a features cache, the inputs are the
    training crops that cache was built from, worked out again from the raw
    shards by the captions (each sample's key) the batch carried.  A
    sliding-window row is found, by its pixels, as consecutive frames of one
    video and replaced by the reference's decode of them.  An inline image
    row is the loader's: its crop was drawn in decode-thread order, which
    nothing replays."""
    wl = cell.workload
    size = cell.model["img_size"]
    if wl.get("precomputed") == "features":
        jpegs = crops.read_jpegs(data_dir)
        return [{"image": torch.from_numpy(crops.training_crops(jpegs, b["text"], seed, size))}
                for b in kept], None
    batches = [{k: v for k, v in b.items() if k != "text"} for b in kept]
    off = None
    if wl["data"]["kind"] == "videos":
        max_frames = cell.config["train_config"]["data_config"].get("max_frames_per_video", 200)
        frames = crops.VideoFrames(data_dir, size, max_frames)
        off = 0
        for i, b in enumerate(batches):
            batches[i], n = crops.window_rows(b, frames)
            off += n
    return [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches], off


@contextlib.contextmanager
def seeded_weights(model: dict, seed: int):
    """While the ``Trainer`` is built, its modules take the seed's weights
    (``weights.fill_program``) as soon as the task has drawn its own and
    before its int8 surgery (``tasks.image.quantize_modules``, bound by name
    in both tasks), so that a control that quantizes the frozen tower and
    VAE quantizes these weights."""
    from genhancer_tpu_torch.tasks import image, video
    orig = image.quantize_modules

    def fill_then_quantize(spec, modules):
        weights.fill_program(modules, model, seed)
        return orig(spec, modules)

    image.quantize_modules = video.quantize_modules = fill_then_quantize
    try:
        yield
    finally:
        image.quantize_modules = video.quantize_modules = orig


def _program_norms(state, names, b1: float) -> Dict[str, float]:
    mu = state.opt_state["mu"]
    return {k: float(torch.linalg.vector_norm(mu[k].float())) / (1 - b1) for k in names}


def _sampled(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return t.detach().reshape(-1)[idx.to(t.device)].float().cpu()


def build_features_cache(cell: Cell, cfg, src: str, out: str, seed: int, device) -> str:
    """The stage-1 features cache of ``src`` (``data/precompute.py``: the
    VAE's moments and the tower's class token of one training crop per
    image) from the seed's frozen weights; returns its directory."""
    from genhancer_tpu_torch.cli.precompute import build_frozen_modules
    from genhancer_tpu_torch.data import precompute as pre
    spec, modules = build_frozen_modules(cfg, device)
    weights.fill_program(modules, cell.model, seed, prefixes=("vae.", "clip.model."))
    fn = pre.make_frozen_fn(spec.tower_kind, modules["clip"]["model"], spec.tower_cfg,
                            modules["vae"], spec.vae_cfg, vae_dtype=spec.vae_dtype,
                            compute_dtype=spec.compute_dtype, with_patches=False)
    pre.precompute_image_dir(src, out, fn, spec.img_size, batch=cell.workload.get(
        "cache_batch", 32), augment="train", variants=1, seed=seed, mode="features")
    del modules, fn
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_start: Optional[float] = None, control: Optional[dict] = None,
        log=print, detail: bool = False) -> dict:
    """One run; returns the result line's object (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``breakdown``, ``checks``).

    ``control`` merges into the trainer's config: a path of the program in
    a lower precision, for the runs that set the upper readings."""
    from genhancer_tpu_torch.train.trainer import Trainer
    t_start = time.perf_counter() if t_start is None else t_start
    seed = int(seed)
    model, wl = cell.model, cell.workload
    cuda = torch.device(device).type == "cuda"
    work = tempfile.mkdtemp(prefix=f"bench-{cell.name}-")
    span = spans.Spans() if trace else None
    try:
        phases = {"start": time.perf_counter() - t_start}
        data_dir = os.path.join(work, "data")
        generate.write(wl["data"], seed, data_dir)
        phases["data"] = time.perf_counter() - t_start
        cfg = train_config(cell, data_dir, os.path.join(work, "out"), seed)
        if control:
            cfg = cfg.merged_with(control)
        if wl.get("precomputed") == "features":
            cache = build_features_cache(cell, cfg, data_dir, os.path.join(work, "cache"),
                                         seed, device)
            cfg = cfg.merged_with({"data_config": {"img_dir": cache}})
        if span is not None:
            span.install_program()
        with seeded_weights(model, seed):
            trainer = Trainer(cfg, device=device)
        phases["trainer"] = time.perf_counter() - t_start
        check_spec(trainer.spec, model)
        if span is not None:
            span.install_optimizer(trainer.optimizer)
        accum, checked = trainer.accum, int(wl["checked_steps"])
        rec = Recorder(trainer.loader, keep=checked * accum)
        trainer.loader = rec
        batches = trainer._batches()
        names = list(trainer.state.trainable)
        start = {k: p.detach().clone() for k, p in trainer.state.trainable.items()}
        samples = compare.sample_indices({k: p.numel() for k, p in start.items()}, seed)
        b1 = float(cfg.get("adam_beta1", 0.9))
        prog = {"loss": []}
        draws_kept = []
        for s in range(checked):
            batch = next(batches)
            batch.pop("__extras__", None)
            rows = next(iter(batch.values())).shape[1 if accum > 1 else 0]
            dr = [make_draws(model, seed, s, i, rows, trainer.device) for i in range(accum)]
            draws_kept.append([{k: v.cpu() for k, v in d.items()} for d in dr])
            trainer.state, m = trainer.step_fn(trainer.state, batch, trainer.generator,
                                               draws=dr if accum > 1 else dr[0])
            prog["loss"].append(float(m["loss"]))
            if s == 0:
                prog["grad_norm"] = _program_norms(trainer.state, names, b1)
                mu = trainer.state.opt_state["mu"]
                prog["grad_sample"] = {k: _sampled(mu[k], i) / (1 - b1)
                                       for k, i in samples.items()}
            for _ in range(accum):
                rec.rows.popleft()
        prog["update_norm"] = {k: float(torch.linalg.vector_norm(
            p.detach().float() - start[k].float())) for k, p in trainer.state.trainable.items()}
        del start
        step = trainer.state.step

        def one_step(stats):
            nonlocal step
            t0 = time.perf_counter()
            batch = next(batches)
            stats["wait_s"] += time.perf_counter() - t0
            batch.pop("__extras__", None)
            trainer._seed(step)
            trainer.state, m = trainer.step_fn(trainer.state, batch, trainer.generator)
            step += 1
            stats["steps"] += 1
            stats["rows"] += sum(rec.rows.popleft() for _ in range(accum))
            if step % trainer.log_interval == 0:
                float(m["loss"])
                syncs.append(time.perf_counter())

        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        phases["checked_steps"] = setup_s
        log("set-up (seconds since start): " + ", ".join(f"{k} {v:.2f}" for k, v in phases.items()))
        win = {"steps": 0, "rows": 0, "wait_s": 0.0}
        syncs: List[float] = []
        t0 = time.perf_counter()
        traced = None
        if trace:
            tr = wl["trace"]
            while win["steps"] < tr["after_steps"]:
                one_step(win)
            if cuda:
                torch.cuda.synchronize()
            t_pause = time.perf_counter()
            prof = {"steps": 0, "rows": 0, "wait_s": 0.0}
            shapes_before = len(span.attn_shapes)

            def stretch():
                while prof["steps"] < tr["steps"]:
                    one_step(prof)

            traced = spans.profile(stretch, os.path.join(work, "trace.json"))
            traced["steps"] = prof["steps"]
            traced["attn_shapes"] = span.attn_shapes[shapes_before:]
            prof["steps"] = 0
            traced.update(spans.device_busy(stretch, os.path.join(work, "busy.json")))
            traced["busy_steps"] = prof["steps"]
            t0 += time.perf_counter() - t_pause
        while time.perf_counter() - t0 < seconds:
            one_step(win)
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        log("seconds between the window's syncs: " + " ".join(
            f"{b - a:.3f}" for a, b in zip(syncs, syncs[1:])))
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        attempted = win["steps"] + (2 * traced["steps"] if traced else 0)
        batches.close()
        rec.close()
        trainer.ckpt_writer.close()
        opt = {k: float(cfg[k]) for k in ("learning_rate", "adam_beta1", "adam_beta2",
                                         "adam_epsilon", "adam_weight_decay", "max_grad_norm")}
        if cfg.get("lr_scheduler", "constant") != "constant":
            raise RuntimeError("the reference follows a constant learning rate only")
        del trainer, batches
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # the reference, after the window, from the same inputs
        P = weights.reference_params(model, seed, device)
        inputs, rows_off = reference_inputs(cell, rec.kept, data_dir, seed)
        steps_in = [inputs[s * accum:(s + 1) * accum] for s in range(checked)]
        ref = ref_step.follow(P, model, opt, steps_in, draws_kept, int(wl["reference_rows"]),
                              samples)
        del P
        values, where, by_leaf = compare.readings(prog, ref)
        if rows_off is not None:
            values["input_rows_off"] = float(rows_off)
        limits = wl["limits"]
        correct = compare.judge(values, limits)
        log(f"program loss {prog['loss']} reference loss {ref['loss']}")
        log(f"worst: {where}")
        if detail:
            log("grad_diff by leaf: " + json.dumps(by_leaf))

        dev_info = {"platform": "gpu" if cuda else "cpu",
                    "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                    "count": 1, "memory_peak_bytes": int(peak)}
        result = {"correct": bool(correct), "attempted": int(attempted), "failed": 0}
        if trace:
            ctx = {"model": model, "window": win, "window_s": window_s, "trace": traced,
                   "ops_per_row": flops.step_ops_per_row(model)}
            metrics = {}
            for name, reader in per_layer_readers(cell).items():
                v = reader.read(ctx)
                if v is not None:
                    metrics[name] = {"value": v, "unit": reader.UNIT}
            dev_info.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
            result.update(metrics=metrics, device=dev_info, breakdown={
                "device_ops": [[n, s] for n, s in traced["device_ops"]],
                "idle_gaps": [[n, s] for n, s in traced["idle_gaps"]]})
        else:
            result.update(metrics={
                "train_samples_per_s": {"value": win["rows"] / window_s, "unit": "samples/s"},
                "peak_mem_gib": {"value": peak / 2 ** 30, "unit": "GiB"},
                "setup_s": {"value": setup_s, "unit": "s"}}, device=dev_info)
        result["readings"] = values
        result["checks"] = compare.checks(values, limits)
        return result
    finally:
        if span is not None:
            span.close()
        shutil.rmtree(work, ignore_errors=True)
