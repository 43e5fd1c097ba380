"""The training loop: config-driven, data parallel, observable, resumable.

Port of ``genhancer_tpu/train/trainer.py``, one device per process:

  * config -> task -> optimizer -> state -> resume -> loop;
  * gradient accumulation (``train.step_utils``) or a plain step;
  * a depth-2 host thread that pins each batch and copies it to the device
    (``data.prefetch``);
  * the image stage-1 and stage-2 tasks and the video stage-1 and
    stage-2 tasks; the checkpoint layout and the loss follow the task's
    ``ckpt_kind``, a stage-2 run starts from the stage-1 files of
    ``load_dir``/``load_step``, and a stage-2 checkpoint adds the
    LoRA-merged tower as an HF model directory named as the reference
    names it (``hf_export_name``);
  * step/data timers and tracker scalars under the reference names
    (``train_loss``, ``step_time``, ``data_load_time``, and in sliding mode
    ``avg_windows_per_video``/``bs_eff``, averaged over an accumulation
    group); the host syncs on
    the loss only every ``log_interval`` steps, so the steps between run
    back to back on the device.  ``step_time`` is the wall seconds per step
    over the interval between two syncs (the mean step time): from the end
    of the previous sync's step to this sync, less the waits for data (each
    step's ``data_load_time``), the profile's start and export and any
    checkpoint in it, over the steps in it; at ``log_interval`` 1, one
    step's time, its sync included;
  * watchdog warnings for slow data loading and for a ``step_time`` above
    ``STEP_TIMEOUT``;
  * ``profile``: steps 2-4 under ``torch.profiler`` with the port's spans
    on (``tracing``), written to ``<output_dir>/profile.json`` with the
    counters (``input.queue_depth``, each step's ``launches.<kernel>``)
    as counter tracks;
  * a SIGTERM flag that stops the loop at a step boundary, followed by a
    checkpoint;
  * the reference checkpoint cadence, ``checkpoints_total_limit`` and
    resume from the latest checkpoint;
  * checkpoints written by a background thread (``async_checkpointing``,
    on by default as in JAX, ``train.async_ckpt``): the step loop stalls for
    the device-to-host snapshot only (logged), the ``.bin`` files, the HF
    export and the pruning run in the writer, and ``train()`` drains it
    before it returns;
  * QLoRA's and the static DiT's int8 factors re-derived from the masters
    after the stage-1 load and after a resume
    (``core.quant.refresh_static_quant_flat``);
  * data parallelism (``parallel.mesh``): launched as N processes
    (``python -m torch.distributed.run --nproc_per_node N -m
    genhancer_tpu_torch.cli.train ...``, or JAX's manual
    ``GENHANCER_COORDINATOR``/``GENHANCER_NUM_PROCS``/``GENHANCER_PROC_ID``),
    each rank trains on ``cuda:LOCAL_RANK`` with ``train_batch_size`` rows
    of its own shards, so the global batch is ``train_batch_size x N``;
    the loss is the masked mean over the global batch, the gradients are
    summed over the ranks once per optimizer step, and with
    ``shard_optimizer_state`` the moments are sharded by rows (ZeRO-1).
    Rank 0 writes the checkpoints, the export and the tracker; the sharded
    moments are gathered collectively first.  A SIGTERM stops every rank at
    the same step boundary: rank 0's flag, broadcast at the ``log_interval``
    cadence (``_preempt_stop``).  Out of device memory, one process stops
    for a relaunch; a rank of several re-raises, so that the launcher tears
    the group down;
  * tensor parallelism and FSDP (``model_parallel: N``, ``fsdp: true`` with
    ``fsdp_min_size``, or both): the ranks form JAX's (data, model) mesh
    (``parallel.mesh.make_mesh``, the model axis innermost), the loaders
    and the draws split over the data axis, and once the modules are built
    and the stage-1 files loaded, the state is placed as
    ``genhancer_tpu/train/trainer.py:203-240`` places it
    (``train.state.place_state``: the DiT's Megatron layout on the model
    axis, FSDP's blocks of trainable and frozen leaves on the data axis);
    a resume loads each rank's blocks, and a checkpoint gathers every
    block to the reference layout before rank 0 writes.

  * sequence and pipeline parallelism (``sequence_parallel: N``, with
    ``model_parallel`` too; ``pipeline_parallel: N`` with
    ``pipeline_microbatches``): the mesh gains JAX's seq or pipe axis
    (``parallel.mesh.make_mesh``) and the task runs the DiT's attention
    as ring attention over the rank's tokens (``parallel.ring``) or the
    DiT as a GPipe pipeline over the rank's stage (``parallel.pp``); the
    parameters stay whole on every rank, rank 0 writes them, and the loss
    in the history is the global batch's (``train.state.apply_gradients``).

  * ``checkpoint_backend``: ``torch`` (the default: the reference layout,
    gathered, rank 0 writes) or ``orbax`` (``train.orbax_ckpt``: DCP files
    in ``orbax-{step}/``, every rank writes its own blocks, no gather; a
    resume restores them after the placement, onto the live layout; rank 0
    prunes them; a stage-2 run still writes its HF export through the
    torch writer), as ``genhancer_tpu/train/trainer.py:189-193, 242-251,
    336-348`` selects them.

Random draws come from one ``torch.Generator`` on the device, seeded from
``seed + 777`` and the step (as JAX folds the step into its key), so a
resumed run draws what an uninterrupted one would; every rank seeds it
alike, draws the global batch's values and keeps its rows.  Float32 matmuls
and convolutions run in full float32 (TF32 off).
"""

from __future__ import annotations

import logging
import os
import signal
import time
from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..data.prefetch import DevicePrefetcher
from ..parallel import mesh
from ..serve.engine import resolve_device
from ..tasks import factory
from ..tasks import image as image_task
from ..tasks import video as video_task
from . import checkpoint as ckpt
from . import optim
from ..core.quant import refresh_static_quant_flat, static_quant_flat
from . import lora
from . import orbax_ckpt
from .async_ckpt import AsyncCheckpointer
from .state import with_quant_cache
from .step_utils import make_accum_train_step, merge_extras, stack_microbatches

log = logging.getLogger("genhancer_tpu_torch.trainer")

# the stage-2 tasks also checkpoint at these steps (train_SigLIP_stage2_all.py:305)
STAGE2_EARLY_SAVES = {50, 100, 200, 300, 500, 1000, 2000, 3000}
DATA_LOAD_TIMEOUT = 60.0
STEP_TIMEOUT = 300.0
ARRAY_KEYS = {"image", "cond", "target", "valid", "moments", "cls", "cond_patches",
              "cond_vecs"}
EXTRA_SCALARS = ("avg_windows_per_video", "bs_eff")


class SummaryWriterProxy:
    """Scalar tracker: tensorboardX or wandb (reference ``report_to``
    options), or a no-op if unavailable/disabled.  wandb runs offline unless
    WANDB_MODE overrides it; a missing tracker degrades to a warning."""

    def __init__(self, logdir: Optional[str], enabled: bool = True,
                 backend: str = "tensorboard", project: Optional[str] = None,
                 run_config: Optional[dict] = None):
        self.writer = None
        self.wandb = None
        if not (enabled and logdir):
            return
        if backend == "wandb":
            try:
                import wandb
                os.makedirs(logdir, exist_ok=True)
                wandb.init(project=project or "genhancer", dir=logdir, config=run_config,
                           mode=os.environ.get("WANDB_MODE", "offline"))
                self.wandb = wandb
            except Exception as e:  # no tracker: train on, without scalars
                log.warning("wandb tracker unavailable: %s", e)
        elif backend == "tensorboard":
            try:
                from tensorboardX import SummaryWriter
                os.makedirs(logdir, exist_ok=True)
                self.writer = SummaryWriter(logdir)
            except Exception as e:  # no tracker: train on, without scalars
                log.warning("tensorboard disabled: %s", e)

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self.writer is not None:
            self.writer.add_scalar(tag, value, step)
        if self.wandb is not None:
            self.wandb.log({tag: value}, step=step)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
        if self.wandb is not None:
            self.wandb.finish()


def hf_export_name(cfg, step: int) -> str:
    """The stage-2 export directory's name (``trainer.py:91-102``):
    siglip-so400m-patch14-{size}-{step}, clip-vit-large-patch14[-336]-{step}
    or metaclip-{l14,h14}-fullcc2.5b-{step}."""
    tower = cfg.get("tower", "openai_clip")
    size = int(cfg.get_path("clip_config.clip_image_size", 224))
    if tower == "siglip":
        return f"siglip-so400m-patch14-{size}-{step}"
    if tower == "metaclip":
        t = cfg.get_path("clip_config.clip_type", "large")
        return f"metaclip-{'l14' if t == 'large' else 'h14'}-fullcc2.5b-{step}"
    return (f"clip-vit-large-patch14-{step}" if size == 224
            else f"clip-vit-large-patch14-336-{step}")


class Trainer:
    def __init__(self, cfg, profile: bool = False, device="cuda"):
        self.cfg = cfg
        self.profile = profile
        self.ckpt_backend = str(cfg.get("checkpoint_backend", "torch"))
        if self.ckpt_backend not in ("torch", "orbax"):
            raise ValueError(f"checkpoint_backend must be torch|orbax, got {self.ckpt_backend!r}")
        self.device = mesh.rank_device(resolve_device(device))
        mesh.maybe_initialize_distributed(self.device)
        self.is_main = mesh.rank() == 0
        self.tp = int(cfg.get("model_parallel", 1) or 1)
        self.fsdp = bool(cfg.get("fsdp", False))
        # the mesh, before the loaders split over the data axis
        self.mesh = mesh.make_mesh(self.tp, int(cfg.get("sequence_parallel", 1) or 1),
                                   int(cfg.get("pipeline_parallel", 1) or 1))
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.output_dir = cfg.get("output_dir", "output")
        os.makedirs(self.output_dir, exist_ok=True)
        self.ckpt_writer = AsyncCheckpointer(
            enabled=bool(cfg.get("async_checkpointing", True)))

        (self.spec, self.loader, make_step, create_state,
         self.ckpt_kind) = factory.build_task(cfg)

        self.accum = int(cfg.get("gradient_accumulation_steps", 1))
        max_steps = cfg.get("max_train_steps")
        if not max_steps:
            per_epoch = optim.effective_steps_per_epoch(
                int(cfg.get_path("data_config.train_batch_size", 16)), self.accum)
            max_steps = int(int(cfg.get("num_train_epochs", 1)) * per_epoch)
        self.max_steps = int(max_steps)
        emit_quant = (cfg.get("dit_quant", "none") in ("int8", "int8_dw", "int8_full")
                      and cfg.get("fused_optimizer") == "pallas")
        self.optimizer = optim.make_optimizer(cfg, total_steps=self.max_steps,
                                              emit_quant=emit_quant)

        self.seed = int(cfg.get("seed", 0))
        init_gen = torch.Generator(device=self.device)
        init_gen.manual_seed(self.seed)
        self.state = create_state(init_gen, self.spec, self.optimizer, device=self.device)

        if cfg.get("load_dir") and cfg.get("load_step") is not None:
            with torch.no_grad():
                ckpt.load_stage1_components(self.state.modules, cfg["load_dir"],
                                            int(cfg["load_step"]), self.ckpt_kind)
            log.info("loaded stage-1 components from %s step %s",
                     cfg["load_dir"], cfg["load_step"])
        if self.tp > 1 or self.fsdp:
            from ..parallel import tp as tp_m
            from ..parallel.fsdp import MIN_SHARD_SIZE
            from .state import place_state
            tp_m.validate_tp(self.spec.dit_cfg, self.tp)
            place_state(self.state, self.optimizer, self.tp, self.fsdp,
                        int(cfg.get("fsdp_min_size", MIN_SHARD_SIZE)),
                        self.spec.dit_cfg.hidden_size)
            log.info("placed %d leaves on the (data %d, model %d) mesh",
                     len(self.state.layout), mesh.data_size(), mesh.model_size())
        if cfg.get("resume_from_checkpoint") == "latest" and self.ckpt_backend == "torch":
            before = self.state.step
            ckpt.resume_latest(self.state, self.output_dir, self.ckpt_kind)
            if self.state.step != before:
                log.info("resumed from step %d", self.state.step)
        if cfg.get("resume_from_checkpoint") == "latest" and self.ckpt_backend == "orbax":
            # after the placement: each rank restores its own blocks
            latest = orbax_ckpt.latest_step(self.output_dir)
            if latest is not None and latest > self.state.step:
                orbax_ckpt.restore_sharded(self.state, self.output_dir, latest)
                log.info("resumed (orbax) from step %d", latest)
        # QLoRA's and the static DiT's int8 factors were derived at init:
        # re-derive them from the (possibly loaded) masters
        refreshed = refresh_static_quant_flat(static_quant_flat(self.state.modules),
                                              self.state.layout)
        if refreshed:
            log.info("re-derived %d static int8 weights from their masters", len(refreshed))
        if self.state.quant is not None:
            # the int8 weight cache is derived state: rebuilt from the
            # (possibly loaded) masters, never read from a checkpoint
            with_quant_cache(self.state)

        if self.accum > 1:
            acc_dt = cfg.get("grad_accum_dtype", "float32")
            task = image_task if self.ckpt_kind == "image" else video_task
            self.step_fn = make_accum_train_step(
                task.make_loss_fn(self.spec, self.mesh), self.optimizer, self.accum,
                accum_dtype=None if acc_dt == "param" else getattr(torch, acc_dt))
        else:
            self.step_fn = make_step(self.spec, self.optimizer, self.mesh)

        self.log_interval = max(1, int(cfg.get("log_interval", 10)))
        report_to = cfg.get("report_to")
        self.writer = SummaryWriterProxy(
            os.path.join(self.output_dir, cfg.get("logging_dir", "logs")),
            enabled=self.is_main and report_to in ("tensorboard", "wandb"),
            backend=report_to or "tensorboard",
            project=cfg.get("tracker_project_name"),
            run_config={k: v for k, v in cfg.items()
                        if isinstance(v, (int, float, str, bool))})
        self.generator = torch.Generator(device=self.device)
        self.history = []           # metrics of every synced step
        self._last_saved = None
        self.saved_steps = []       # the steps checkpointed, in order
        self._preempted = False

    # -- input ------------------------------------------------------------

    def _batches(self) -> DevicePrefetcher:
        """Device-ready batches (the array leaves; accumulation stacking
        applied; the loader's other values under ``__extras__``), one host
        thread ahead."""

        def host_iter():
            pending, pending_extras = [], []
            for b in self.loader:
                arrays = {k: v for k, v in b.items()
                          if k in ARRAY_KEYS and isinstance(v, np.ndarray)}
                extras = {k: v for k, v in b.items() if k not in arrays}
                if self.accum > 1:
                    pending.append(arrays)
                    pending_extras.append(extras)
                    if len(pending) == self.accum:
                        yield {**stack_microbatches(pending),
                               "__extras__": merge_extras(pending_extras)}
                        pending, pending_extras = [], []
                else:
                    yield {**arrays, "__extras__": extras}

        return DevicePrefetcher(host_iter(), self.device, depth=2)

    # -- checkpointing -----------------------------------------------------

    def _should_checkpoint(self, step: int) -> bool:
        """The reference cadence (``trainer.py:324-330``): every
        ``checkpointing_steps``, and a stage-2 task also at each of
        ``STAGE2_EARLY_SAVES``."""
        every = int(self.cfg.get("checkpointing_steps", 0) or 0)
        if every and step % every == 0:
            return True
        return self.spec.stage.startswith("stage2") and step in STAGE2_EARLY_SAVES

    def _checkpoint(self, step: int) -> None:
        """Snapshot the components, the optimizer state and, in stage 2, the
        LoRA-merged tower (merged on the device, so the export's bits do not
        depend on the writer), and hand the writing to ``ckpt_writer``.  The
        int8 weight caches are non-persistent buffers: never snapshotted.
        Every rank gathers the ZeRO-1 moments and the TP and FSDP blocks
        (collectives); rank 0 alone snapshots and writes.  The orbax
        backend instead writes every rank's blocks now (a collective, no
        gather) and rank 0 prunes; a stage-2 run then still hands its HF
        export to the writer."""
        stage2 = self.spec.stage.startswith("stage2")
        orbax = self.ckpt_backend == "orbax"
        self._last_saved = step
        self.saved_steps.append(step)
        if orbax:
            orbax_ckpt.save_sharded(self.state, self.output_dir, step)
            limit = int(self.cfg.get("checkpoints_total_limit") or 0)
            if self.is_main and limit:
                pruned = orbax_ckpt.prune(self.output_dir, limit)
                if pruned:
                    log.info("pruned old orbax checkpoints: %s", pruned)
            log.info("saved orbax checkpoint at step %d", step)
            if not stage2:
                return
        optimizer = None if orbax else ckpt.optimizer_state_dict(self.state)
        components = None if orbax else ckpt.stage1_state_dicts(self.state, self.ckpt_kind)
        tower = self.state.modules["clip"]["model"] if stage2 else None
        tower_sd = None
        if stage2 and any(k.startswith("clip.model.") for k in self.state.layout):
            from ..parallel.layout import full_state_dict
            tower_sd = full_state_dict(tower, self.state.layout, "clip.model.")
        if not self.is_main:
            return
        tree = {"components": components, "optimizer": optimizer}
        if stage2:
            tree["tower"] = lora.merged_state_dict(tower, tower_sd)
        out_dir, kind, cfg = self.output_dir, self.ckpt_kind, self.cfg
        base_config = self.spec.tower_cfg.to_hf() if stage2 else None

        def write(snap):
            if not orbax:
                ckpt.write_stage1(snap["components"], snap["optimizer"], out_dir, step, kind)
            if stage2:
                ckpt.write_hf_tower(snap["tower"],
                                    os.path.join(out_dir, hf_export_name(cfg, step)),
                                    base_config=base_config,
                                    base_model_dir=cfg.get_path("clip_config.model_dir"))
            limit = int(cfg.get("checkpoints_total_limit") or 0)
            if limit and not orbax:
                pruned = ckpt.prune_checkpoints(out_dir, limit)
                if pruned:
                    log.info("pruned old checkpoints: %s", pruned)
            log.info("saved checkpoint at step %d", step)

        self.ckpt_writer.save(tree, write)
        log.info("checkpoint at step %d: the step loop stalled %.3f s for the snapshot",
                 step, self.ckpt_writer.stalls[-1])

    # -- loop --------------------------------------------------------------

    def train(self) -> dict:
        """Run to ``max_train_steps``; returns the last synced metrics."""
        self._preempted = False

        def _on_term(signum, frame):
            self._preempted = True
            log.warning("SIGTERM — will checkpoint at the next step boundary")

        try:
            prev_term = signal.signal(signal.SIGTERM, _on_term)
        except ValueError:          # not the main thread: no handler, no harm
            prev_term = None
        batches = self._batches()
        try:
            return self._train_loop(batches)
        finally:
            batches.close()
            self.loader.close()
            self.writer.close()
            if prev_term is not None:
                signal.signal(signal.SIGTERM, prev_term)
            # every checkpoint is on disk when train() returns
            self.ckpt_writer.close()

    def _preempt_stop(self, step: int) -> bool:
        """Whether to stop at the step boundary ``step`` (``trainer.py:420-440``).
        One process: the local SIGTERM flag.  Several: rank 0's flag,
        broadcast at the ``log_interval`` cadence, where the loop syncs on the
        loss anyway; the local flag never breaks the loop by itself, since a
        rank that stopped alone would leave the others waiting in the next
        step's collectives."""
        if mesh.world_size() == 1:
            return self._preempted
        if step % self.log_interval:
            return False
        return mesh.broadcast_flag(self._preempted, self.device)

    def _seed(self, step: int) -> None:
        """Seed the draws of the step after ``step`` steps (every rank alike)."""
        self.generator.manual_seed((self.seed + 777) * 1_000_003 + step)

    def _train_loop(self, batches) -> dict:
        step = self.state.step
        metrics_out = {}
        last_data_t = interval_t0 = time.time()
        interval_steps, paused = 0, 0.0     # since the last sync: steps, seconds off the step
        prof = None
        for batch in batches:
            if step >= self.max_steps:
                break
            if self._preempt_stop(step):
                log.warning("preempted — stopping at step %d (checkpoint follows; "
                            "relaunch with resume_from_checkpoint: latest)", step)
                break
            data_load_time = time.time() - last_data_t
            paused += data_load_time
            if data_load_time > DATA_LOAD_TIMEOUT:
                log.warning("data loading slow: %.1fs > %.0fs", data_load_time,
                            DATA_LOAD_TIMEOUT)
            extras = batch.pop("__extras__", {})
            if self.profile and step == 2 and self.is_main:
                t = time.time()
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    *([torch.profiler.ProfilerActivity.CUDA]
                      if self.device.type == "cuda" else [])])
                prof.start()
                tracing.enable()
                paused += time.time() - t

            self._seed(step)
            sync = (step + 1) % self.log_interval == 0 or (step + 1) >= self.max_steps
            try:
                self.state, metrics = self.step_fn(self.state, batch, self.generator)
                # sync only at log intervals: between them steps run back to
                # back on the device
                loss = float(metrics["loss"]) if sync else None
            except torch.cuda.OutOfMemoryError as e:
                log.error("out of device memory at step %d — stopping for a relaunch "
                          "with a smaller batch: %s", step, str(e)[:500])
                if mesh.world_size() > 1:
                    raise       # the other ranks wait in a collective: end the group
                break
            interval_steps += 1
            if loss is not None:
                step_time = (time.time() - interval_t0 - paused) / interval_steps
                if step_time > STEP_TIMEOUT:
                    log.error("step timeout: %.1fs > %.0fs", step_time, STEP_TIMEOUT)
            if prof is not None and step == 4:
                t = time.time()
                prof.stop()
                path = os.path.join(self.output_dir, "profile.json")
                prof.export_chrome_trace(path)
                tracing.add_to_trace(path, tracing.drain())
                tracing.disable()
                prof = None
                paused += time.time() - t

            step += 1
            if loss is not None:
                metrics_out = {"loss": loss, "step": step,
                               "grad_norm": float(metrics["grad_norm"]),
                               "step_time": step_time, "data_load_time": data_load_time,
                               **{k: float(extras[k]) for k in EXTRA_SCALARS if k in extras}}
                self.history.append(metrics_out)
                self.writer.scalar("train_loss", loss, step)
                self.writer.scalar("step_time", step_time, step)
                self.writer.scalar("data_load_time", data_load_time, step)
                for k in EXTRA_SCALARS:
                    if k in extras:
                        self.writer.scalar(k, float(extras[k]), step)
                log.info("step %d: loss=%.4f step_time=%.3fs data=%.3fs",
                         step, loss, step_time, data_load_time)
            else:
                metrics_out = {"step": step}
            if self._should_checkpoint(step):
                t = time.time()
                self._checkpoint(step)
                paused += time.time() - t
            last_data_t = time.time()
            if loss is not None:
                interval_t0, interval_steps, paused = last_data_t, 0, 0.0

        if prof is not None:
            prof.stop()
            tracing.disable()
            tracing.drain()
        if step > 0 and self._last_saved != step:
            self._checkpoint(step)
        return metrics_out


def train_from_config(cfg, profile: bool = False, device="cuda") -> dict:
    return Trainer(cfg, profile=profile, device=device).train()
