"""Task factory: config -> (spec, loader, train-step factory, checkpoint kind).

Port of ``genhancer_tpu/tasks/factory.py`` for the tasks ``image_stage1``,
``image_stage2_only``, ``image_stage2_all``,
``video_{middle,next,next2,sliding}_stage1`` and
``video_{middle,next,next2,sliding}_stage2_all`` with ``tower: openai_clip |
siglip | metaclip`` (SigLIP in image mode only); ``clip_config.model_dir``
names a local HF tower directory (``registry.load_tower``: its
``config.json`` overrides the variant's config).  The video tasks' DiT
remat and ``tower_remat`` follow the JAX factory's gates on one device
(``factory.py:225-258``) unless the config sets them.  ``data_config.
precomputed`` takes the caches of ``data.precompute``: ``latents`` in every
stage, a features cache (``true``) in stage 1 only (``_check_precomputed``).
SigLIP in video mode raises.

Parallelism: data parallel over the ranks of a ``torch.distributed`` group
(``parallel.mesh``; one device per rank, ``num_devices`` the world size),
ZeRO-1 (``shard_optimizer_state``), tensor parallelism (``model_parallel``,
``parallel.tp``), FSDP (``fsdp``, ``parallel.fsdp``), sequence parallelism
(``sequence_parallel``, ring attention, ``parallel.ring``) and pipeline
parallelism (``pipeline_parallel`` with ``pipeline_microbatches``,
``parallel.pp``) are ported; the rank's data index and the data axis's
size split the loaders' shards (``node_index``/``node_count``).  The
compositions JAX rejects raise its ``ValueError``s
(``validate_parallelism``); ``sequence_parallel`` composes with
``dit_quant``, as in JAX.
"""

from __future__ import annotations

import torch

from .. import registry
from ..parallel import mesh
from ..train import lora
from . import image as image_task
from . import video as video_task
from .image import TaskSpec

# reference trainer script name -> (task, tower)
TRAINER_COMPAT = {
    "train_SigLIP_stage1": ("image_stage1", "siglip"),
    "train_SigLIP_stage2_only": ("image_stage2_only", "siglip"),
    "train_SigLIP_stage2_all": ("image_stage2_all", "siglip"),
    "train_MetaCLIP_stage1": ("image_stage1", "metaclip"),
    "train_MetaCLIP_stage2_only": ("image_stage2_only", "metaclip"),
    "train_MetaCLIP_stage2_all": ("image_stage2_all", "metaclip"),
    "train_OpenAICLIP_video_stage1": ("video_middle_stage1", "openai_clip"),
    "train_OpenAICLIP_video_stage2_all": ("video_middle_stage2_all", "openai_clip"),
    "train_OpenAICLIP_nextpredic_stage1": ("video_next_stage1", "openai_clip"),
    "train_OpenAICLIP_nextpredic_stage2_all": ("video_next_stage2_all", "openai_clip"),
    "train_OpenAICLIP_use2frames_nextpredic_stage1": ("video_next2_stage1", "openai_clip"),
    "train_OpenAICLIP_use2frames_nextpredic_stage2_all": ("video_next2_stage2_all", "openai_clip"),
    "train_OpenAICLIP_sliding_windows_nextpredic_stage1": ("video_sliding_stage1", "openai_clip"),
    "train_OpenAICLIP_sliding_windows_nextpredic_stage2_all": ("video_sliding_stage2_all",
                                                               "openai_clip"),
}

_VIDEO_MODE = {"video_middle": "middle", "video_next": "next",
               "video_next2": "next2", "video_sliding": "sliding"}
_LOADER_MODE = {"middle": "triplet", "next": "next", "next2": "next2",
                "sliding": "sliding"}
# the gates' per-device token thresholds (genhancer_tpu/tasks/factory.py:
# 236-258), set for a 16 GB chip and kept as is: DiT remat above
# REMAT_TOKENS joint tokens in stage 1 and half that in stage 2 (the tower's
# residuals share the memory), tower_remat above TOWER_REMAT_TOKENS tower tokens
REMAT_TOKENS = 8192
TOWER_REMAT_TOKENS = 6144


def validate_parallelism(cfg, dit_cfg=None) -> None:
    """``validate_parallelism`` (``factory.py:66-103``): the compositions the
    JAX package rejects raise its ``ValueError`` at config time, before any
    weights load; then ``num_devices``, where set, must equal the world
    size (one device per rank)."""
    tp = int(cfg.get("model_parallel", 1) or 1)
    sp = int(cfg.get("sequence_parallel", 1) or 1)
    pp = int(cfg.get("pipeline_parallel", 1) or 1)
    fsdp = bool(cfg.get("fsdp", False))
    if pp > 1 and (tp > 1 or sp > 1):
        raise ValueError(
            "pipeline_parallel composes with data parallelism only "
            f"(got model_parallel={tp}, sequence_parallel={sp}): TP shards "
            "the weight dims the PP stage stacking slices, and SP's ring "
            "would nest a second shard_map inside the stage body "
            "(parallel/pp.py 'Composition')")
    if fsdp:
        if pp > 1:
            raise ValueError("fsdp does not compose with pipeline_parallel "
                             "(stage stacking owns the param placement)")
        if sp > 1:
            raise ValueError("fsdp does not compose with sequence_parallel "
                             "(the attention anchor does not cover the ring "
                             "path); use shard_optimizer_state with SP")
        if cfg.get("fused_optimizer") == "pallas":
            raise ValueError(
                "fsdp requires the default optax optimizer: the fused Pallas "
                "AdamW would force an all-gather of each sharded param at "
                "the update (no custom_partitioning on the kernel); drop "
                "fused_optimizer or fsdp")
    if pp > 1 and dit_cfg is not None and (
            dit_cfg.depth % pp or dit_cfg.depth_single_blocks % pp):
        raise ValueError(
            f"pipeline_parallel={pp} must divide both depth={dit_cfg.depth} "
            f"and depth_single_blocks={dit_cfg.depth_single_blocks}")
    n = cfg.get("num_devices")
    if n and int(n) != mesh.world_size():
        raise ValueError(
            f"num_devices: {n} but this run has {mesh.world_size()} rank(s), one device each: "
            f"launch {n} processes (python -m torch.distributed.run --nproc_per_node {n} ...) "
            "or drop num_devices")


def _check_precomputed(cfg, task: str) -> None:
    """``_check_precomputed`` (``factory.py:106-120``): a features cache
    holds the frozen tower's outputs, which stage 2 trains, so it is refused
    there; the latent cache (the VAE's moments and the crops) is taken in
    every stage."""
    dc = cfg.get("data_config", {}) or {}
    if (dc.get("precomputed") and dc.get("precomputed") != "latents"
            and not task.endswith("stage1")):
        raise ValueError(
            "data_config.precomputed (features cache) is stage-1 only: "
            "stage-2 trains the tower (LoRA), so conditioning features must "
            "be computed live.  Use precomputed: 'latents' with a "
            "--mode latents cache to skip just the frozen VAE")


def _lora_kwargs(cfg, tower: str) -> dict:
    """``lora_config`` -> the spec's LoRA fields (``factory.py:56-63``):
    CLIP-family towers default to ``all-linear``, SigLIP to its six
    projection names."""
    lc = cfg.get("lora_config", {}) or {}
    targets = "all-linear" if tower in ("openai_clip", "metaclip") else lora.SIGLIP_TARGETS
    return dict(lora_r=int(lc.get("r", 16)), lora_alpha=float(lc.get("lora_alpha", 16)),
                lora_targets=lc.get("target_modules", targets),
                lora_dropout=float(lc.get("lora_dropout", 0.0)))


def remat_gate(n_cond: int, clip_image_size: int, patch: int, img_size: int,
               batch: int, stage2: bool = False, sequence_parallel: int = 1) -> bool:
    """The JAX factory's automatic DiT remat decision for a video task
    (``factory.py:233-246``) on the rank's tokens: on when the joint
    sequence is at least 1024 tokens and ``batch`` rows (the rank's data
    index's, ``train_batch_size``) of its ``1 / sequence_parallel`` share
    exceed ``REMAT_TOKENS`` (half that in stage 2).  JAX's per-device count
    ``bs * process_count / n_data * seq / sp`` with ``n_data = n_dev //
    (tp * sp * pp)`` is this with its host's batch split over its data
    shards."""
    seq = n_cond * (clip_image_size // patch) ** 2 + (img_size // 16) ** 2
    tokens = batch * (seq / sequence_parallel)
    return seq >= 1024 and tokens > REMAT_TOKENS // (2 if stage2 else 1)


def tower_remat_gate(n_cond: int, clip_image_size: int, patch: int, batch: int) -> bool:
    """The JAX factory's ``tower_remat`` decision for a video stage-2 task
    (``factory.py:247-258``) on the rank's rows: on when ``batch x n_cond x
    (grid^2 + 1)`` tower tokens exceed ``TOWER_REMAT_TOKENS`` (the tower
    runs on every token, whatever the seq axis)."""
    return batch * n_cond * ((clip_image_size // patch) ** 2 + 1) > TOWER_REMAT_TOKENS


def build_spec(cfg):
    """(spec, tower_kind, ckpt_kind) from a config mapping."""
    task: str = cfg["task"]
    dit_cfg = registry.build_dit_config(cfg.get("model_name", "flux-dev"))
    validate_parallelism(cfg, dit_cfg)
    if task.startswith("image_"):
        stage = task[len("image_"):]
    elif task.rsplit("_stage", 1)[0] in _VIDEO_MODE:
        stage = "stage" + task.rsplit("_stage", 1)[1]
    else:
        raise ValueError(f"unknown task {task!r}")
    dc = cfg.get("data_config", {}) or {}
    _check_precomputed(cfg, task)
    tower: str = cfg.get("tower", "openai_clip")
    cc = cfg.get("clip_config", {}) or {}
    img_size = int(dc.get("img_size", 224))
    clip_image_size = int(cc.get("clip_image_size", img_size))

    kind, tower_cfg = registry.tower_family_and_config(
        tower, clip_image_size, cc.get("clip_type"))
    tower_dir = registry.tower_dir(cc.get("model_dir"))
    if tower_dir is not None:
        tower_cfg = registry.tower_config(kind, tower_dir)
    compute_dtype = (torch.bfloat16 if cfg.get("mixed_precision", "bf16") == "bf16"
                     else torch.float32)
    common = dict(stage=stage, tower_kind=kind, img_size=img_size,
                  clip_image_size=clip_image_size,
                  dit_cfg=dit_cfg,
                  vae_cfg=registry.build_vae_config(cfg.get("model_name", "flux-dev"),
                                                    cfg.get("ae_path")),
                  tower_cfg=tower_cfg,
                  clip_dim=int(cc.get("clip_dim", 768)),
                  t5_dim=int(cc.get("t5_dim", 4096)),
                  scale_factor=float(cfg.get("scale_factor", 1.0)),
                  guidance=float(cfg.get("guidance", 4.0)),
                  remat=bool(cfg.get("remat") or False),
                  compute_dtype=compute_dtype,
                  dit_param_dtype=compute_dtype,
                  # bf16 by default for the frozen VAE encode, as the JAX
                  # trainer (documented deviation from the reference's
                  # fp32); `vae_dtype: fp32` restores parity
                  vae_dtype=(torch.float32 if cfg.get("vae_dtype") == "fp32"
                             else torch.bfloat16),
                  tower_dir=tower_dir,
                  vae_path=registry.vae_weights_path(cfg.get("ae_path")),
                  tower_remat=bool(cfg.get("tower_remat") or False),
                  # the int8 stack (core.quant); the weight cache pays only
                  # when the fused optimizer emits it (JAX factory.py:177-188)
                  tower_quant=cfg.get("tower_quant", "none"),
                  vae_quant=cfg.get("vae_quant", "none"),
                  vae_quant_min_ch=int(cfg.get("vae_quant_min_ch", 256)),
                  dit_quant=cfg.get("dit_quant", "none"),
                  dit_quant_cache=cfg.get("fused_optimizer") == "pallas",
                  # the mesh's seq and pipe axes (JAX factory.py:191-195)
                  sequence_parallel=int(cfg.get("sequence_parallel", 1) or 1),
                  pipeline_parallel=int(cfg.get("pipeline_parallel", 1) or 1),
                  pipeline_microbatches=int(cfg.get("pipeline_microbatches", 0) or 0),
                  **_lora_kwargs(cfg, tower))
    if task.startswith("image_"):
        spec = TaskSpec(**common)
        image_task.require_ported(spec)
        return spec, kind, "image"

    mode = _VIDEO_MODE[task.rsplit("_stage", 1)[0]]
    n_cond, patch = video_task.VIDEO_MODES[mode]["n_cond"], tower_cfg.vision.patch_size
    bs = int(cfg.get_path("data_config.train_batch_size", cfg.get("train_batch_size", 8)))
    if cfg.get("remat") is None:
        common["remat"] = remat_gate(n_cond, clip_image_size, patch, img_size, bs,
                                     stage2=stage != "stage1",
                                     sequence_parallel=common["sequence_parallel"])
    if cfg.get("tower_remat") is None and stage != "stage1":
        common["tower_remat"] = tower_remat_gate(n_cond, clip_image_size, patch, bs)
    spec = video_task.VideoTaskSpec(
        mode=mode, adapter_in_dim=tower_cfg.vision.hidden_size,
        remat_policy=cfg.get("remat_policy", "full"), **common)
    video_task.require_ported(spec)
    return spec, kind, "video"


def build_task(cfg):
    """(spec, loader, make_train_step, create_task_state, ckpt_kind) —
    build_spec plus the data loader.  Unlike the JAX build_task it returns
    no pretrained tower/VAE trees: the weights are random init from the
    config's seed until weight files are in the repository (registry)."""
    spec, _, ckpt_kind = build_spec(cfg)
    dc = dict(cfg.get("data_config", {}) or {})
    img_size = int(dc.pop("img_size", 224))
    # each data index reads its own shards (webdataset split_by_node,
    # factory.py:288-291); the model ranks of one data index read the same
    dc.setdefault("node_index", mesh.data_rank())
    dc.setdefault("node_count", mesh.data_size())
    if ckpt_kind == "image":
        from ..data import cc3m as cc3m_data
        loader = cc3m_data.loader(img_size=img_size, **dc)
        return (spec, loader, image_task.make_train_step, image_task.create_task_state,
                ckpt_kind)
    from ..data import video as video_data
    for k in ("window_cond", "window_stride", "max_windows_per_video"):
        if k in cfg:
            dc[k] = cfg[k]
    if spec.mode != "sliding":
        dc.pop("max_frames_per_video", None)
    loader = video_data.loader(mode=_LOADER_MODE[spec.mode], img_size=img_size, **dc)
    return (spec, loader, video_task.make_train_step, video_task.create_task_state,
            ckpt_kind)
