"""Task factory: config -> (spec, loader, train-step factory, checkpoint kind).

Port of ``genhancer_tpu/tasks/factory.py`` for ``task: image_stage1`` with
``tower: openai_clip | metaclip``.  Video tasks, stage-2 tasks and the
SigLIP tower are not ported yet and raise, as do the options that need
several devices (ROADMAP slice 7).
"""

from __future__ import annotations

import torch

from .. import registry
from . import image as image_task
from .image import TaskSpec

# reference trainer script name -> (task, tower); the image rows
TRAINER_COMPAT = {
    "train_SigLIP_stage1": ("image_stage1", "siglip"),
    "train_SigLIP_stage2_only": ("image_stage2_only", "siglip"),
    "train_SigLIP_stage2_all": ("image_stage2_all", "siglip"),
    "train_MetaCLIP_stage1": ("image_stage1", "metaclip"),
    "train_MetaCLIP_stage2_only": ("image_stage2_only", "metaclip"),
    "train_MetaCLIP_stage2_all": ("image_stage2_all", "metaclip"),
}

# config knob -> its single-device value; any other value needs a mesh
_MULTI_DEVICE = {"model_parallel": 1, "sequence_parallel": 1, "pipeline_parallel": 1,
                 "fsdp": False, "shard_optimizer_state": False}


def validate_single_device(cfg) -> None:
    """Refuse the parallelism options: they are not ported yet."""
    for knob, single in _MULTI_DEVICE.items():
        value = cfg.get(knob)
        if value not in (None, single, 0):
            raise NotImplementedError(
                f"{knob}: {value} needs several devices, which the port does not "
                "drive yet (ROADMAP: slice 7, parallelism)")
    if int(cfg.get("num_devices") or 1) > 1:
        raise NotImplementedError(
            f"num_devices: {cfg.get('num_devices')} — the port trains on one device "
            "(ROADMAP: slice 7, parallelism)")


def _lora_kwargs(cfg) -> dict:
    lc = cfg.get("lora_config", {}) or {}
    return dict(lora_r=int(lc.get("r", 16)), lora_alpha=float(lc.get("lora_alpha", 16)),
                lora_targets=lc.get("target_modules", "all-linear"),
                lora_dropout=float(lc.get("lora_dropout", 0.0)))


def build_spec(cfg):
    """(spec, tower_kind, ckpt_kind) from a config mapping."""
    task: str = cfg["task"]
    if not task.startswith("image_"):
        raise NotImplementedError(
            f"task {task!r} is not ported yet (ROADMAP: slice 4, long sequences and "
            "video); the port runs image tasks")
    stage = task[len("image_"):]
    if stage != "stage1":
        raise NotImplementedError(f"task {task!r} is not ported yet (ROADMAP: slice 5, "
                                  "stage 2 and the caches)")
    dc = cfg.get("data_config", {}) or {}
    if dc.get("precomputed"):
        raise NotImplementedError("data_config.precomputed (the feature and latent "
                                  "caches) is not ported yet (ROADMAP: slice 5)")
    tower: str = cfg.get("tower", "openai_clip")
    cc = cfg.get("clip_config", {}) or {}
    img_size = int(dc.get("img_size", 224))
    clip_image_size = int(cc.get("clip_image_size", img_size))

    kind, tower_cfg = registry.tower_family_and_config(
        tower, clip_image_size, cc.get("clip_type"))
    registry.check_tower_weights(cc.get("model_dir"))
    model_name = cfg.get("model_name", "flux-dev")
    compute_dtype = (torch.bfloat16 if cfg.get("mixed_precision", "bf16") == "bf16"
                     else torch.float32)
    spec = TaskSpec(stage=stage, tower_kind=kind, img_size=img_size,
                    clip_image_size=clip_image_size,
                    dit_cfg=registry.build_dit_config(model_name),
                    vae_cfg=registry.build_vae_config(model_name, cfg.get("ae_path")),
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
                    dit_quant=cfg.get("dit_quant", "none"),
                    **_lora_kwargs(cfg))
    return spec, kind, "image"


def build_task(cfg):
    """(spec, loader, make_train_step, create_task_state, ckpt_kind) —
    build_spec plus the data loader.  Unlike the JAX build_task it returns
    no pretrained tower/VAE trees: the weights are random init from the
    config's seed until weight files are in the repository (registry)."""
    from ..data import cc3m as cc3m_data
    spec, _, ckpt_kind = build_spec(cfg)
    dc = dict(cfg.get("data_config", {}) or {})
    img_size = int(dc.pop("img_size", 224))
    loader = cc3m_data.loader(img_size=img_size, **dc)
    return (spec, loader, image_task.make_train_step, image_task.create_task_state,
            ckpt_kind)
