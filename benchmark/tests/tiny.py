"""Tiny cells for the CPU tests: the port's registry patched to tiny model
sizes (``patch_registry``) and a cell whose files hold the same sizes, run
in float32 so that the program and the reference agree to rounding."""

from __future__ import annotations

import copy

from benchmark import harness

DIT = dict(in_channels=16, vec_in_dim=24, context_in_dim=32, hidden_size=64, mlp_ratio=4.0,
           num_heads=4, depth=1, depth_single_blocks=1, axes_dim=[4, 6, 6], theta=10000,
           qkv_bias=True, guidance_embed=True)
VAE = dict(resolution=32, in_channels=3, ch=8, out_ch=3, ch_mult=[1, 2], num_res_blocks=1,
           z_channels=4, scale_factor=0.3611, shift_factor=0.1159)
TOWER = dict(hidden_size=16, intermediate_size=32, num_layers=1, num_heads=2, image_size=32,
             patch_size=16, layer_norm_eps=1e-5, hidden_act="quick_gelu", projection_dim=24)
LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "update_gap": 1e-3}


def patch_registry(monkeypatch) -> None:
    """Tiny model sizes; the loaders decode with PIL, as on a machine
    without libjpeg (the card's), where the reference's decode is exact."""
    from genhancer_tpu_torch import registry
    from genhancer_tpu_torch.data import native_decode
    from genhancer_tpu_torch.models import dit, vae
    from genhancer_tpu_torch.models.towers import clip
    d = dit.DiTConfig(**{**DIT, "axes_dim": tuple(DIT["axes_dim"])})
    v = vae.VAEConfig(**{**VAE, "ch_mult": tuple(VAE["ch_mult"])})
    vis = {k: x for k, x in TOWER.items() if k != "projection_dim"}
    t = clip.CLIPConfig(vision=clip.CLIPVisionConfig(**vis),
                        projection_dim=TOWER["projection_dim"])
    monkeypatch.setattr(registry, "build_dit_config", lambda name: d)
    monkeypatch.setattr(registry, "build_vae_config", lambda name, ae_path=None: v)
    monkeypatch.setattr(registry, "tower_family_and_config",
                        lambda tower, size, clip_type=None: ("clip", t))
    monkeypatch.setattr(native_decode, "available", lambda: False)


def cell(mode: str = "image", precomputed=None, limits=None) -> harness.Cell:
    train = {"task": "image_stage1" if mode == "image" else "video_sliding_stage1",
             "tower": "metaclip" if mode == "image" else "openai_clip",
             "model_name": "flux-dev",
             "data_config": {"train_batch_size": 2, "num_workers": 2, "img_size": 32,
                             "seed": 0},
             "clip_config": {"clip_image_size": 32, "clip_dim": 24, "t5_dim": 32},
             "mixed_precision": "fp32", "learning_rate": 1e-3, "lr_scheduler": "constant",
             "adam_beta1": 0.9, "adam_beta2": 0.999, "adam_weight_decay": 0.01,
             "adam_epsilon": 1e-8, "max_grad_norm": 1.0, "gradient_accumulation_steps": 2,
             "max_train_steps": 1000, "log_interval": 2, "vae_dtype": "fp32"}
    model = {"mode": mode, "img_size": 32, "guidance": 4.0, "compute_dtype": "float32",
             "dit_param_dtype": "float32", "logit_normal_scale": 1.0,
             "target_time": 0.0 if mode == "image" else 3.0,
             "dit": copy.deepcopy(DIT), "vae": copy.deepcopy(VAE), "tower": copy.deepcopy(TOWER),
             "projectors": {"clip_dim": 24, "t5_dim": 32}, "unused": ["vae.decoder."]}
    if mode == "image":
        data = {"kind": "images", "count": 12, "shards": 2, "short_side": [40, 56],
                "aspect": [1.0, 1.5], "quality": 90}
    else:
        train["data_config"].update(return_mode="full_frames", max_frames_per_video=200)
        train.update(window_cond=3, window_stride=1, max_windows_per_video=2)
        model.update(frame_times=[0.0, 1.0, 2.0], unused=["vae.decoder.", "clip.project_clip."])
        data = {"kind": "videos", "count": 6, "shards": 2, "width": 40, "height": 32,
                "frames": [6, 12], "pool": 3, "quality": 90}
        limits = {**(limits or LIMITS), "input_rows_off": 0}
    config = {"train_config": train, "overrides": {"report_to": "none"}, "model": model}
    name = f"tiny_{mode}"
    workload = {"name": name, "data": data, "checked_steps": 3, "reference_rows": 3,
                "trace": {"after_steps": 1, "steps": 1}, "precomputed": precomputed,
                "limits": dict(limits or LIMITS)}
    entry = {"name": name, "config": "tiny", "traffic": "tiny", "chips": 1}
    return harness.Cell(name, entry, config, workload, 1, {"per_layer": []})
