"""YAML config system preserving the reference train_configs schema.

The loader half of ``genhancer_tpu/train/config.py``, carried over (it has no
JAX dependency, but the JAX package's ``train/__init__`` imports jax).

The reference uses OmegaConf attribute-access configs
(``train_SigLIP_stage1.py:91``); omegaconf is not in this image, so we provide
a small attribute-dict over PyYAML with the same ergonomics plus defaults for
every knob in the reference schema (SURVEY.md §2.7).
"""

from __future__ import annotations

import copy
from typing import Any, Mapping

import yaml


class Config(dict):
    """dict with attribute access, recursive over nested mappings."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def _wrap(obj: Any) -> Any:
        if isinstance(obj, Mapping):
            return Config({k: Config._wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config._wrap(v) for v in obj]
        return obj

    def get_path(self, path: str, default=None):
        node: Any = self
        for part in path.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node

    def merged_with(self, other: Mapping) -> "Config":
        out = copy.deepcopy(self)

        def merge(dst, src):
            for k, v in src.items():
                if isinstance(v, Mapping) and isinstance(dst.get(k), Mapping):
                    merge(dst[k], v)
                else:
                    dst[k] = Config._wrap(v)
        merge(out, other)
        return out


# Defaults mirror the reference YAML schema (e.g. test_SigLIP_384_stage1.yaml).
TRAIN_DEFAULTS = {
    "model_name": "flux-dev",
    "report_to": "tensorboard",
    "scale_factor": 1.0,
    "guidance": 4.0,
    "learning_rate": 1e-4,
    "lr_scheduler": "constant",
    "lr_warmup_steps": 10,
    "adam_beta1": 0.9,
    "adam_beta2": 0.999,
    "adam_weight_decay": 0.01,
    "adam_epsilon": 1e-8,
    "max_grad_norm": 1.0,
    "logging_dir": "logs",
    "mixed_precision": "bf16",
    "checkpointing_steps": 1000,
    "checkpoints_total_limit": 50,
    "tracker_project_name": "genhancer-tpu",
    "resume_from_checkpoint": None,
    "gradient_accumulation_steps": 1,
    # float32 (safe default) | param: accumulate micro-grads in each param's
    # own dtype — for bf16 params that matches torch-DDP-under-bf16 grad
    # buckets (the reference's accelerate path) and halves accumulator HBM
    "grad_accum_dtype": "float32",
    "max_train_steps": 1000,
    "num_train_epochs": 1,
    "seed": 0,
    "remat": None,     # None = auto (enabled for long-sequence video modes)
    "tower_remat": None,  # None = auto (video stage-2 tower-under-autodiff)
    "num_devices": None,          # None -> all local devices on the data axis
}


def load_config(path: str) -> Config:
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    cfg = Config._wrap(TRAIN_DEFAULTS).merged_with(raw)
    # runtime injection parity (train_SigLIP_stage1.py:93) — unused downstream
    if "clip_config" in cfg:
        cfg.clip_config.setdefault(
            "seq_t5", 256 if cfg.get("model_name") == "flux-schnell" else 512)
    return cfg

