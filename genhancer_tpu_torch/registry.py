"""Model registry: config names -> concrete model configs.

Port of ``genhancer_tpu/registry.py`` for the serving slice.  DiT configs
come from ``models.dit.DIT_CONFIGS`` (random init by design), VAE configs
from ``models.vae.VAE_CONFIGS``, CLIP-family towers from
``models.towers.clip.CLIP_VARIANTS``.  Loading pretrained tower weights
(``clip_config.model_dir``) and the VAE checkpoint (``AE`` /
``ae_path``) waits for such files in the repository; asking for either
raises instead of silently falling back to random weights.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

from .models import dit as dit_m
from .models import vae as vae_m
from .models.towers import clip as clip_m


def build_dit_config(model_name: str) -> dit_m.DiTConfig:
    return dit_m.DIT_CONFIGS[model_name]


def build_vae_config(model_name: str = "flux-dev",
                     ae_path: Optional[str] = None) -> vae_m.VAEConfig:
    """The VAE config; the weights are random init (seeded by the caller)."""
    path = ae_path or os.environ.get("AE")
    if path:
        raise NotImplementedError(
            f"VAE checkpoint {path!r} (AE / ae_path): the ae.safetensors loader "
            "is not ported yet (ROADMAP: loaders waiting for weight files)")
    return vae_m.VAE_CONFIGS[model_name]


def tower_family_and_config(tower: str, clip_image_size: int,
                            clip_type: Optional[str] = None) -> Tuple[str, object]:
    """(kind, config) for a reference tower selection.

    tower: openai_clip | metaclip (clip_type large|huge).  siglip is not
    ported yet."""
    if tower == "siglip":
        raise NotImplementedError(
            "tower: siglip is not ported yet (ROADMAP: the SigLIP tower, the next "
            "item of slice 4)")
    if tower == "metaclip":
        name = f"metaclip-{'l14' if (clip_type or 'large') == 'large' else 'h14'}-fullcc2.5b"
        return "clip", clip_m.CLIP_VARIANTS[name]
    name = ("clip-vit-large-patch14" if clip_image_size == 224
            else "clip-vit-large-patch14-336")
    return "clip", clip_m.CLIP_VARIANTS[name]


def check_tower_weights(model_dir: Optional[str]) -> None:
    """Pretrained tower weights are not loadable yet: refuse a model_dir."""
    if model_dir:
        raise NotImplementedError(
            f"clip_config.model_dir={model_dir!r}: the HF tower loader is not "
            "ported yet (ROADMAP: loaders waiting for weight files)")
