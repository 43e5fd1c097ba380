"""Model registry: config names -> concrete model configs, and the tower
loader.

Port of ``genhancer_tpu/registry.py``.  DiT configs come from
``models.dit.DIT_CONFIGS`` (random init by design), VAE configs from
``models.vae.VAE_CONFIGS``, towers from ``models.towers.clip.CLIP_VARIANTS``
(CLIP/MetaCLIP, kind ``clip``) and ``models.towers.siglip.SIGLIP_VARIANTS``
(kind ``siglip``) or from a local HF model directory
(``clip_config.model_dir``: ``load_tower``).  The VAE's weights come from
the FLUX ``ae.safetensors`` named by ``ae_path`` or ``$AE``
(``vae_weights_path``, ``load_vae``); a path that names no file logs a
warning and leaves the VAE at its random init, as the JAX package does.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import torch

from .core.nn import init_weights
from .models import dit as dit_m
from .models import vae as vae_m
from .models.towers import clip as clip_m
from .models.towers import siglip as siglip_m
from .weights import convert, hf_io

log = logging.getLogger(__name__)


def build_dit_config(model_name: str) -> dit_m.DiTConfig:
    return dit_m.DIT_CONFIGS[model_name]


def build_vae_config(model_name: str = "flux-dev",
                     ae_path: Optional[str] = None) -> vae_m.VAEConfig:
    """The VAE config of ``model_name``; its weights come from
    ``vae_weights_path(ae_path)`` where that names a file (``load_vae``),
    else from the caller's seeded random init."""
    return vae_m.VAE_CONFIGS[model_name]


def vae_weights_path(ae_path: Optional[str] = None) -> Optional[str]:
    """The ``ae.safetensors`` to load: ``ae_path``, else ``$AE``
    (``registry.py:33-42``).  A path naming no file logs a warning and
    gives None: the VAE stays at its random init."""
    path = ae_path or os.environ.get("AE")
    if path and os.path.exists(path):
        return path
    if path:
        log.warning("AE checkpoint %s not found — random-init VAE", path)
    return None


def load_vae(vae: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load the FLUX ``ae.safetensors`` at ``path`` into ``vae`` (an
    ``AutoEncoder``), in place, strictly: the file's keys are the port's
    names and its convs OIHW, the port's layout (``hf_convert.
    load_vae_params`` transposes them to HWIO for JAX).  Each tensor is cast
    to the module's dtype."""
    vae.load_state_dict(hf_io.load_safetensors(path), strict=True)
    return vae


def tower_family_and_config(tower: str, clip_image_size: int,
                            clip_type: Optional[str] = None) -> Tuple[str, object]:
    """(kind, config) for a reference tower selection.

    tower: openai_clip | siglip | metaclip (clip_type large|huge)."""
    if tower == "siglip":
        return "siglip", siglip_m.SIGLIP_VARIANTS[f"siglip-so400m-patch14-{clip_image_size}"]
    if tower == "metaclip":
        name = f"metaclip-{'l14' if (clip_type or 'large') == 'large' else 'h14'}-fullcc2.5b"
        return "clip", clip_m.CLIP_VARIANTS[name]
    name = ("clip-vit-large-patch14" if clip_image_size == 224
            else "clip-vit-large-patch14-336")
    return "clip", clip_m.CLIP_VARIANTS[name]


def tower_dir(model_dir: Optional[str]) -> Optional[str]:
    """``model_dir`` if it is a directory; a missing one warns and means
    random init (``registry.py:77-78``)."""
    if model_dir and os.path.isdir(model_dir):
        return model_dir
    if model_dir:
        log.warning("tower dir %s not found — random init", model_dir)
    return None


def tower_class(kind: str, text_side: bool = True):
    """The tower module of a kind: the whole ``CLIPModel``/``SiglipModel``
    (``text_side``: stage 2, the eval) or its vision side (stage 1,
    serving)."""
    classes = {"clip": (clip_m.CLIPModel, clip_m.CLIPVisionTower),
               "siglip": (siglip_m.SiglipModel, siglip_m.SiglipVisionTower)}
    if kind not in classes:
        raise ValueError(f"tower kind must be clip or siglip, got {kind!r}")
    return classes[kind][0 if text_side else 1]


def tower_config(kind: str, model_dir: str):
    """The tower config of an HF model directory's ``config.json``."""
    cfg_cls = siglip_m.SiglipConfig if kind == "siglip" else clip_m.CLIPConfig
    return cfg_cls.from_hf(hf_io.load_hf_config(model_dir))


def load_tower(kind: str, cfg, model_dir: Optional[str] = None,
               generator: Optional[torch.Generator] = None, *, text_side: bool = True,
               device=None) -> Tuple[torch.nn.Module, object]:
    """(tower, cfg) — ``registry.py:62-78``: from a local HF directory
    (its ``config.json`` overrides ``cfg``; a ``model.`` key prefix is
    stripped) or, with no directory, random init drawn from ``generator``.
    ``text_side``: the whole ``CLIPModel``/``SiglipModel`` (stage 2, the
    eval) or the vision-only ``CLIPVisionTower``/``SiglipVisionTower``.
    Each loaded tensor keeps the directory's dtype,
    bfloat16 widened to float32, as the JAX loader does
    (``weights/torch_io.py:84-92``): a float16 directory gives a float16
    tower."""
    cls = tower_class(kind, text_side)
    model_dir = tower_dir(model_dir)
    if model_dir is not None:
        cfg = tower_config(kind, model_dir)
    if model_dir is None:
        return init_weights(cls(cfg, device=device), generator), cfg
    sd = hf_io.load_hf_dir_state_dict(model_dir)
    if any(k.startswith("model.") for k in sd):
        sd = {k[6:] if k.startswith("model.") else k: v for k, v in sd.items()}
    sd = {k: v.to(torch.float32) if v.dtype == torch.bfloat16 else v
          for k, v in convert.tower_from_hf(sd, text_side).items()}
    tower = cls(cfg, device="meta")
    tower.load_state_dict(sd, strict=True, assign=True)
    return tower.to(device), cfg
