"""OpenAI-CLIP / MetaCLIP tower, vision side.

Port of ``genhancer_tpu/models/towers/clip.py``: the configs of every CLIP
variant the reference uses (text side included, as configuration only) and
the vision transformer the serving path runs.  Module names follow the HF
``CLIPModel`` state dict (``vision_model.embeddings.patch_embedding.weight``,
``vision_model.pre_layrnorm`` ..., ``visual_projection.weight``).

Parity details: ``last_hidden_state`` is returned without post_layernorm;
``pooled = post_layernorm(last[:, 0])``; the class token the DiT is
conditioned on is ``visual_projection(pooled)``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn as tnn

from ...core import nn
from .encoder import Encoder, EncoderConfig, encoder_forward


@dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"

    @property
    def encoder(self) -> EncoderConfig:
        return EncoderConfig(self.hidden_size, self.intermediate_size,
                             self.num_layers, self.num_heads,
                             self.layer_norm_eps, self.hidden_act)

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


@dataclass(frozen=True)
class CLIPTextConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    vocab_size: int = 49408
    max_position_embeddings: int = 77
    eos_token_id: int = 49407
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"


@dataclass(frozen=True)
class CLIPConfig:
    vision: CLIPVisionConfig = field(default_factory=CLIPVisionConfig)
    text: CLIPTextConfig = field(default_factory=CLIPTextConfig)
    projection_dim: int = 768
    logit_scale_init: float = 2.6592


CLIP_VARIANTS = {
    "clip-vit-large-patch14": CLIPConfig(),
    "clip-vit-large-patch14-336": CLIPConfig(vision=CLIPVisionConfig(image_size=336)),
    "metaclip-l14-fullcc2.5b": CLIPConfig(),
    "metaclip-h14-fullcc2.5b": CLIPConfig(
        vision=CLIPVisionConfig(hidden_size=1280, intermediate_size=5120,
                                num_layers=32, num_heads=16),
        text=CLIPTextConfig(hidden_size=1024, intermediate_size=4096,
                            num_layers=24, num_heads=16),
        projection_dim=1024),
}


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class _Table(tnn.Module):
    """A lone ``weight`` drawn from N(0, std^2): embedding tables and the
    visual projection, initialised as the JAX package does."""

    def __init__(self, shape, std: float, *, device=None, dtype=None):
        super().__init__()
        self.std = std
        self.weight = tnn.Parameter(torch.empty(shape, device=device,
                                                dtype=dtype or torch.float32))

    def init_(self, g):
        self.weight.normal_(0.0, self.std, generator=g)


class VisionEmbeddings(tnn.Module):
    def __init__(self, cfg: CLIPVisionConfig, **fk):
        super().__init__()
        g = cfg.grid
        self.class_embedding = tnn.Parameter(
            torch.empty(cfg.hidden_size, device=fk["device"],
                        dtype=fk["dtype"] or torch.float32))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         bias=False, **fk)
        self.position_embedding = _Table((g * g + 1, cfg.hidden_size), 0.02, **fk)

    def init_(self, g):
        self.class_embedding.normal_(0.0, 1.0, generator=g)


class VisionTransformer(tnn.Module):
    def __init__(self, cfg: CLIPVisionConfig, **fk):
        super().__init__()
        self.embeddings = VisionEmbeddings(cfg, **fk)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, **fk)
        self.encoder = Encoder(cfg.encoder, **fk)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, **fk)


class CLIPVisionTower(tnn.Module):
    """``vision_model`` + ``visual_projection`` of an HF ``CLIPModel``."""

    def __init__(self, cfg: CLIPConfig, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.vision_model = VisionTransformer(cfg.vision, **fk)
        self.visual_projection = _Table(
            (cfg.projection_dim, cfg.vision.hidden_size), 0.02, **fk)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def vision_embed(p: VisionEmbeddings, pixel_values: torch.Tensor,
                 cfg: CLIPVisionConfig) -> torch.Tensor:
    """pixel_values NHWC [B, H, W, 3] -> [B, 1+g*g, hidden] with CLS first."""
    x = torch.nn.functional.conv2d(
        pixel_values.permute(0, 3, 1, 2),
        p.patch_embedding.weight.to(pixel_values.dtype), stride=cfg.patch_size)
    b, c = x.shape[:2]
    x = x.flatten(2).transpose(1, 2)                    # [B, gh*gw, C]
    cls = p.class_embedding.to(x.dtype).expand(b, 1, c)
    x = torch.cat([cls, x], dim=1)
    return x + p.position_embedding.weight.to(x.dtype)[None, : x.shape[1]]


def vision_forward(p: VisionTransformer, pixel_values: torch.Tensor,
                   cfg: CLIPVisionConfig):
    """Returns (last_hidden_state [before post-LN], pooler_output)."""
    x = vision_embed(p.embeddings, pixel_values, cfg)
    x = nn.layernorm(p.pre_layrnorm, x, eps=cfg.layer_norm_eps)
    x = encoder_forward(p.encoder, x, cfg.encoder)
    pooled = nn.layernorm(p.post_layernorm, x[:, 0], eps=cfg.layer_norm_eps)
    return x, pooled


def visual_projection(p: CLIPVisionTower, pooled: torch.Tensor) -> torch.Tensor:
    """pooled [B, hidden] -> [B, projection_dim] (no bias); int8 once
    ``tower_quant: int8`` has quantized it, as every eligible linear."""
    if isinstance(p.visual_projection, nn.Int8Layer):
        return nn.linear(p.visual_projection, pooled)
    return torch.matmul(pooled, p.visual_projection.weight.to(pooled.dtype).t())
