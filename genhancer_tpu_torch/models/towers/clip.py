"""OpenAI-CLIP / MetaCLIP tower.

Port of ``genhancer_tpu/models/towers/clip.py``: the configs of every CLIP
variant the reference uses (with ``CLIPConfig.to_hf``/``from_hf``), the
vision transformer the serving and stage-1 paths run (``CLIPVisionTower``:
``vision_model`` + ``visual_projection``), and for stage 2, which
fine-tunes and exports the whole HF ``CLIPModel`` (``clip.py:193-203``),
``CLIPModel``: the same vision side plus the text side's parameters
(``text_model.*``, ``text_projection``, ``logit_scale``), with the text
forward and the feature and logit functions the MMVP-VLM evaluation calls
(``clip.py:232-268``).  Module names follow the HF ``CLIPModel`` state dict
(``vision_model.embeddings.patch_embedding.weight``,
``vision_model.pre_layrnorm`` ..., ``visual_projection.weight``).

Parity details: ``last_hidden_state`` is returned without post_layernorm;
``pooled = post_layernorm(last[:, 0])``; the class token the DiT is
conditioned on is ``visual_projection(pooled)``; the text side pools at the
argmax of the ids when ``eos_token_id == 2`` (legacy configs), else at the
first EOS; ``logits_per_text = exp(logit_scale) * norm(text) @
norm(image).T``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn as tnn

from ...core import nn
from .encoder import Encoder, EncoderConfig, causal_mask, encoder_forward, padding_mask


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

    @property
    def encoder(self) -> EncoderConfig:
        return EncoderConfig(self.hidden_size, self.intermediate_size,
                             self.num_layers, self.num_heads,
                             self.layer_norm_eps, self.hidden_act)


@dataclass(frozen=True)
class CLIPConfig:
    vision: CLIPVisionConfig = field(default_factory=CLIPVisionConfig)
    text: CLIPTextConfig = field(default_factory=CLIPTextConfig)
    projection_dim: int = 768
    logit_scale_init: float = 2.6592

    def to_hf(self) -> dict:
        """An HF ``CLIPConfig`` dict: the ``config.json`` of a stage-2 export
        when no base model directory is given (``clip.py:81-111``)."""
        v, t = self.vision, self.text
        return {
            "architectures": ["CLIPModel"], "model_type": "clip",
            "projection_dim": self.projection_dim,
            "logit_scale_init_value": self.logit_scale_init,
            "vision_config": {
                "model_type": "clip_vision_model", "hidden_size": v.hidden_size,
                "intermediate_size": v.intermediate_size,
                "num_hidden_layers": v.num_layers, "num_attention_heads": v.num_heads,
                "image_size": v.image_size, "patch_size": v.patch_size,
                "layer_norm_eps": v.layer_norm_eps, "hidden_act": v.hidden_act,
            },
            "text_config": {
                "model_type": "clip_text_model", "hidden_size": t.hidden_size,
                "intermediate_size": t.intermediate_size,
                "num_hidden_layers": t.num_layers, "num_attention_heads": t.num_heads,
                "vocab_size": t.vocab_size,
                "max_position_embeddings": t.max_position_embeddings,
                "eos_token_id": t.eos_token_id, "layer_norm_eps": t.layer_norm_eps,
                "hidden_act": t.hidden_act,
            },
        }

    @staticmethod
    def from_hf(cfg: dict) -> "CLIPConfig":
        """An HF ``config.json`` dict -> CLIPConfig, with the JAX package's
        defaults for absent keys (``clip.py:113-130``)."""
        v, t = cfg["vision_config"], cfg["text_config"]
        return CLIPConfig(
            vision=CLIPVisionConfig(
                hidden_size=v["hidden_size"], intermediate_size=v["intermediate_size"],
                num_layers=v["num_hidden_layers"], num_heads=v["num_attention_heads"],
                image_size=v["image_size"], patch_size=v["patch_size"],
                layer_norm_eps=v.get("layer_norm_eps", 1e-5),
                hidden_act=v.get("hidden_act", "quick_gelu")),
            text=CLIPTextConfig(
                hidden_size=t["hidden_size"], intermediate_size=t["intermediate_size"],
                num_layers=t["num_hidden_layers"], num_heads=t["num_attention_heads"],
                vocab_size=t["vocab_size"],
                max_position_embeddings=t.get("max_position_embeddings", 77),
                eos_token_id=t.get("eos_token_id", 2),
                layer_norm_eps=t.get("layer_norm_eps", 1e-5),
                hidden_act=t.get("hidden_act", "quick_gelu")),
            projection_dim=cfg.get("projection_dim", 512),
            logit_scale_init=cfg.get("logit_scale_init_value", 2.6592),
        )


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


class TextEmbeddings(tnn.Module):
    def __init__(self, cfg: CLIPTextConfig, **fk):
        super().__init__()
        self.token_embedding = _Table((cfg.vocab_size, cfg.hidden_size), 0.02, **fk)
        self.position_embedding = _Table((cfg.max_position_embeddings, cfg.hidden_size),
                                         0.02, **fk)


class TextTransformer(tnn.Module):
    def __init__(self, cfg: CLIPTextConfig, **fk):
        super().__init__()
        self.embeddings = TextEmbeddings(cfg, **fk)
        self.encoder = Encoder(cfg.encoder, **fk)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, **fk)


class CLIPModel(tnn.Module):
    """The whole HF ``CLIPModel`` (``init_clip``, in its key order): the
    vision side of ``CLIPVisionTower`` plus the text side's parameters,
    which stage 2 wraps with LoRA and exports."""

    def __init__(self, cfg: CLIPConfig, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.vision_model = VisionTransformer(cfg.vision, **fk)
        self.text_model = TextTransformer(cfg.text, **fk)
        self.visual_projection = _Table(
            (cfg.projection_dim, cfg.vision.hidden_size), 0.02, **fk)
        self.text_projection = _Table(
            (cfg.projection_dim, cfg.text.hidden_size), 0.02, **fk)
        self.logit_scale = tnn.Parameter(torch.empty((), device=device,
                                                     dtype=dtype or torch.float32))

    def init_(self, g):
        self.logit_scale.fill_(self.cfg.logit_scale_init)


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


def visual_projection(p, pooled: torch.Tensor) -> torch.Tensor:
    """pooled [B, hidden] -> [B, projection_dim] (no bias) through
    ``core.nn.linear``: int8 once ``tower_quant: int8`` has quantized it, with
    the LoRA branch once stage 2 has wrapped it.  ``p``: a CLIPVisionTower
    or CLIPModel."""
    return nn.linear(p.visual_projection, pooled)


def text_forward(p: TextTransformer, input_ids: torch.Tensor, cfg: CLIPTextConfig,
                 attention_mask=None):
    """Returns (last_hidden_state, pooled_output), pooled at the EOS
    position; the activations take the embedding tables' dtype."""
    b, l = input_ids.shape
    x = (p.embeddings.token_embedding.weight[input_ids]
         + p.embeddings.position_embedding.weight[None, :l])
    mask = causal_mask(l, x.dtype, x.device)
    if attention_mask is not None:
        mask = mask + padding_mask(attention_mask.to(x.device), x.dtype)
    x = encoder_forward(p.encoder, x, cfg.encoder, mask)
    x = nn.layernorm(p.final_layer_norm, x, eps=cfg.layer_norm_eps)
    if cfg.eos_token_id == 2:      # legacy configs: EOS is the largest token id
        eos_pos = torch.argmax(input_ids, dim=-1)
    else:
        eos_pos = torch.argmax((input_ids == cfg.eos_token_id).to(torch.int32), dim=-1)
    pooled = x[torch.arange(b, device=x.device), eos_pos]
    return x, pooled


def get_image_features(model, pixel_values: torch.Tensor, cfg: CLIPConfig) -> torch.Tensor:
    """NHWC pixels -> [B, projection_dim]; ``model``: a CLIPVisionTower or
    CLIPModel."""
    _, pooled = vision_forward(model.vision_model, pixel_values, cfg.vision)
    return visual_projection(model, pooled)


def get_text_features(model: CLIPModel, input_ids: torch.Tensor, cfg: CLIPConfig,
                      attention_mask=None) -> torch.Tensor:
    _, pooled = text_forward(model.text_model, input_ids, cfg.text, attention_mask)
    return nn.linear(model.text_projection, pooled)


def clip_logits(model: CLIPModel, input_ids, pixel_values, cfg: CLIPConfig,
                attention_mask=None):
    """(logits_per_text [T, I], logits_per_image [I, T]) — modeling_clip.py."""
    img = get_image_features(model, pixel_values, cfg)
    txt = get_text_features(model, input_ids, cfg, attention_mask)
    img = img / torch.linalg.norm(img, dim=-1, keepdim=True)
    txt = txt / torch.linalg.norm(txt, dim=-1, keepdim=True)
    logits_per_text = torch.exp(model.logit_scale) * txt @ img.T
    return logits_per_text, logits_per_text.T
