"""SigLIP so400m tower family (HF ``SiglipModel`` equivalent).

Port of ``genhancer_tpu/models/towers/siglip.py``: the configs (with
``SiglipConfig.to_hf``/``from_hf``) and the 224/384 variants, the vision
side the stage-1 and serving paths run (``SiglipVisionTower``:
``vision_model`` only) and, for stage 2 and the MMVP-VLM evaluation, the
whole model (``SiglipModel``: ``vision_model``, ``text_model``,
``logit_scale``, ``logit_bias``).  Module names follow the HF state dict
(``vision_model.embeddings.patch_embedding``, ``vision_model.head.probe``,
``vision_model.head.attention.in_proj_weight``, ``text_model.head`` ...).

Parity details (``siglip.py:196-265``):
  * vision: the patch conv has a bias (added after the conv, in the
    activation dtype), VALID (384 // 14 = 27: the last 6 pixels are
    dropped), no CLS token, position embedding on every patch;
    ``last_hidden_state`` is post-layernormed, and all its tokens are the
    "patch tokens"; layer_norm_eps 1e-6 everywhere; ``gelu_pytorch_tanh``;
  * the MAP head: a probe [1, 1, h] attends over every token through q, k,
    v = the row thirds of ``in_proj_weight`` (JAX's ``mha`` on x_q = probe,
    x_kv = tokens: the logits scaled after the product, unlike torch's
    ``nn.MultiheadAttention``, which scales q first); the residual is the
    attention output, not the probe; the result is ``out[:, 0]``;
  * text: no causal mask, pooled = ``head(last_hidden_state[:, -1])``;
  * ``logits_per_text = exp(logit_scale) * norm(t) @ norm(i).T +
    logit_bias``.

``logit_scale`` and ``logit_bias`` are 0-d, as the JAX tree's; an HF
directory's [1]-shaped ones are reshaped on load (``registry.load_tower``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn as tnn

from ...core import nn
from .clip import _Table
from .encoder import MLP, Encoder, EncoderConfig, encoder_forward, mha, padding_mask


@dataclass(frozen=True)
class SiglipVisionConfig:
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_layers: int = 27
    num_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    hidden_act: str = "gelu_pytorch_tanh"

    @property
    def encoder(self) -> EncoderConfig:
        return EncoderConfig(self.hidden_size, self.intermediate_size,
                             self.num_layers, self.num_heads,
                             self.layer_norm_eps, self.hidden_act)

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


@dataclass(frozen=True)
class SiglipTextConfig:
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_layers: int = 27
    num_heads: int = 16
    vocab_size: int = 32000
    max_position_embeddings: int = 64
    projection_size: int = 1152
    layer_norm_eps: float = 1e-6
    hidden_act: str = "gelu_pytorch_tanh"

    @property
    def encoder(self) -> EncoderConfig:
        return EncoderConfig(self.hidden_size, self.intermediate_size,
                             self.num_layers, self.num_heads,
                             self.layer_norm_eps, self.hidden_act)


@dataclass(frozen=True)
class SiglipConfig:
    vision: SiglipVisionConfig = field(default_factory=SiglipVisionConfig)
    text: SiglipTextConfig = field(default_factory=SiglipTextConfig)

    def to_hf(self) -> dict:
        """An HF ``SiglipConfig`` dict: the ``config.json`` of a stage-2
        export when no base model directory is given (``siglip.py:76-106``)."""
        v, t = self.vision, self.text
        return {
            "architectures": ["SiglipModel"], "model_type": "siglip",
            "vision_config": {
                "model_type": "siglip_vision_model", "hidden_size": v.hidden_size,
                "intermediate_size": v.intermediate_size,
                "num_hidden_layers": v.num_layers, "num_attention_heads": v.num_heads,
                "image_size": v.image_size, "patch_size": v.patch_size,
                "layer_norm_eps": v.layer_norm_eps, "hidden_act": v.hidden_act,
            },
            "text_config": {
                "model_type": "siglip_text_model", "hidden_size": t.hidden_size,
                "intermediate_size": t.intermediate_size,
                "num_hidden_layers": t.num_layers, "num_attention_heads": t.num_heads,
                "vocab_size": t.vocab_size,
                "max_position_embeddings": t.max_position_embeddings,
                "projection_size": t.projection_size,
                "layer_norm_eps": t.layer_norm_eps, "hidden_act": t.hidden_act,
            },
        }

    @staticmethod
    def from_hf(cfg: dict) -> "SiglipConfig":
        """An HF ``config.json`` dict -> SiglipConfig, with the JAX package's
        defaults for absent keys (``siglip.py:108-130``)."""
        v, t = cfg["vision_config"], cfg["text_config"]
        return SiglipConfig(
            vision=SiglipVisionConfig(
                hidden_size=v["hidden_size"], intermediate_size=v["intermediate_size"],
                num_layers=v["num_hidden_layers"], num_heads=v["num_attention_heads"],
                image_size=v["image_size"], patch_size=v["patch_size"],
                layer_norm_eps=v.get("layer_norm_eps", 1e-6),
                hidden_act=v.get("hidden_act", "gelu_pytorch_tanh")),
            text=SiglipTextConfig(
                hidden_size=t["hidden_size"], intermediate_size=t["intermediate_size"],
                num_layers=t["num_hidden_layers"], num_heads=t["num_attention_heads"],
                vocab_size=t["vocab_size"],
                max_position_embeddings=t.get("max_position_embeddings", 64),
                projection_size=t.get("projection_size", t["hidden_size"]),
                layer_norm_eps=t.get("layer_norm_eps", 1e-6),
                hidden_act=t.get("hidden_act", "gelu_pytorch_tanh")),
        )


SIGLIP_VARIANTS = {
    "siglip-so400m-patch14-224": SiglipConfig(),
    "siglip-so400m-patch14-384": SiglipConfig(vision=SiglipVisionConfig(image_size=384)),
}


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class VisionEmbeddings(tnn.Module):
    def __init__(self, cfg: SiglipVisionConfig, **fk):
        super().__init__()
        g = cfg.grid
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size, **fk)
        self.position_embedding = _Table((g * g, cfg.hidden_size), 0.02, **fk)


class HeadAttention(tnn.Module):
    """The MAP head's ``nn.MultiheadAttention`` parameters under its names:
    q, k, v packed row-wise in ``in_proj_weight`` [3h, h]."""

    def __init__(self, h: int, *, device=None, dtype=None):
        super().__init__()
        dt = dtype or torch.float32
        self.in_proj_weight = tnn.Parameter(torch.empty((3 * h, h), device=device, dtype=dt))
        self.in_proj_bias = tnn.Parameter(torch.empty((3 * h,), device=device, dtype=dt))
        self.out_proj = nn.Linear(h, h, device=device, dtype=dtype)

    def init_(self, g):
        self.in_proj_weight.normal_(0.0, 0.02, generator=g)
        self.in_proj_bias.zero_()


class MAPHead(tnn.Module):
    """``SiglipMultiheadAttentionPoolingHead``."""

    def __init__(self, cfg: SiglipVisionConfig, **fk):
        super().__init__()
        h = cfg.hidden_size
        self.probe = tnn.Parameter(torch.empty((1, 1, h), device=fk["device"],
                                               dtype=fk["dtype"] or torch.float32))
        self.attention = HeadAttention(h, **fk)
        self.layernorm = nn.LayerNorm(h, **fk)
        self.mlp = MLP(h, cfg.intermediate_size, **fk)

    def init_(self, g):
        self.probe.normal_(0.0, 1.0, generator=g)


class VisionTransformer(tnn.Module):
    def __init__(self, cfg: SiglipVisionConfig, **fk):
        super().__init__()
        self.embeddings = VisionEmbeddings(cfg, **fk)
        self.encoder = Encoder(cfg.encoder, **fk)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, **fk)
        self.head = MAPHead(cfg, **fk)


class SiglipVisionTower(tnn.Module):
    """``vision_model`` of an HF ``SiglipModel``: stage 1 and serving."""

    def __init__(self, cfg: SiglipConfig, *, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.vision_model = VisionTransformer(cfg.vision, device=device, dtype=dtype)


class TextEmbeddings(tnn.Module):
    def __init__(self, cfg: SiglipTextConfig, **fk):
        super().__init__()
        self.token_embedding = _Table((cfg.vocab_size, cfg.hidden_size), 0.02, **fk)
        self.position_embedding = _Table((cfg.max_position_embeddings, cfg.hidden_size),
                                         0.02, **fk)


class TextTransformer(tnn.Module):
    def __init__(self, cfg: SiglipTextConfig, **fk):
        super().__init__()
        self.embeddings = TextEmbeddings(cfg, **fk)
        self.encoder = Encoder(cfg.encoder, **fk)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, **fk)
        self.head = nn.Linear(cfg.hidden_size, cfg.projection_size, **fk)


class SiglipModel(tnn.Module):
    """The whole HF ``SiglipModel`` (``init_siglip``): stage 2, which
    fine-tunes and exports it, and the MMVP-VLM evaluation."""

    def __init__(self, cfg: SiglipConfig, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.vision_model = VisionTransformer(cfg.vision, **fk)
        self.text_model = TextTransformer(cfg.text, **fk)
        self.logit_scale = tnn.Parameter(torch.empty((), device=device,
                                                     dtype=dtype or torch.float32))
        self.logit_bias = tnn.Parameter(torch.empty((), device=device,
                                                    dtype=dtype or torch.float32))

    def init_(self, g):
        self.logit_scale.fill_(1.0)
        self.logit_bias.fill_(0.0)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

class _Proj:
    """A ``weight``/``bias`` pair that ``core.nn.linear`` reads."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor):
        self.weight, self.bias = weight, bias


class _HeadProjections:
    """The MAP head's attention as ``mha`` reads it: q, k and v the row
    thirds of ``in_proj_weight``/``in_proj_bias`` (never LoRA-wrapped: their
    key is not ``weight``), ``out_proj`` the module itself."""

    def __init__(self, p: HeadAttention):
        h = p.out_proj.weight.shape[0]
        w, b = p.in_proj_weight, p.in_proj_bias
        self.q_proj, self.k_proj, self.v_proj = (_Proj(w[i * h:(i + 1) * h], b[i * h:(i + 1) * h])
                                                 for i in range(3))
        self.out_proj = p.out_proj


def map_head(p: MAPHead, x: torch.Tensor, cfg: SiglipVisionConfig) -> torch.Tensor:
    """The probe attends over the tokens x [B, L, h] -> [B, h]
    (``_map_head``, ``siglip.py:196-215``)."""
    probe = p.probe.to(x.dtype).expand(x.shape[0], 1, cfg.hidden_size)
    out = mha(_HeadProjections(p.attention), probe, x, cfg.num_heads)
    res = out
    out = nn.layernorm(p.layernorm, out, eps=cfg.layer_norm_eps)
    act = nn.ACTIVATIONS[cfg.hidden_act]
    out = res + nn.linear(p.mlp.fc2, act(nn.linear(p.mlp.fc1, out)))
    return out[:, 0]


def vision_forward(p: VisionTransformer, pixel_values: torch.Tensor,
                   cfg: SiglipVisionConfig):
    """NHWC pixels -> (last_hidden_state [post-LN, all g*g tokens],
    pooler_output [B, h])."""
    pe = p.embeddings.patch_embedding
    x = torch.nn.functional.conv2d(pixel_values.permute(0, 3, 1, 2),
                                   pe.weight.to(pixel_values.dtype), stride=cfg.patch_size)
    x = x.flatten(2).transpose(1, 2)                    # [B, gh*gw, C]
    x = x + pe.bias.to(x.dtype)
    x = x + p.embeddings.position_embedding.weight.to(x.dtype)[None, : x.shape[1]]
    x = encoder_forward(p.encoder, x, cfg.encoder)
    x = nn.layernorm(p.post_layernorm, x, eps=cfg.layer_norm_eps)
    return x, map_head(p.head, x, cfg)


def text_forward(p: TextTransformer, input_ids: torch.Tensor, cfg: SiglipTextConfig,
                 attention_mask=None):
    """Returns (last_hidden_state, pooled = head(last[:, -1])); no causal
    mask; the activations take the embedding tables' dtype."""
    l = input_ids.shape[1]
    x = (p.embeddings.token_embedding.weight[input_ids]
         + p.embeddings.position_embedding.weight[None, :l])
    mask = (padding_mask(attention_mask.to(x.device), x.dtype)
            if attention_mask is not None else None)
    x = encoder_forward(p.encoder, x, cfg.encoder, mask)
    x = nn.layernorm(p.final_layer_norm, x, eps=cfg.layer_norm_eps)
    return x, nn.linear(p.head, x[:, -1])


def get_image_features(model, pixel_values: torch.Tensor, cfg: SiglipConfig) -> torch.Tensor:
    """NHWC pixels -> the MAP-pooled [B, h]; ``model``: a SiglipVisionTower or
    SiglipModel."""
    return vision_forward(model.vision_model, pixel_values, cfg.vision)[1]


def get_text_features(model: SiglipModel, input_ids: torch.Tensor, cfg: SiglipConfig,
                      attention_mask=None) -> torch.Tensor:
    return text_forward(model.text_model, input_ids, cfg.text, attention_mask)[1]


def siglip_logits(model: SiglipModel, input_ids, pixel_values, cfg: SiglipConfig,
                  attention_mask=None):
    """(logits_per_text [T, I], logits_per_image [I, T]) — modeling_siglip.py."""
    img = get_image_features(model, pixel_values, cfg)
    txt = get_text_features(model, input_ids, cfg, attention_mask)
    img = img / torch.linalg.norm(img, dim=-1, keepdim=True)
    txt = txt / torch.linalg.norm(txt, dim=-1, keepdim=True)
    logits_per_text = torch.exp(model.logit_scale) * txt @ img.T + model.logit_bias
    return logits_per_text, logits_per_text.T
