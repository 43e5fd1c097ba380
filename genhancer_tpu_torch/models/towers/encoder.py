"""Pre-LN ViT encoder shared by the CLIP-family towers.

Port of ``genhancer_tpu/models/towers/encoder.py`` (the unmasked vision
path, no remat; a LoRA-wrapped projection adds its branch inside
``core.nn.linear``, so q, k and v stay separate products as in the JAX
package's LoRA path).  Module names follow the HF
``CLIPEncoderLayer`` state dict (``layers.{i}.self_attn.q_proj`` ...).
Unmasked self-attention goes through ``core.attention.sdpa_auto`` — the
fused K2 kernel on CUDA.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn as tnn

from ...core import nn
from ...core.attention import sdpa_auto


@dataclass(frozen=True)
class EncoderConfig:
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"


class Attention(tnn.Module):
    def __init__(self, h, **fk):
        super().__init__()
        self.q_proj = nn.Linear(h, h, **fk)
        self.k_proj = nn.Linear(h, h, **fk)
        self.v_proj = nn.Linear(h, h, **fk)
        self.out_proj = nn.Linear(h, h, **fk)


class MLP(tnn.Module):
    def __init__(self, h, i, **fk):
        super().__init__()
        self.fc1 = nn.Linear(h, i, **fk)
        self.fc2 = nn.Linear(i, h, **fk)


class EncoderLayer(tnn.Module):
    def __init__(self, cfg: EncoderConfig, **fk):
        super().__init__()
        h = cfg.hidden_size
        self.layer_norm1 = nn.LayerNorm(h, **fk)
        self.self_attn = Attention(h, **fk)
        self.layer_norm2 = nn.LayerNorm(h, **fk)
        self.mlp = MLP(h, cfg.intermediate_size, **fk)


class Encoder(tnn.Module):
    def __init__(self, cfg: EncoderConfig, **fk):
        super().__init__()
        self.layers = tnn.ModuleList(EncoderLayer(cfg, **fk)
                                     for _ in range(cfg.num_layers))


def mha(p: Attention, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Unmasked multi-head self-attention; x: [B, L, H]."""
    b, l, h = x.shape
    d = h // num_heads
    q = nn.linear(p.q_proj, x).reshape(b, l, num_heads, d)
    k = nn.linear(p.k_proj, x).reshape(b, l, num_heads, d)
    v = nn.linear(p.v_proj, x).reshape(b, l, num_heads, d)
    out = sdpa_auto(q, k, v)
    return nn.linear(p.out_proj, out.reshape(b, l, h))


def encoder_layer(p: EncoderLayer, x: torch.Tensor, cfg: EncoderConfig) -> torch.Tensor:
    act = nn.ACTIVATIONS[cfg.hidden_act]
    res = x
    x = nn.layernorm(p.layer_norm1, x, eps=cfg.layer_norm_eps)
    x = res + mha(p.self_attn, x, cfg.num_heads)
    res = x
    x = nn.layernorm(p.layer_norm2, x, eps=cfg.layer_norm_eps)
    return res + nn.linear(p.mlp.fc2, act(nn.linear(p.mlp.fc1, x)))


def encoder_forward(p: Encoder, x: torch.Tensor, cfg: EncoderConfig) -> torch.Tensor:
    for lp in p.layers:
        x = encoder_layer(lp, x, cfg)
    return x
