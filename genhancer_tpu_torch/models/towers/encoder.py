"""Pre-LN ViT / text encoder shared by the CLIP-family and SigLIP towers.

Port of ``genhancer_tpu/models/towers/encoder.py``.  A LoRA-wrapped
projection adds its branch inside ``core.nn.linear``, so q, k and v stay
separate products as in the JAX package's LoRA path.  Module names follow
the HF ``CLIPEncoderLayer`` state dict (``layers.{i}.self_attn.q_proj`` ...).

Unmasked self-attention (the vision sides, SigLIP's text side) goes through
``core.attention.sdpa_auto`` — on CUDA the fused K2 kernel up to 600
tokens, the flash kernel K5 above (the SigLIP-384 tower's 729); masked
attention (CLIP's text side: ``causal_mask`` + ``padding_mask``) and
cross-attention (the SigLIP head's probe) are JAX's einsum path outside any
kernel: float32 logits plus the additive mask, softmax, probabilities cast
to the input dtype, float32-accumulated PV.

``tower_remat_scope`` (``encoder.py:36-46,149-155``): inside it, under
autograd, each encoder layer runs under ``torch.utils.checkpoint`` (non-
reentrant): only the layer's input survives to the backward, which runs the
layer again — with the LoRA dropout masks of its first run
(``core.nn.lora_dropout_replay``).
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn as tnn
from torch.utils.checkpoint import checkpoint

from ...core import nn
from ...core.attention import sdpa_auto

# set inside tower_remat_scope: the stage-2 loss opens it when
# ``spec.tower_remat``
_TOWER_REMAT: contextvars.ContextVar = contextvars.ContextVar("tower_remat", default=False)


@contextlib.contextmanager
def tower_remat_scope(enable: bool = True):
    tok = _TOWER_REMAT.set(bool(enable))
    try:
        yield
    finally:
        _TOWER_REMAT.reset(tok)


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


def mha(p, x_q: torch.Tensor, x_kv: torch.Tensor, num_heads: int,
        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head attention (``encoder.py:106-133``); x_q: [B, Lq, H], x_kv:
    [B, Lk, H]; ``p`` holds ``q_proj``, ``k_proj``, ``v_proj`` and
    ``out_proj``; ``mask`` additive, [B, 1, Lq, Lk] or broadcastable (0
    where attended), or None.  Unmasked self-attention (Lq == Lk) goes to
    ``sdpa_auto`` (K2 up to 600 tokens, K5 above); the SigLIP head's probe
    (Lq = 1) and masked calls take the einsum path."""
    b, lq, h = x_q.shape
    lk = x_kv.shape[1]
    d = h // num_heads
    q = nn.linear(p.q_proj, x_q).reshape(b, lq, num_heads, d)
    k = nn.linear(p.k_proj, x_kv).reshape(b, lk, num_heads, d)
    v = nn.linear(p.v_proj, x_kv).reshape(b, lk, num_heads, d)
    if mask is None and lq == lk:
        out = sdpa_auto(q, k, v)
    else:
        f32 = torch.float32
        logits = torch.einsum("blhd,bmhd->bhlm", q.to(f32), k.to(f32)) * (d ** -0.5)
        if mask is not None:
            logits = logits + mask.to(f32)
        probs = torch.softmax(logits, dim=-1).to(x_q.dtype)
        out = torch.einsum("bhlm,bmhd->blhd", probs.to(f32), v.to(f32)).to(x_q.dtype)
    return nn.linear(p.out_proj, out.reshape(b, lq, h))


def encoder_layer(p: EncoderLayer, x: torch.Tensor, cfg: EncoderConfig,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    act = nn.ACTIVATIONS[cfg.hidden_act]
    res = x
    x = nn.layernorm(p.layer_norm1, x, eps=cfg.layer_norm_eps)
    x = res + mha(p.self_attn, x, x, cfg.num_heads, mask)
    res = x
    x = nn.layernorm(p.layer_norm2, x, eps=cfg.layer_norm_eps)
    return res + nn.linear(p.mlp.fc2, act(nn.linear(p.mlp.fc1, x)))


def encoder_forward(p: Encoder, x: torch.Tensor, cfg: EncoderConfig,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    remat = _TOWER_REMAT.get() and torch.is_grad_enabled()
    for lp in p.layers:
        if remat:
            # the layer draws from no global RNG: the replay restores the
            # LoRA dropout generator itself
            x = checkpoint(nn.lora_dropout_replay(encoder_layer), lp, x, cfg, mask,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = encoder_layer(lp, x, cfg, mask)
    return x


def causal_mask(length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """[1, 1, L, L] additive causal mask (CLIP text): float32's finfo.min
    above the diagonal, cast to ``dtype``."""
    m = torch.triu(torch.full((length, length), torch.finfo(torch.float32).min,
                              device=device), diagonal=1)
    return m[None, None].to(dtype)


def padding_mask(attention_mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[B, L] 1/0 -> additive [B, 1, 1, L]."""
    inv = (1.0 - attention_mask.to(torch.float32)) * torch.finfo(torch.float32).min
    return inv[:, None, None, :].to(dtype)
