"""ControlNet for the FLUX-style DiT (a conditioning-residual side network).

Port of ``genhancer_tpu/models/controlnet.py``: a trunk of ``depth``
double-stream blocks of the DiT's own shape, behind the DiT's embedding
prologue (``img_in``, ``time_in``, ``vector_in``, ``txt_in``,
``guidance_in``).  The conditioning image enters as packed VAE-latent tokens
through ``cond_in`` and each block's img stream leaves through its own
``controlnet_blocks.{i}`` projection; both start at zero, so an untrained
ControlNet adds nothing to the DiT (the zero-conv property of
arXiv:2302.05543).  ``models.dit.dit_forward`` adds ``res[i % depth]`` after
its double block i.

The trunk's joint [txt; img] attention is the DiT's (``core.attention.
attention``: K1 up to 600 tokens on CUDA, RoPE and K5 beyond).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn as tnn

from ..core import nn
from .dit import DiT, DiTConfig, DoubleStreamBlock, _double_block, embed_inputs

# the embedding prologue a ControlNet shares with the DiT it is seeded from
PROLOGUE = ("img_in", "time_in", "vector_in", "txt_in", "guidance_in")


class ControlNet(tnn.Module):
    """``init_controlnet``'s tree under the DiT's torch names
    (``double_blocks.{i}.img_attn.qkv.weight`` ...)."""

    def __init__(self, cfg: DiTConfig, depth: int = 2, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        h = cfg.hidden_size
        self.cfg, self.depth = cfg, depth
        self.img_in = nn.Linear(cfg.in_channels, h, **fk)
        self.time_in = nn.MLPEmbedder(256, h, **fk)
        self.vector_in = nn.MLPEmbedder(cfg.vec_in_dim, h, **fk)
        self.txt_in = nn.Linear(cfg.context_in_dim, h, **fk)
        self.cond_in = nn.ZeroLinear(cfg.in_channels, h, **fk)
        self.double_blocks = tnn.ModuleList(DoubleStreamBlock(cfg, **fk) for _ in range(depth))
        self.controlnet_blocks = tnn.ModuleList(nn.ZeroLinear(h, h, **fk) for _ in range(depth))
        if cfg.guidance_embed:
            self.guidance_in = nn.MLPEmbedder(256, h, **fk)


def init_controlnet(generator: torch.Generator, cfg: DiTConfig, depth: int = 2,
                    device=None, dtype=None) -> ControlNet:
    """A fresh ControlNet: the prologue and trunk drawn from ``generator``,
    ``cond_in`` and ``controlnet_blocks`` at zero."""
    return nn.init_weights(ControlNet(cfg, depth, device=device, dtype=dtype), generator)


@torch.no_grad()
def init_controlnet_from_dit(generator: torch.Generator, dit: DiT, cfg: DiTConfig,
                             depth: int = 2, device=None, dtype=None) -> ControlNet:
    """The trainable-copy init: the DiT's prologue and its double blocks
    ``i % n`` (cycling where the ControlNet is deeper) copied into a fresh
    ControlNet, whose zero projections keep the composition a no-op."""
    cn = init_controlnet(generator, cfg, depth, device=device, dtype=dtype)
    for name in PROLOGUE:
        if hasattr(dit, name):
            getattr(cn, name).load_state_dict(getattr(dit, name).state_dict())
    n = len(dit.double_blocks)
    for i, blk in enumerate(cn.double_blocks):
        blk.load_state_dict(dit.double_blocks[i % n].state_dict())
    return cn


def controlnet_forward(p: ControlNet, cfg: DiTConfig, *,
                       img: torch.Tensor, img_ids: torch.Tensor,
                       txt: torch.Tensor, txt_ids: torch.Tensor,
                       timesteps: torch.Tensor, y: torch.Tensor,
                       controlnet_cond: torch.Tensor,
                       guidance: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """Residuals for the DiT's double blocks: one [B, L_img, hidden] tensor
    per ControlNet block.  ``img``: [B, L_img, 64] packed noisy-latent
    tokens; ``controlnet_cond``: the conditioning image's packed VAE-latent
    tokens of the same shape; the rest as in ``dit.dit_forward``."""
    if controlnet_cond.shape != img.shape:
        raise ValueError(f"controlnet_cond {tuple(controlnet_cond.shape)} must match packed "
                         f"img tokens {tuple(img.shape)}")
    cond = controlnet_cond.to(img.dtype)
    img, txt, vec, cos, sin = embed_inputs(p, cfg, img, img_ids, txt, txt_ids, timesteps, y,
                                           guidance)
    img = img + nn.linear(p.cond_in, cond)
    residuals = []
    for blk, out_p in zip(p.double_blocks, p.controlnet_blocks):
        img, txt = _double_block(blk, img, txt, vec, cos, sin, cfg.num_heads)
        residuals.append(nn.linear(out_p, img))
    return tuple(residuals)
