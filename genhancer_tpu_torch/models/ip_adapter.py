"""IP-Adapter conditioning for the DiT.

Port of ``genhancer_tpu/models/ip_adapter.py`` (the reference's
``ImageProjModel`` and IP block processors, ``src/flux/modules/
layers.py:221-301,391-455,574-595``): ``ImageProjModel`` maps a CLIP image
embedding [B, 1024] to ``num_tokens`` context tokens [B, 4, 4096]; each
double block has k/v projections (with biases) and each single block k/v
projections (without) from the context width to the DiT's hidden width,
zero at init, so an adapter at init adds nothing.  ``models.dit.dit_forward``
takes ``image_proj``/``ip_params``/``ip_scale`` and adds ``ip_scale *
ip_attention(...)`` after each block's own attention.

The IP cross-attention attends L queries to N = 4 keys.  No TPU kernel
computes it (the JAX package runs it through ``sdpa``, which is XLA's einsum
on every path its tests run), so it is the plain ``core.attention.sdpa_ref``
on every device here, not a kernel's plain version: K5 takes k/v of q's
length and K1/K2 a joint sequence.
"""

from __future__ import annotations

import torch
from torch import nn as tnn

from ..core import nn
from ..core.attention import sdpa_ref


class ImageProjModel(tnn.Module):
    """``proj`` [clip_dim -> num_tokens * ctx] and a LayerNorm over ctx."""

    def __init__(self, clip_embeddings_dim: int = 1024, cross_attention_dim: int = 4096,
                 num_tokens: int = 4, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.num_tokens = num_tokens
        self.cross_attention_dim = cross_attention_dim
        self.proj = nn.Linear(clip_embeddings_dim, num_tokens * cross_attention_dim, **fk)
        self.norm = nn.LayerNorm(cross_attention_dim, **fk)


def image_proj_model(p: ImageProjModel, image_embeds: torch.Tensor) -> torch.Tensor:
    """[B, clip_dim] -> [B, num_tokens, cross_attention_dim]
    (``layers.py:588-594``; LayerNorm eps 1e-5)."""
    tokens = nn.linear(p.proj, image_embeds).reshape(-1, p.num_tokens,
                                                     p.cross_attention_dim)
    return nn.layernorm(p.norm, tokens, eps=1e-5)


class IPBlock(tnn.Module):
    def __init__(self, context_dim: int, hidden: int, bias: bool, **fk):
        super().__init__()
        self.k_proj = nn.ZeroLinear(context_dim, hidden, bias=bias, **fk)
        self.v_proj = nn.ZeroLinear(context_dim, hidden, bias=bias, **fk)


class IPAdapter(tnn.Module):
    """``init_ip_params``'s tree: ``image_proj_model``, ``ip_double.{i}``
    (k/v with biases) and ``ip_single.{i}`` (k/v without)."""

    def __init__(self, cfg, context_dim: int = 4096, clip_embeddings_dim: int = 1024,
                 num_tokens: int = 4, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        h = cfg.hidden_size
        self.image_proj_model = ImageProjModel(clip_embeddings_dim, context_dim, num_tokens,
                                               **fk)
        self.ip_double = tnn.ModuleList(IPBlock(context_dim, h, True, **fk)
                                        for _ in range(cfg.depth))
        self.ip_single = tnn.ModuleList(IPBlock(context_dim, h, False, **fk)
                                        for _ in range(cfg.depth_single_blocks))


def init_image_proj_model(generator: torch.Generator, clip_embeddings_dim: int = 1024,
                          cross_attention_dim: int = 4096, num_tokens: int = 4,
                          device=None) -> ImageProjModel:
    return nn.init_weights(ImageProjModel(clip_embeddings_dim, cross_attention_dim,
                                          num_tokens, device=device), generator)


def init_ip_params(generator: torch.Generator, cfg, context_dim: int = 4096,
                   clip_embeddings_dim: int = 1024, num_tokens: int = 4,
                   device=None) -> IPAdapter:
    """cfg: ``dit.DiTConfig``.  The projection model is drawn from
    ``generator``; every k/v projection starts at zero
    (``layers.py:239-243``)."""
    return nn.init_weights(IPAdapter(cfg, context_dim, clip_embeddings_dim, num_tokens,
                                     device=device), generator)


def ip_attention(block_ip: IPBlock, q: torch.Tensor, image_proj: torch.Tensor,
                 num_heads: int) -> torch.Tensor:
    """Cross-attend queries [B, L, H, D] to the projected IP tokens
    [B, N, ctx]; returns [B, L, H*D] in q's dtype (``layers.py:280-299``)."""
    b, n, _ = image_proj.shape
    h, d = q.shape[2], q.shape[3]
    ip_k = nn.linear(block_ip.k_proj, image_proj).reshape(b, n, h, d)
    ip_v = nn.linear(block_ip.v_proj, image_proj).reshape(b, n, h, d)
    return sdpa_ref(q, ip_k, ip_v).reshape(b, q.shape[1], h * d)
