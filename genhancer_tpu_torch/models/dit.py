"""FLUX-style rectified-flow DiT (the lightweight GenHancer denoiser).

Port of ``genhancer_tpu/models/dit.py``, with its two hooks: ControlNet
residuals added to the img stream after each double block
(``models.controlnet``) and the IP-Adapter's
cross-attention residual after each block's own attention
(``models.ip_adapter``).  The module tree carries the reference
torch names (``double_blocks.{i}.img_attn.qkv.weight``, ``img_mlp.0`` ...,
``final_layer.adaLN_modulation.1``), so a ``checkpoint-dit-N.bin`` loads with
``load_state_dict(strict=True)``.  flux-dev: hidden 3072, 24 heads (D=128),
2 double + 4 single blocks, axes_dim [16, 56, 56], theta 10k.

Joint attention runs over [txt; img] — tokens and RoPE ids in that order —
through ``core.attention.attention`` (on CUDA the fused K1 kernel up to 600
tokens, RoPE and the flash kernel K5 beyond).

``remat=True`` wraps each double and single block in
``torch.utils.checkpoint.checkpoint`` (non-reentrant), as the JAX package
wraps them in ``jax.checkpoint`` (``dit.py:35-47, 276-280``); the backward
runs each block's forward again, inside the SwitchBack context the forward
ran in (``core.nn.int8_ctx_replay``).  ``remat_policy`` says what a block
keeps besides its inputs, read off ``jax.ad_checkpoint.
print_saved_residuals`` of the JAX block:

  * ``full``: nothing;
  * ``save_attn``: the attention output (JAX's ``checkpoint_name(...,
    "attn_out")``, here the ``genhancer::checkpoint_name`` op the block
    calls on it);
  * ``dots``: every matrix product without batch dimensions (JAX's
    ``dots_with_no_batch_dims_saveable``): the linears' ``aten.mm`` and,
    under SwitchBack, the int32 ``aten._int_mm``; attention's batched
    products are recomputed.

The two selective policies run under ``torch.utils.checkpoint``'s
selective-checkpoint contexts (``_policy_context``).  Under every policy
the attention kernel's residuals (q, k, v, o and the row log-sum-exp) are
not kept, so its forward (K1 or K5) runs again in the backward, as the
Pallas forward does in JAX's; so does K7 on the SwitchBack activations
(a Pallas call in JAX, no dot).

Tensor parallel (``parallel.tp``, ``parallel.layout.place`` sets the DiT's
``tp``): each rank holds the q, k and v rows of ``num_heads / tp`` heads
and ``1 / tp`` of each MLP, so the blocks split their projections at the
local widths and attention runs on the local heads; the linears do the
collectives (``core.nn.linear``).

Sequence parallel (an open ``parallel.ring.ring_scope`` on a seq axis of
n > 1 ranks): each rank keeps its contiguous chunk of the joint order
``[txt; img]`` padded to a multiple of n (``parallel.ring.token_layout``),
so the ring's chunks and their order are JAX's.  The prologue runs on the
rank's txt and img tokens (their RoPE rows the chunk's), the double blocks
apply each stream's weights to its part of the chunk, attention pads the
chunk and runs the ring, and the result is the velocity of the rank's img
tokens only (``Layout.img``), which is all the final layer sees.
"""

from __future__ import annotations

from dataclasses import dataclass
import contextlib
import threading
from typing import Optional, Sequence

import torch
from torch import nn as tnn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import tracing
from ..core import nn
from ..core.attention import attention
from ..core.rope import multi_axis_rope
from ..parallel import ring


REMAT_POLICIES = ("full", "save_attn", "dots")


@torch.library.custom_op("genhancer::checkpoint_name", mutates_args=())
def _checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """A copy of ``x`` that a remat policy can keep by ``name``."""
    return x.clone()


_checkpoint_name.register_autograd(lambda ctx, g: (g, None))

# the names a remat'd block tags while it runs (``_tagging``); none outside one
_TAGS = threading.local()


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """JAX's ``checkpoint_name``: inside a block run under a policy that
    keeps ``name``, ``x`` passes through the named op; elsewhere it is
    ``x`` itself (no copy)."""
    if name in getattr(_TAGS, "names", ()):
        return _checkpoint_name(x, name)
    return x


def _tagging(fn, names):
    """``fn`` run with ``names`` tagged: in the forward and in the recompute
    alike, so both see the same ops."""
    def run(*args):
        prev = getattr(_TAGS, "names", ())
        _TAGS.names = names
        try:
            return fn(*args)
        finally:
            _TAGS.names = prev
    return run


# ``dots``: the products with no batch dimensions (the linears; SwitchBack's
# int8 GEMM); ``save_attn``: the tagged attention output
_SAVED_OPS = {
    "save_attn": {torch.ops.genhancer.checkpoint_name.default},
    "dots": {torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
             torch.ops.aten._int_mm.default},
}


def _policy_context(policy: str):
    """The ``context_fn`` of a selective policy: its ops' outputs are kept,
    every other op recomputed."""
    keep = _SAVED_OPS[policy]

    def decide(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in keep else CheckpointPolicy.PREFER_RECOMPUTE

    return lambda: create_selective_checkpoint_contexts(decide)


@dataclass(frozen=True)
class DiTConfig:
    in_channels: int = 64
    vec_in_dim: int = 768
    context_in_dim: int = 4096
    hidden_size: int = 3072
    mlp_ratio: float = 4.0
    num_heads: int = 24
    depth: int = 2
    depth_single_blocks: int = 4
    axes_dim: tuple = (16, 56, 56)
    theta: int = 10_000
    qkv_bias: bool = True
    guidance_embed: bool = True

    def __post_init__(self):
        if self.hidden_size % self.num_heads:
            raise ValueError(
                f"hidden_size {self.hidden_size} not divisible by num_heads {self.num_heads}")
        if sum(self.axes_dim) != self.hidden_size // self.num_heads:
            raise ValueError(
                f"axes_dim {self.axes_dim} must sum to head_dim {self.hidden_size // self.num_heads}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def mlp_hidden(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)


DIT_CONFIGS = {
    "flux-dev": DiTConfig(guidance_embed=True),
    "flux-schnell": DiTConfig(guidance_embed=False),
    "flux-debug": DiTConfig(hidden_size=256, num_heads=8, axes_dim=(8, 12, 12),
                            guidance_embed=True),
}


# ---------------------------------------------------------------------------
# modules (parameters under the reference torch names)
# ---------------------------------------------------------------------------

class QKNorm(tnn.Module):
    def __init__(self, d, **fk):
        super().__init__()
        self.query_norm = nn.RMSNorm(d, **fk)
        self.key_norm = nn.RMSNorm(d, **fk)


class SelfAttention(tnn.Module):
    def __init__(self, h, d, qkv_bias, **fk):
        super().__init__()
        self.qkv = nn.Linear(h, 3 * h, bias=qkv_bias, **fk)
        self.norm = QKNorm(d, **fk)
        self.proj = nn.Linear(h, h, **fk)


def _mlp(h, mh, **fk) -> tnn.ModuleDict:
    return tnn.ModuleDict({"0": nn.Linear(h, mh, **fk), "2": nn.Linear(mh, h, **fk)})


class DoubleStreamBlock(tnn.Module):
    def __init__(self, cfg: DiTConfig, **fk):
        super().__init__()
        h, mh, d = cfg.hidden_size, cfg.mlp_hidden, cfg.head_dim
        for s in ("img", "txt"):
            self.add_module(f"{s}_mod", nn.Modulation(h, double=True, **fk))
            self.add_module(f"{s}_attn", SelfAttention(h, d, cfg.qkv_bias, **fk))
            self.add_module(f"{s}_mlp", _mlp(h, mh, **fk))


class SingleStreamBlock(tnn.Module):
    def __init__(self, cfg: DiTConfig, **fk):
        super().__init__()
        h, mh, d = cfg.hidden_size, cfg.mlp_hidden, cfg.head_dim
        self.linear1 = nn.Linear(h, 3 * h + mh, **fk)
        self.linear2 = nn.Linear(h + mh, h, **fk)
        self.norm = QKNorm(d, **fk)
        self.modulation = nn.Modulation(h, double=False, **fk)


class LastLayer(tnn.Module):
    def __init__(self, cfg: DiTConfig, **fk):
        super().__init__()
        h = cfg.hidden_size
        self.linear = nn.Linear(h, cfg.in_channels, **fk)
        self.adaLN_modulation = tnn.ModuleDict({"1": nn.Linear(h, 2 * h, **fk)})


class DiT(tnn.Module):
    """Parameter container of the DiT; ``dit_forward`` applies it."""

    def __init__(self, cfg: DiTConfig, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        h = cfg.hidden_size
        self.cfg = cfg
        self.img_in = nn.Linear(cfg.in_channels, h, **fk)
        self.time_in = nn.MLPEmbedder(256, h, **fk)
        self.vector_in = nn.MLPEmbedder(cfg.vec_in_dim, h, **fk)
        self.txt_in = nn.Linear(cfg.context_in_dim, h, **fk)
        self.double_blocks = tnn.ModuleList(
            DoubleStreamBlock(cfg, **fk) for _ in range(cfg.depth))
        self.single_blocks = tnn.ModuleList(
            SingleStreamBlock(cfg, **fk) for _ in range(cfg.depth_single_blocks))
        self.final_layer = LastLayer(cfg, **fk)
        if cfg.guidance_embed:
            self.guidance_in = nn.MLPEmbedder(256, h, **fk)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _split_qkv(qkv: torch.Tensor, num_heads: int):
    """[B, L, 3*H*D] -> three [B, L, H, D] views (K-major packing)."""
    b, l, three_hd = qkv.shape
    hd = three_hd // 3
    d = hd // num_heads
    q, k, v = qkv.split(hd, dim=-1)
    return (q.reshape(b, l, num_heads, d), k.reshape(b, l, num_heads, d),
            v.reshape(b, l, num_heads, d))


def _qk_norm(norm: QKNorm, q, k, v):
    q = nn.rmsnorm(norm.query_norm, q).to(v.dtype)
    k = nn.rmsnorm(norm.key_norm, k).to(v.dtype)
    return q, k


def _ip_residual(ip, q):
    """``ip_scale * ip_attention(...)`` of a block's ``ip`` triple
    (block IP module, projected tokens, scale), the scale rounded to q's
    dtype as JAX rounds the weakly-typed constant."""
    from .ip_adapter import ip_attention
    block_ip, image_proj, ip_scale = ip
    return nn.as_dtype_scalar(ip_scale, q.dtype) * ip_attention(block_ip, q, image_proj,
                                                                q.shape[2])


def _double_block(p: DoubleStreamBlock, img, txt, vec, cos, sin, num_heads, ip=None):
    """DoubleStreamBlockProcessor; with ``ip`` = (block IP module,
    image_proj, ip_scale) the IP residual of the img-stream queries is added
    to the img stream at the block's end (``dit.py:172-230``)."""
    (img_m1, img_m2) = nn.modulation(p.img_mod, vec)
    (txt_m1, txt_m2) = nn.modulation(p.txt_mod, vec)

    img_mod = nn.layernorm(None, img)
    img_mod = (1 + img_m1[1]) * img_mod + img_m1[0]
    iq, ik, iv = _split_qkv(nn.linear(p.img_attn.qkv, img_mod), num_heads)
    iq, ik = _qk_norm(p.img_attn.norm, iq, ik, iv)

    txt_mod = nn.layernorm(None, txt)
    txt_mod = (1 + txt_m1[1]) * txt_mod + txt_m1[0]
    tq, tk, tv = _split_qkv(nn.linear(p.txt_attn.qkv, txt_mod), num_heads)
    tq, tk = _qk_norm(p.txt_attn.norm, tq, tk, tv)

    # joint attention over [txt; img]
    q = torch.cat([tq, iq], dim=1)
    k = torch.cat([tk, ik], dim=1)
    v = torch.cat([tv, iv], dim=1)
    attn_out = checkpoint_name(attention(q, k, v, cos, sin), "attn_out")
    txt_len = txt.shape[1]
    txt_attn, img_attn = attn_out[:, :txt_len], attn_out[:, txt_len:]

    img = img + img_m1[2] * nn.linear(p.img_attn.proj, img_attn)
    img_h = (1 + img_m2[1]) * nn.layernorm(None, img) + img_m2[0]
    img = img + img_m2[2] * nn.linear(p.img_mlp["2"],
                                      nn.gelu_tanh(nn.linear(p.img_mlp["0"], img_h)))

    txt = txt + txt_m1[2] * nn.linear(p.txt_attn.proj, txt_attn)
    txt_h = (1 + txt_m2[1]) * nn.layernorm(None, txt) + txt_m2[0]
    txt = txt + txt_m2[2] * nn.linear(p.txt_mlp["2"],
                                      nn.gelu_tanh(nn.linear(p.txt_mlp["0"], txt_h)))
    if ip is not None:
        img = img + _ip_residual(ip, iq)
    return img, txt


def _single_block(p: SingleStreamBlock, x, vec, cos, sin, num_heads, hidden_size, ip=None):
    """SingleStreamBlockProcessor; ``ip`` adds the IP residual of the whole
    joint sequence's queries to the attention output."""
    (mod,) = nn.modulation(p.modulation, vec)
    x_mod = (1 + mod[1]) * nn.layernorm(None, x) + mod[0]
    lin1 = nn.linear(p.linear1, x_mod)
    qkv, mlp = lin1[..., : 3 * hidden_size], lin1[..., 3 * hidden_size:]
    q, k, v = _split_qkv(qkv, num_heads)
    q, k = _qk_norm(p.norm, q, k, v)
    attn_out = checkpoint_name(attention(q, k, v, cos, sin), "attn_out")
    if ip is not None:
        attn_out = attn_out + _ip_residual(ip, q)
    out = nn.linear(p.linear2, torch.cat([attn_out, nn.gelu_tanh(mlp)], dim=-1))
    return x + mod[2] * out


def embed_inputs(p, cfg: DiTConfig, img, img_ids, txt, txt_ids, timesteps, y, guidance):
    """The prologue a DiT shares with a ControlNet (``p`` holds ``img_in``,
    ``time_in``, ``vector_in``, ``txt_in`` and, for a dev model,
    ``guidance_in``): (img, txt, vec, cos, sin) — the embedded streams, the
    modulation vector in img's dtype, the RoPE tables of [txt; img]."""
    compute_dtype = img.dtype
    img = nn.linear(p.img_in, img)
    vec = nn.mlp_embedder(p.time_in,
                          nn.timestep_embedding(timesteps, 256).to(compute_dtype))
    if cfg.guidance_embed:
        if guidance is None:
            raise ValueError("guidance required for guidance-embedded (dev) model")
        vec = vec + nn.mlp_embedder(p.guidance_in,
                                    nn.timestep_embedding(guidance, 256).to(compute_dtype))
    vec = vec + nn.mlp_embedder(p.vector_in, y.to(compute_dtype))
    txt = nn.linear(p.txt_in, txt)
    cos, sin = multi_axis_rope(torch.cat([txt_ids, img_ids], dim=1), cfg.axes_dim, cfg.theta)
    return img, txt, vec, cos, sin


def dit_forward(p: DiT, cfg: DiTConfig, *,
                img: torch.Tensor, img_ids: torch.Tensor,
                txt: torch.Tensor, txt_ids: torch.Tensor,
                timesteps: torch.Tensor, y: torch.Tensor,
                guidance: Optional[torch.Tensor] = None,
                remat: bool = False, remat_policy: Optional[str] = None,
                image_proj: Optional[torch.Tensor] = None, ip_params=None,
                ip_scale: float = 1.0,
                controlnet_residuals: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
    """img: [B, L_img, 64] packed latent tokens; txt: [B, L_txt, 4096];
    ids: [B, L, 3]; timesteps/guidance: [B]; y: [B, vec_in_dim].
    Returns velocity tokens [B, L_img, 64] in img's dtype.

    ``controlnet_residuals``: [B, L_img, hidden] tensors
    (``controlnet.controlnet_forward``); after double block i the img stream
    adds ``res[i % len(res)]`` in its dtype (``dit.py:292-295``).
    ``image_proj`` with ``ip_params`` (an ``ip_adapter.IPAdapter``): IP
    tokens [B, N, ctx], or a raw image embedding [B, clip_dim] that
    ``image_proj_model`` projects first, cast to img's dtype; each block
    adds ``ip_scale`` times its IP cross-attention.  Under an open ring
    scope the result holds the rank's img tokens only (``Layout.img``)."""
    if img.ndim != 3 or txt.ndim != 3:
        raise ValueError("img and txt must be 3-D [B, L, C]")
    with tracing.span(tracing.DIT_FORWARD):
        tp = getattr(p, "tp", 1)
        heads, hidden = cfg.num_heads // tp, cfg.hidden_size // tp    # the rank's widths
        layout, scope = None, contextlib.nullcontext()
        axis = ring.active_scope()
        if axis is not None:
            # the rank's chunk of [txt; img]: its tokens of each stream
            layout = ring.token_layout(txt.shape[1], img.shape[1], axis)
            img, img_ids = img[:, layout.img], img_ids[:, layout.img]
            txt, txt_ids = txt[:, layout.txt], txt_ids[:, layout.txt]
            if controlnet_residuals is not None:
                controlnet_residuals = [r[:, layout.img] for r in controlnet_residuals]
            scope = ring.layout_scope(layout)
        img, txt, vec, cos, sin = embed_inputs(p, cfg, img, img_ids, txt, txt_ids, timesteps, y,
                                               guidance)
        with scope:
            return _blocks_and_head(p, cfg, img, txt, vec, cos, sin, heads, hidden, remat,
                                    remat_policy, image_proj, ip_params, ip_scale,
                                    controlnet_residuals)


def _blocks_and_head(p: DiT, cfg: DiTConfig, img, txt, vec, cos, sin, heads, hidden,
                     remat, remat_policy, image_proj, ip_params, ip_scale,
                     controlnet_residuals):
    """The block stack and the final layer of ``dit_forward``."""
    compute_dtype = img.dtype
    dblock, sblock = block_fns(remat, remat_policy)
    use_ip = image_proj is not None and ip_params is not None
    if use_ip:
        if image_proj.ndim == 2:            # a raw image embedding: project it
            from .ip_adapter import image_proj_model
            image_proj = image_proj_model(ip_params.image_proj_model, image_proj)
        image_proj = image_proj.to(compute_dtype)

    for i, blk in enumerate(p.double_blocks):
        ip = (ip_params.ip_double[i], image_proj, ip_scale) if use_ip else None
        with tracing.span(tracing.DIT_DOUBLE, index=i):
            img, txt = dblock(blk, img, txt, vec, cos, sin, heads, ip)
        if controlnet_residuals is not None:
            img = img + controlnet_residuals[i % len(controlnet_residuals)].to(img.dtype)

    x = torch.cat([txt, img], dim=1)
    for i, blk in enumerate(p.single_blocks):
        ip = (ip_params.ip_single[i], image_proj, ip_scale) if use_ip else None
        with tracing.span(tracing.DIT_SINGLE, index=i):
            x = sblock(blk, x, vec, cos, sin, heads, hidden, ip)
    img = x[:, txt.shape[1]:]

    return final_layer(p, img, vec)


def final_layer(p: DiT, img: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """LastLayer: adaLN modulation from ``vec``, then the output linear."""
    fl = p.final_layer
    sm = nn.linear(fl.adaLN_modulation["1"], nn.silu(vec))
    shift, scale = sm.chunk(2, dim=-1)
    img = (1 + scale[:, None, :]) * nn.layernorm(None, img) + shift[:, None, :]
    return nn.linear(fl.linear, img)


def block_fns(remat: bool, remat_policy: Optional[str] = None):
    """(double block, single block) callables: the plain functions, or with
    ``remat`` each under ``torch.utils.checkpoint`` (non-reentrant) with
    ``remat_policy`` (None: ``full``), whose recompute in the backward runs
    again in the SwitchBack context and the ring state of the forward
    (``core.nn.int8_ctx_replay``, ``parallel.ring.replay``)."""
    if not remat:
        return _double_block, _single_block
    policy = remat_policy or "full"
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, got {policy!r}")
    kw = {}
    d_fn, s_fn = _double_block, _single_block
    if policy != "full":
        kw["context_fn"] = _policy_context(policy)
        if policy == "save_attn":
            d_fn, s_fn = _tagging(d_fn, ("attn_out",)), _tagging(s_fn, ("attn_out",))
    d_fn = ring.replay(nn.int8_ctx_replay(d_fn))
    s_fn = ring.replay(nn.int8_ctx_replay(s_fn))

    def dblock(*a):
        return checkpoint(d_fn, *a, use_reentrant=False, **kw)

    def sblock(*a):
        return checkpoint(s_fn, *a, use_reentrant=False, **kw)

    return dblock, sblock


def pack_latent(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] latent (NHWC) -> [B, (H/2)(W/2), C*4] tokens, channel
    order (c, ph, pw) as the reference's 'b c (h ph) (w pw) -> b (h w) (c ph pw)'."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)      # (b, h2, ph, w2, pw, c)
    x = x.permute(0, 1, 3, 5, 2, 4)                # (b, h2, w2, c, ph, pw)
    return x.reshape(b, (h // 2) * (w // 2), c * 4)


def unpack_latent(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, (h/2)(w/2), C*4] tokens -> [B, h, w, C] NHWC latent."""
    b, l, c4 = x.shape
    c = c4 // 4
    x = x.reshape(b, h // 2, w // 2, c, 2, 2)
    x = x.permute(0, 1, 4, 2, 5, 3)                # b, h/2, ph, w/2, pw, c
    return x.reshape(b, h, w, c)
