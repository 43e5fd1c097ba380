"""FLUX.1-dev autoencoder (f8, z=16).

Port of ``genhancer_tpu/models/vae.py``: ch=128, ch_mult=[1,2,4,4], 2
ResnetBlocks per level, mid Res+Attn+Res, GroupNorm(32) + swish, Downsample
via asymmetric (0,1,0,1) pad + stride-2 conv, Upsample via 2x nearest +
conv, latent ``scale_factor * (z - shift_factor)``.  Module names follow
``ae.safetensors`` (``encoder.down.{i}.block.{j}.conv1.weight`` ...).

The public functions take and return NHWC, as the JAX ones do; inside, the
convolutions run NCHW, PyTorch's layout.  The VAE computes in float32; its
mid-block attention is the plain ``sdpa_ref`` on every device, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn as tnn

from .. import tracing
from ..core import nn
from ..core.attention import sdpa_ref
from ..parallel.mesh import randn_rows


@dataclass(frozen=True)
class VAEConfig:
    resolution: int = 256
    in_channels: int = 3
    ch: int = 128
    out_ch: int = 3
    ch_mult: tuple = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 16
    scale_factor: float = 0.3611
    shift_factor: float = 0.1159


VAE_CONFIGS = {
    "flux-dev": VAEConfig(),
    "flux-schnell": VAEConfig(),
    "flux-debug": VAEConfig(ch=32),
}


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class ResnetBlock(tnn.Module):
    def __init__(self, cin, cout, **fk):
        super().__init__()
        self.norm1 = nn.GroupNorm(cin, **fk)
        self.conv1 = nn.Conv2d(cin, cout, 3, **fk)
        self.norm2 = nn.GroupNorm(cout, **fk)
        self.conv2 = nn.Conv2d(cout, cout, 3, **fk)
        if cin != cout:
            self.nin_shortcut = nn.Conv2d(cin, cout, 1, **fk)


class AttnBlock(tnn.Module):
    def __init__(self, c, **fk):
        super().__init__()
        self.norm = nn.GroupNorm(c, **fk)
        self.q = nn.Conv2d(c, c, 1, **fk)
        self.k = nn.Conv2d(c, c, 1, **fk)
        self.v = nn.Conv2d(c, c, 1, **fk)
        self.proj_out = nn.Conv2d(c, c, 1, **fk)


class _Resample(tnn.Module):
    def __init__(self, c, **fk):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, **fk)


class _Mid(tnn.Module):
    def __init__(self, c, **fk):
        super().__init__()
        self.block_1 = ResnetBlock(c, c, **fk)
        self.attn_1 = AttnBlock(c, **fk)
        self.block_2 = ResnetBlock(c, c, **fk)


class _Level(tnn.Module):
    def __init__(self, blocks, resample: Optional[str], c, **fk):
        super().__init__()
        self.block = tnn.ModuleList(blocks)
        if resample is not None:
            self.add_module(resample, _Resample(c, **fk))


class Encoder(tnn.Module):
    def __init__(self, cfg: VAEConfig, **fk):
        super().__init__()
        n_levels = len(cfg.ch_mult)
        in_mult = (1,) + tuple(cfg.ch_mult)
        self.conv_in = nn.Conv2d(cfg.in_channels, cfg.ch, 3, **fk)
        levels = []
        for i in range(n_levels):
            cin, cout = cfg.ch * in_mult[i], cfg.ch * cfg.ch_mult[i]
            blocks = []
            for _ in range(cfg.num_res_blocks):
                blocks.append(ResnetBlock(cin, cout, **fk))
                cin = cout
            levels.append(_Level(blocks, "downsample" if i != n_levels - 1 else None,
                                 cout, **fk))
        self.down = tnn.ModuleList(levels)
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.mid = _Mid(block_in, **fk)
        self.norm_out = nn.GroupNorm(block_in, **fk)
        self.conv_out = nn.Conv2d(block_in, 2 * cfg.z_channels, 3, **fk)


class Decoder(tnn.Module):
    def __init__(self, cfg: VAEConfig, **fk):
        super().__init__()
        n_levels = len(cfg.ch_mult)
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = nn.Conv2d(cfg.z_channels, block_in, 3, **fk)
        self.mid = _Mid(block_in, **fk)
        up = [None] * n_levels
        cin = block_in
        for i in reversed(range(n_levels)):
            cout = cfg.ch * cfg.ch_mult[i]
            blocks = []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(ResnetBlock(cin, cout, **fk))
                cin = cout
            up[i] = _Level(blocks, "upsample" if i != 0 else None, cout, **fk)
        self.up = tnn.ModuleList(up)
        self.norm_out = nn.GroupNorm(cin, **fk)
        self.conv_out = nn.Conv2d(cin, cfg.out_ch, 3, **fk)


class AutoEncoder(tnn.Module):
    def __init__(self, cfg: VAEConfig, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.encoder = Encoder(cfg, **fk)
        self.decoder = Decoder(cfg, **fk)


# ---------------------------------------------------------------------------
# forward (NCHW inside)
# ---------------------------------------------------------------------------

def _resnet(p: ResnetBlock, x):
    h = nn.conv2d(p.conv1, swish(nn.groupnorm(p.norm1, x)))
    h = nn.conv2d(p.conv2, swish(nn.groupnorm(p.norm2, h)))
    if hasattr(p, "nin_shortcut"):
        x = nn.conv2d(p.nin_shortcut, x)
    return x + h


def _attn_block(p: AttnBlock, x):
    """Single-head spatial self-attention over the H*W tokens."""
    h = nn.groupnorm(p.norm, x)
    b, c, hh, ww = h.shape

    def tokens(conv):
        return nn.conv2d(conv, h).reshape(b, c, hh * ww).transpose(1, 2)[:, :, None, :]

    out = sdpa_ref(tokens(p.q), tokens(p.k), tokens(p.v))      # [b, hw, 1, c]
    out = out.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
    return x + nn.conv2d(p.proj_out, out)


def _downsample(p: _Resample, x):
    # asymmetric pad (right 1, bottom 1), then a stride-2 conv without padding
    x = F.pad(x, (0, 1, 0, 1))
    return nn.conv2d(p.conv, x, stride=2, padding=0)


def _upsample(p: _Resample, x):
    x = F.interpolate(x, scale_factor=2, mode="nearest")
    return nn.conv2d(p.conv, x)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def encoder_forward(p: Encoder, cfg: VAEConfig, x: torch.Tensor) -> torch.Tensor:
    """x: [B, H, W, 3] in [-1, 1] -> moments [B, H/8, W/8, 2*z]."""
    h = nn.conv2d(p.conv_in, _nchw(x))
    for level in p.down:
        for bp in level.block:
            h = _resnet(bp, h)
        if hasattr(level, "downsample"):
            h = _downsample(level.downsample, h)
    h = _resnet(p.mid.block_1, h)
    h = _attn_block(p.mid.attn_1, h)
    h = _resnet(p.mid.block_2, h)
    return _nhwc(nn.conv2d(p.conv_out, swish(nn.groupnorm(p.norm_out, h))))


def decoder_forward(p: Decoder, cfg: VAEConfig, z: torch.Tensor) -> torch.Tensor:
    """z: [B, h, w, z] -> image [B, 8h, 8w, 3]."""
    h = nn.conv2d(p.conv_in, _nchw(z))
    h = _resnet(p.mid.block_1, h)
    h = _attn_block(p.mid.attn_1, h)
    h = _resnet(p.mid.block_2, h)
    for i in reversed(range(len(p.up))):
        level = p.up[i]
        for bp in level.block:
            h = _resnet(bp, h)
        if hasattr(level, "upsample"):
            h = _upsample(level.upsample, h)
    return _nhwc(nn.conv2d(p.conv_out, swish(nn.groupnorm(p.norm_out, h))))


def diagonal_gaussian(moments: torch.Tensor, sample: bool = True,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """moments [..., 2z] channel-chunked into mean/logvar.  The posterior
    noise is drawn from ``generator``, or injected as ``noise`` (the tests
    hand both packages the same draws)."""
    mean, logvar = moments.chunk(2, dim=-1)
    if not sample:
        return mean
    std = torch.exp(0.5 * logvar)
    if noise is None:
        # data parallel: this rank's rows of the global batch's draw
        noise = randn_rows(mean.shape, generator, mean.dtype, mean.device)
    return mean + std * noise.to(mean.dtype)


def vae_encode(p: AutoEncoder, cfg: VAEConfig, x: torch.Tensor,
               generator: Optional[torch.Generator] = None, sample: bool = True,
               dtype=torch.float32, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Moments -> (sampled) z -> scale * (z - shift); float32 out.  ``dtype``
    is the conv compute dtype (float32, or bfloat16 as the trainer's
    default); the moments are float32."""
    if sample and generator is None and noise is None:
        raise ValueError("generator or noise required when sample=True")
    with tracing.span(tracing.FROZEN_VAE):
        moments = encoder_forward(p.encoder, cfg, x.to(dtype)).to(torch.float32)
        z = diagonal_gaussian(moments, sample=sample, generator=generator, noise=noise)
        return cfg.scale_factor * (z - cfg.shift_factor)


def vae_decode(p: AutoEncoder, cfg: VAEConfig, z: torch.Tensor) -> torch.Tensor:
    """Latent [B, h, w, z] (NHWC) -> image [B, 8h, 8w, 3] in about [-1, 1]."""
    z = z.to(torch.float32) / cfg.scale_factor + cfg.shift_factor
    return decoder_forward(p.decoder, cfg, z)
