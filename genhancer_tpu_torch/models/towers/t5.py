"""T5 encoder (v1.1 / XXL family): the sequence half of text conditioning.

Port of ``genhancer_tpu/models/towers/t5.py`` (HF ``modeling_t5.py``'s
encoder; the reference's ``HFEmbedder`` with ``T5EncoderModel``).  The
module tree carries HF's names (``shared.weight``,
``encoder.block.{i}.layer.0.SelfAttention.q.weight``,
``encoder.block.{i}.layer.1.DenseReluDense.wi_0.weight``,
``encoder.final_layer_norm.weight``), so an HF directory loads with
``load_state_dict(strict=True)``.  Semantics, each of which a faithful-looking
port can miss:

  * the layer norm is RMS-only, no mean and no bias: float32 statistics,
    the normalised value cast to the input dtype, then times the weight;
  * attention has no 1/sqrt(d) scaling and no biases; its logits are
    float32 products plus a relative-position bias, the softmax is float32
    and cast to v's dtype before the float32-accumulated P·V product;
  * the bias table [buckets, heads] lives in layer 0 only and every layer
    adds it; the buckets are bidirectional (``relative_position_buckets``);
  * a padding mask adds ``finfo(float32).min`` to the masked keys' logits;
  * v1.1's FFN is gated, ``wo(gelu_tanh(wi_0 x) * wi_1 x)``; legacy T5's
    is ``wo(relu(wi x))`` (``gated=False``);
  * the embedded inputs are not scaled.

The attention is plain torch products here as it is plain einsum products
in JAX (``t5.py:150-156``): no TPU kernel computes it, and K1/K2/K5 take no
additive bias.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn as tnn

from ...core import nn
from .clip import _Table


@dataclass(frozen=True)
class T5Config:
    d_model: int = 4096          # t5-v1_1-xxl
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    vocab_size: int = 32128
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    gated: bool = True           # v1.1 gated-gelu; False = legacy relu FFN

    @staticmethod
    def from_hf(cfg: dict) -> "T5Config":
        return T5Config(
            d_model=cfg["d_model"], d_kv=cfg.get("d_kv", 64), d_ff=cfg["d_ff"],
            num_layers=cfg["num_layers"], num_heads=cfg["num_heads"],
            vocab_size=cfg["vocab_size"],
            relative_attention_num_buckets=cfg.get("relative_attention_num_buckets", 32),
            relative_attention_max_distance=cfg.get("relative_attention_max_distance", 128),
            layer_norm_epsilon=cfg.get("layer_norm_epsilon", 1e-6),
            gated="gated" in cfg.get("feed_forward_proj", "gated-gelu"))


# ---------------------------------------------------------------------------
# modules (HF names)
# ---------------------------------------------------------------------------

class _Linear(nn.Linear):
    """A bias-free T5 linear drawn N(0, 1/in) (``init_t5``'s ``lin``)."""

    def __init__(self, i, o, **fk):
        super().__init__(i, o, bias=False, **fk)

    def init_(self, g):
        self.weight.normal_(0.0, self.in_dim ** -0.5, generator=g)


class _Norm(tnn.Module):
    def __init__(self, d, *, device=None, dtype=None):
        super().__init__()
        self.weight = tnn.Parameter(torch.empty(d, device=device, dtype=dtype or torch.float32))

    def init_(self, g):
        self.weight.fill_(1.0)


class _SelfAttention(tnn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool, **fk):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.q = _Linear(cfg.d_model, inner, **fk)
        self.k = _Linear(cfg.d_model, inner, **fk)
        self.v = _Linear(cfg.d_model, inner, **fk)
        self.o = _Linear(inner, cfg.d_model, **fk)
        if has_bias:
            self.relative_attention_bias = _Table(
                (cfg.relative_attention_num_buckets, cfg.num_heads), 0.1, **fk)


class _AttnLayer(tnn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool, **fk):
        super().__init__()
        self.SelfAttention = _SelfAttention(cfg, has_bias, **fk)
        self.layer_norm = _Norm(cfg.d_model, **fk)


class _FFLayer(tnn.Module):
    def __init__(self, cfg: T5Config, **fk):
        super().__init__()
        names = ("wi_0", "wi_1") if cfg.gated else ("wi",)
        self.DenseReluDense = tnn.ModuleDict(
            {**{n: _Linear(cfg.d_model, cfg.d_ff, **fk) for n in names},
             "wo": _Linear(cfg.d_ff, cfg.d_model, **fk)})
        self.layer_norm = _Norm(cfg.d_model, **fk)


class _Block(tnn.Module):
    def __init__(self, cfg: T5Config, first: bool, **fk):
        super().__init__()
        self.layer = tnn.ModuleList([_AttnLayer(cfg, first, **fk), _FFLayer(cfg, **fk)])


class _Encoder(tnn.Module):
    def __init__(self, cfg: T5Config, **fk):
        super().__init__()
        self.block = tnn.ModuleList(_Block(cfg, i == 0, **fk) for i in range(cfg.num_layers))
        self.final_layer_norm = _Norm(cfg.d_model, **fk)


class T5Encoder(tnn.Module):
    """``init_t5``'s tree: ``shared`` [vocab, d_model] and ``encoder``."""

    def __init__(self, cfg: T5Config, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.shared = _Table((cfg.vocab_size, cfg.d_model), 1.0, **fk)
        self.encoder = _Encoder(cfg, **fk)


def init_t5(generator: torch.Generator, cfg: T5Config, device=None, dtype=None) -> T5Encoder:
    """Random init with ``init_t5``'s distributions, drawn from
    ``generator`` on ``device`` (a CUDA generator initialises a T5-XXL,
    4.7 B parameters, on the card)."""
    return nn.init_weights(T5Encoder(cfg, device=device, dtype=dtype), generator)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _t5_layernorm(p: _Norm, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS only: float32 mean square, normalised in float32, cast to x's
    dtype, then times the weight in that dtype."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * p.weight.to(x.dtype)


def relative_position_buckets(q_len: int, k_len: int, num_buckets: int,
                              max_distance: int) -> np.ndarray:
    """Bidirectional T5 bucket ids [q_len, k_len] (``modeling_t5.py``
    ``_relative_position_bucket``), int64."""
    rel = np.arange(k_len)[None, :] - np.arange(q_len)[:, None]
    nb = num_buckets // 2
    out = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    large = max_exact + (np.log(np.maximum(rel, 1) / max_exact)
                         / np.log(max_distance / max_exact)
                         * (nb - max_exact)).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return out + np.where(rel < max_exact, rel, large)


def encoder_forward(p: T5Encoder, input_ids: torch.Tensor, cfg: T5Config,
                    attention_mask: Optional[torch.Tensor] = None,
                    dtype=torch.float32) -> torch.Tensor:
    """input_ids [B, L] -> last_hidden_state [B, L, d_model] in ``dtype``;
    ``attention_mask`` [B, L] (1 keeps a key, 0 masks it)."""
    b, l = input_ids.shape
    dev = input_ids.device
    x = p.shared.weight[input_ids].to(dtype)

    buckets = torch.as_tensor(relative_position_buckets(
        l, l, cfg.relative_attention_num_buckets, cfg.relative_attention_max_distance),
        device=dev)
    table = p.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight
    pos_bias = table[buckets].permute(2, 0, 1)[None].to(torch.float32)   # [1, H, L, L]
    if attention_mask is not None:
        pad = 1.0 - attention_mask.to(torch.float32)
        pos_bias = pos_bias + (pad * torch.finfo(torch.float32).min)[:, None, None, :]

    eps, h, d = cfg.layer_norm_epsilon, cfg.num_heads, cfg.d_kv
    for blk in p.encoder.block:
        attn_l, ff_l = blk.layer
        a = attn_l.SelfAttention
        hs = _t5_layernorm(attn_l.layer_norm, x, eps)
        q = nn.linear(a.q, hs).reshape(b, l, h, d)
        k = nn.linear(a.k, hs).reshape(b, l, h, d)
        v = nn.linear(a.v, hs).reshape(b, l, h, d)
        # no 1/sqrt(d) scaling (T5)
        logits = torch.einsum("blhd,bmhd->bhlm", q.to(torch.float32),
                              k.to(torch.float32)) + pos_bias
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhlm,bmhd->blhd", probs.to(torch.float32),
                           v.to(torch.float32)).to(dtype)
        x = x + nn.linear(a.o, out.reshape(b, l, h * d))

        ff = ff_l.DenseReluDense
        hs = _t5_layernorm(ff_l.layer_norm, x, eps)
        if cfg.gated:
            hs = nn.gelu_tanh(nn.linear(ff["wi_0"], hs)) * nn.linear(ff["wi_1"], hs)
        else:
            hs = torch.relu(nn.linear(ff["wi"], hs))
        x = x + nn.linear(ff["wo"], hs)
    return _t5_layernorm(p.encoder.final_layer_norm, x, eps)


def load_t5(model_dir: str, device=None, dtype=None) -> Tuple[T5Encoder, T5Config]:
    """A local HF T5 directory (``T5EncoderModel`` or ``T5Model``: the
    decoder's keys are dropped) -> (encoder, config); the weights from
    ``pytorch_model.bin`` or ``model.safetensors`` (``weights.hf_io``).
    A tied ``encoder.embed_tokens.weight`` stands for ``shared.weight``
    where that is missing, and is dropped otherwise."""
    from ...weights import hf_io
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = T5Config.from_hf(json.load(f))
    sd = None
    for name in ("pytorch_model.bin", "model.safetensors"):
        path = os.path.join(model_dir, name)
        if os.path.exists(path):
            sd = (hf_io.load_state_dict(path) if name.endswith(".bin")
                  else hf_io.load_safetensors(path))
            break
    if not sd:
        raise FileNotFoundError(f"no weights found in {model_dir}")
    sd = {k: v for k, v in sd.items() if not k.startswith("decoder.")}
    tied = sd.pop("encoder.embed_tokens.weight", None)
    if "shared.weight" not in sd and tied is not None:
        sd["shared.weight"] = tied
    enc = T5Encoder(cfg, device="meta", dtype=dtype)
    if dtype is not None:
        sd = {k: v.to(dtype) for k, v in sd.items()}
    enc.load_state_dict(sd, strict=True, assign=True)
    return enc.to(device), cfg
