"""Text-conditioned DiT inputs (the reference's ``prepare``).

Port of ``genhancer_tpu/tasks/text_conditioning.py``
(``src/flux/sampling.py:32-63`` and ``modules/conditioner.py``'s
``HFEmbedder``): the DiT's inputs from a T5 sequence embedding [B, L, 4096]
and a CLIP-text pooled vector [B, vec_dim], from any embedder callables.
GenHancer's trainers condition on the vision tower instead; the generative
core keeps this path.  The providers wrap the port's CLIP text side
(``models.towers.clip.get_text_features``) and T5 encoder
(``models.towers.t5.encoder_forward``).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..core.rope import spatial_ids
from ..models import dit as dit_m
from ..models.towers import clip as clip_m


def clip_text_pooled_provider(model: clip_m.CLIPModel, cfg: clip_m.CLIPConfig) -> Callable:
    """token ids [B, L] -> the projected pooled text embedding
    [B, projection_dim] (``HFEmbedder`` with ``is_clip=True``)."""
    def fn(input_ids: torch.Tensor) -> torch.Tensor:
        return clip_m.get_text_features(model, input_ids, cfg)
    return fn


def t5_sequence_provider(model, cfg, dtype=torch.float32) -> Callable:
    """token ids [B, L] (and an optional padding mask) -> the sequence
    embedding [B, L, d_model] in ``dtype`` (``T5EncoderModel``'s
    ``last_hidden_state``, ``conditioner.py:30-43``)."""
    from ..models.towers import t5 as t5_m

    def fn(input_ids: torch.Tensor, attention_mask=None) -> torch.Tensor:
        return t5_m.encoder_forward(model, input_ids, cfg, attention_mask=attention_mask,
                                    dtype=dtype)
    return fn


def prepare(txt_embed: torch.Tensor, vec_embed: torch.Tensor,
            latent: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The DiT input dict from precomputed embeddings (``sampling.py:32-63``).

    txt_embed: [B, L_txt, 4096] (T5); vec_embed: [B, vec_dim] (CLIP text);
    latent: [B, H, W, C] NHWC VAE latent.  Packs the latent, builds the
    ``(0, row, col)`` img ids and zero txt ids, both float32."""
    b, h, w, _ = latent.shape
    dev = latent.device
    img = dit_m.pack_latent(latent)
    img_ids = spatial_ids(h // 2, w // 2, device=dev)[None].expand(b, -1, -1)
    txt_ids = torch.zeros((b, txt_embed.shape[1], 3), dtype=torch.float32, device=dev)
    return {"img": img, "img_ids": img_ids, "txt": txt_embed, "txt_ids": txt_ids,
            "vec": vec_embed}
