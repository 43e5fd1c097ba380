"""Scaled-dot-product attention and its dispatch to the fused kernels.

Port of ``genhancer_tpu/core/attention.py:175-232``:

  * ``sdpa_ref``: einsum attention with float32 logits and softmax,
    probabilities cast to the input dtype before the float32-accumulated PV
    product — the JAX ``sdpa_xla``, and the plain version of the kernels.
  * ``attention`` (DiT, RoPE) sends sequences of at most ``FUSED_MAX_SEQ``
    tokens with even D to the fused RoPE + attention kernel K1
    (``kernels/short_attention.py``); longer ones take ``apply_rope`` on q
    and k and then ``sdpa``.
  * ``sdpa`` sends sequences of at least ``PALLAS_MIN_SEQ`` tokens to the
    flash kernel K5 (``kernels/flash_attention.py``), which streams K/V and
    has no length ceiling.
  * ``sdpa_auto`` (towers) sends at most ``FUSED_MAX_SEQ`` tokens with even
    D to K2 and longer sequences to ``sdpa``.

Shorter sequences that reach ``sdpa`` (odd D, which no model of the port
has) take ``sdpa_ref`` on the CPU, as the JAX package takes XLA there, and
raise on CUDA.

Under an open ``parallel.ring.ring_scope`` on a seq axis above one rank
(``sequence_parallel``), ``attention`` applies RoPE to the rank's q and k
and runs ring attention over the axis (``attention.py:219-225``): neither
K1 nor K5.

Layout: activations are [B, L, H, D].
"""

from __future__ import annotations

import torch

from .. import tracing
from .rope import apply_rope

# The JAX package sends L <= 600 to its short kernel and L >= 600 to the
# flash kernel (genhancer_tpu/core/attention.py FUSED_MAX_SEQ, PALLAS_MIN_SEQ).
FUSED_MAX_SEQ = 600
PALLAS_MIN_SEQ = 600


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, l, h, d = x.shape
    return x.reshape(b, l, h * d)


def sdpa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v: [B, L, H, D] -> [B, L, H, D]; float32 softmax."""
    d = q.shape[-1]
    scale = 1.0 / (d ** 0.5)
    logits = torch.einsum("blhd,bmhd->bhlm", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhlm,bmhd->blhd", probs.to(torch.float32),
                       v.to(torch.float32))
    return out.to(q.dtype)


def _short_ok(q: torch.Tensor) -> bool:
    return q.shape[1] <= FUSED_MAX_SEQ and q.shape[-1] % 2 == 0


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, L, H, D] -> [B, L, H, D]: K5 at L >= PALLAS_MIN_SEQ."""
    if q.shape[1] >= PALLAS_MIN_SEQ:
        from .kernels.flash_attention import flash_attention
        return flash_attention(q, k, v)
    if q.is_cuda:
        raise NotImplementedError(
            f"attention at L={q.shape[1]}, D={q.shape[-1]} has no CUDA kernel: K1/K2 "
            f"take L <= {FUSED_MAX_SEQ} with even D, K5 takes L >= {PALLAS_MIN_SEQ}")
    return sdpa_ref(q, k, v)


def sdpa_auto(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Unmasked SDPA for the tower encoders: K2 for short sequences."""
    if _short_ok(q):
        from .kernels.short_attention import fused_attention
        return fused_attention(q, k, v)
    return sdpa(q, k, v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE + SDPA + head merge (the DiT's joint attention).

    q, k, v: [B, L, H, D]; cos/sin: [B, L, D/2].  Returns [B, L, H*D].
    Under an open ring scope L is the rank's tokens of the joint sequence.
    While tracing is on it runs in the span ``dit.attention``, and under
    autograd its backward lies between the marks
    ``dit.attention.bwd_begin`` and ``dit.attention.bwd_end``.
    """
    if not tracing.enabled():
        return _attention(q, k, v, cos, sin)
    grad = torch.is_grad_enabled()
    if grad:
        q, k, v = tracing.backward_mark(tracing.DIT_ATTENTION_BWD_END, q, k, v)
    with tracing.span(tracing.DIT_ATTENTION):
        out = _attention(q, k, v, cos, sin)
    return tracing.backward_mark(tracing.DIT_ATTENTION_BWD_BEGIN, out) if grad else out


def _attention(q, k, v, cos, sin):
    from ..parallel import ring
    if ring.active_scope() is not None:
        return _merge_heads(ring.attention_chunk(apply_rope(q, cos, sin),
                                                 apply_rope(k, cos, sin), v))
    if _short_ok(q):
        from .kernels.short_attention import fused_rope_attention
        return _merge_heads(fused_rope_attention(q, k, v, cos, sin))
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    return _merge_heads(sdpa(q, k, v))
