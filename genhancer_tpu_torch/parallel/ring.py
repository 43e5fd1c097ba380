"""Ring attention: exact softmax attention with the token axis split over
the mesh's seq axis.

Port of ``genhancer_tpu/parallel/ring.py``.  Each seq rank holds one
contiguous chunk ``[B, c, H, D]`` of the joint sequence, padded at its end
to ``n * c`` tokens (``ring_attention:202-234``); the pad keys are masked
to -inf, the pad query rows compute values that nobody reads.  The ring is
a ``torch.autograd.Function``:

  * forward (``_ring_fwd_impl:111-148``): n steps; at step s the rank holds
    the K/V chunk of seq index ``r - s`` (the chunks rotate ``i -> i + 1``,
    ``parallel.mesh.rotate``) and merges its float32 scores into a running
    float32 (o, m, den); p goes to v's dtype unnormalised before P·V, the
    ``safe`` gate keeps a fully padded chunk seen before any real one from
    making NaNs, and ``lse = m + log(den)`` is kept for the backward;
  * backward (``_ring_vjp_bwd:156-193``): a second pass; p is recomputed
    from lse, ds and p are rounded to k's and dO's dtype before their
    products, dq accumulates here, and the float32 dk/dv accumulators
    travel with their chunk and are home after n hops.

Every product accumulates in float32, as JAX's ``preferred_element_type``:
the bf16 operands are upcast (exact) and multiplied in float32, so the
trainer's TF32-off setting keeps them exact products.  The contraction is
plain ``torch`` arithmetic, as JAX's is plain ``einsum``s: no kernel.

``ring_scope`` (opened by the task around the DiT forward, JAX
``_ring_ctx_factory``) sends ``core.attention.attention`` through the
ring; ``models.dit.dit_forward`` then computes the rank's ``Layout`` of
the joint order ``[txt; img]`` and opens ``layout_scope``, so that each
block's attention pads the rank's real tokens to its chunk.  The state is
thread-local; ``replay`` carries it into a function that autograd runs
again in the backward (the DiT's remat).
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from . import mesh
from .mesh import SEQ_AXIS

# {"axis": the seq axis name, "layout": the rank's Layout} while open
_STATE = threading.local()


@contextlib.contextmanager
def ring_scope(axis: str = SEQ_AXIS):
    """Route the DiT's attention through ``ring_attention`` on ``axis``."""
    prev = getattr(_STATE, "axis", None)
    _STATE.axis = axis
    try:
        yield
    finally:
        _STATE.axis = prev


def active_scope() -> Optional[str]:
    """The axis of an open ``ring_scope`` whose size is above 1, else None."""
    axis = getattr(_STATE, "axis", None)
    return axis if axis is not None and mesh.axis_size(axis) > 1 else None


@dataclass(frozen=True)
class Layout:
    """The rank's chunk of the joint order ``[txt; img]`` padded to ``n *
    c`` tokens: ``txt`` and ``img`` slice each stream's tokens that the
    chunk holds (in that order), ``lengths[j]`` is the count of real tokens
    in chunk j."""
    axis: str
    n: int
    r: int
    c: int
    txt: slice
    img: slice
    lengths: Tuple[int, ...]

    @property
    def n_real(self) -> int:
        return self.lengths[self.r]


def token_layout(l_txt: int, l_img: int, axis: str = SEQ_AXIS,
                 n: Optional[int] = None, r: Optional[int] = None) -> Layout:
    """The ``Layout`` of seq index ``r`` of ``n`` (this rank's on ``axis``
    by default) for ``l_txt`` text and ``l_img`` image tokens."""
    n = mesh.axis_size(axis) if n is None else n
    r = mesh._axis(axis)[2] if r is None else r
    length = l_txt + l_img
    c = -(-length // n)
    lengths = tuple(max(0, min(length, (j + 1) * c) - j * c) for j in range(n))
    s, e = r * c, min(length, (r + 1) * c)
    txt = slice(min(s, l_txt), min(e, l_txt))
    img = slice(max(s, l_txt) - l_txt, max(e, l_txt) - l_txt)
    return Layout(axis, n, r, c, txt, img, lengths)


def current_layout() -> Optional[Layout]:
    return getattr(_STATE, "layout", None)


@contextlib.contextmanager
def layout_scope(layout: Optional[Layout]):
    prev = getattr(_STATE, "layout", None)
    _STATE.layout = layout
    try:
        yield
    finally:
        _STATE.layout = prev


def replay(fn):
    """``fn`` as a function whose every call runs in the ring state open
    when it was made (for ``torch.utils.checkpoint``'s recompute in the
    backward); outside a scope ``fn`` is returned."""
    axis, layout = getattr(_STATE, "axis", None), current_layout()
    if axis is None:
        return fn

    def run(*args):
        with ring_scope(axis), layout_scope(layout):
            return fn(*args)

    return run


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float, valid: int) -> torch.Tensor:
    """[B, c, H, D] x [B, c, H, D] -> [B, H, c, c] float32, key columns
    from ``valid`` on at -inf."""
    s = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) * scale
    if valid < s.shape[-1]:
        keep = torch.arange(s.shape[-1], device=s.device) < valid
        s = torch.where(keep, s, torch.full((), -float("inf"), device=s.device))
    return s


def _ring_fwd(q, k, v, lengths, axis):
    n, r = len(lengths), mesh._axis(axis)[2]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    b, c, h, d = q.shape
    o = q.new_zeros((b, h, c, d), dtype=torch.float32)
    m = q.new_full((b, h, c, 1), -float("inf"), dtype=torch.float32)
    den = q.new_zeros((b, h, c, 1), dtype=torch.float32)
    k_c, v_c = k, v
    for step in range(n):
        s = _scores(q, k_c, scale, lengths[(r - step) % n])
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        # m_new is -inf only while every key seen is a pad column: gate the
        # NaN of exp(-inf - -inf); o and den are still zero there
        safe = ~torch.isneginf(m_new)
        alpha = torch.where(safe, torch.exp(m - m_new), 1.0)
        p = torch.where(safe, torch.exp(s - m_new), 0.0)
        den = den * alpha + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bhlm,bmhd->bhld", p.to(v.dtype).float(), v_c.float())
        o = o * alpha + pv
        m = m_new
        if step < n - 1:        # JAX's last hop only brings K/V home
            k_c, v_c = mesh.rotate(k_c, axis), mesh.rotate(v_c, axis)
    out = (o / den).transpose(1, 2).to(q.dtype)
    return out, m + torch.log(den)


class _Ring(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, lengths, axis):
        o, lse = _ring_fwd(q, k, v, lengths, axis)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.lengths, ctx.axis = lengths, axis
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        lengths, axis = ctx.lengths, ctx.axis
        n, r = len(lengths), mesh._axis(axis)[2]
        scale = 1.0 / (q.shape[-1] ** 0.5)
        do_f, q_f = do.float(), q.float()
        d_i = torch.einsum("blhd,blhd->bhl", do_f, o.float())[..., None]
        dq = torch.zeros_like(q, dtype=torch.float32).transpose(1, 2).contiguous()
        dk_c, dv_c = torch.zeros_like(dq), torch.zeros_like(dq)
        k_c, v_c = k, v
        for step in range(n):
            s = _scores(q, k_c, scale, lengths[(r - step) % n])
            # every q row sees a real key: lse is finite, pad columns get 0
            p = torch.exp(s - lse)
            dp = torch.einsum("blhd,bmhd->bhlm", do_f, v_c.float())
            ds = p * (dp - d_i)
            dsb, pb = ds.to(k.dtype).float(), p.to(do.dtype).float()
            dq = dq + torch.einsum("bhlm,bmhd->bhld", dsb, k_c.float()) * scale
            dk_c = dk_c + torch.einsum("bhlm,blhd->bhmd", dsb, q_f) * scale
            dv_c = dv_c + torch.einsum("bhlm,blhd->bhmd", pb, do_f)
            # dk/dv travel with their chunk: home after n hops
            dk_c, dv_c = mesh.rotate(dk_c, axis), mesh.rotate(dv_c, axis)
            if step < n - 1:
                k_c, v_c = mesh.rotate(k_c, axis), mesh.rotate(v_c, axis)

        def tr(x, like):
            return x.transpose(1, 2).to(like.dtype)
        return tr(dq, q), tr(dk_c, k), tr(dv_c, v), None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   lengths: Sequence[int], axis: str = SEQ_AXIS) -> torch.Tensor:
    """Softmax attention of this rank's chunk q, k, v [B, c, H, D] (its seq
    index's part of the padded sequence) against every rank's K/V on
    ``axis``; ``lengths[j]``: the real tokens of chunk j.  Returns [B, c,
    H, D] in q's dtype.  Every rank of the axis calls it alike."""
    return _Ring.apply(q, k, v, tuple(int(x) for x in lengths), axis)


def chunk(x: torch.Tensor, n: int, r: int) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """Seq index ``r``'s chunk of a whole [B, L, ...] tensor padded with
    zeros to a multiple of ``n`` tokens, and every chunk's real count."""
    lay = token_layout(x.shape[1], 0, n=n, r=r)
    part = x[:, lay.txt]
    return _pad_rows(part, lay.c), lay.lengths


def _pad_rows(x: torch.Tensor, c: int) -> torch.Tensor:
    if x.shape[1] == c:
        return x
    pad = x.new_zeros((x.shape[0], c - x.shape[1]) + tuple(x.shape[2:]))
    return torch.cat([x, pad], dim=1)


def attention_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The ring under the open ``layout_scope``: q, k, v [B, n_real, H, D]
    (the rank's real tokens, RoPE applied) padded with zero rows to the
    chunk, the ring, the real rows of the result."""
    lay = current_layout()
    if lay is None:
        raise RuntimeError("ring attention outside a layout_scope: dit_forward opens it")
    o = ring_attention(_pad_rows(q, lay.c), _pad_rows(k, lay.c), _pad_rows(v, lay.c),
                       lay.lengths, lay.axis)
    return o[:, :q.shape[1]]
