"""Pipeline parallelism for the DiT: a GPipe schedule over the mesh's pipe
axis.

Port of ``genhancer_tpu/parallel/pp.py``.  Stage i (the rank's pipe index)
runs blocks ``[i * depth / S, (i + 1) * depth / S)`` of each of the DiT's
two homogeneous segments; the parameters stay whole on every pipe rank, as
in JAX (``pp.py:28-31``: PP splits the compute and the activations, not
the weights).

  * ``validate_pp`` (``:83-95``), JAX's messages;
  * micro-batching is local: the rank's rows ``[B_loc] -> [M, B_loc / M]``
    (``_phase:98-112``);
  * each phase runs ``M + S - 1`` ticks: at tick t stage i computes
    micro-batch ``t - i`` when it is in range (the inactive ticks, which
    JAX computes on zeros and discards, are skipped) and the stages'
    activations rotate ``i -> i + 1`` (``parallel.mesh.rotate``, JAX's
    ``ppermute``); stage 0 injects micro-batch t;
  * two phases, the double blocks and then, after the concat, the single
    blocks; each ends with the collect: the last stage's outputs on every
    stage (a broadcast; JAX's ``psum`` of the last stage's diagonal);
  * the prologue and the final layer run outside the pipeline, on every
    pipe rank; ``remat`` checkpoints each block under its ``remat_policy``
    (``models.dit.block_fns``);
  * IP-Adapter conditioning raises ``NotImplementedError``
    (``pipeline_dit_forward:171-175``).

A phase is one ``torch.autograd.Function``.  Its forward keeps each
micro-batch's graph through the stage's blocks (the GPipe stash; block
inputs only under remat); its backward walks the ticks in reverse, the
same order on every stage: the last stage starts from the collected
outputs' cotangents, each stage backpropagates its micro-batch and rotates
the input's cotangent ``i -> i - 1``.  The phase's outputs are replicated
over pipe and so are its inputs' cotangents: stage 0's are broadcast, and
the partial sums of the modulation vector's cotangent (every stage reads
it) are summed over pipe.  So the prologue and the final layer take whole
gradients on every pipe rank and count once, and a block's gradient lives
on its stage only: the step sums the blocks over pipe (``PIPE_PREFIXES``,
``train.state.apply_gradients``).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from . import mesh
from .mesh import PIPE_AXIS

# the flat paths of the leaves a stage owns: summed over pipe
PIPE_PREFIXES = ("dit.double_blocks.", "dit.single_blocks.")


def validate_pp(dit_cfg, pp: int, n_micro: int, local_batch: int) -> None:
    if pp <= 1:
        return
    if dit_cfg.depth % pp or dit_cfg.depth_single_blocks % pp:
        raise ValueError(
            f"pipeline_parallel={pp} must divide both depth={dit_cfg.depth} "
            f"and depth_single_blocks={dit_cfg.depth_single_blocks}")
    if n_micro < 1:
        raise ValueError(f"pipeline_microbatches={n_micro} must be >= 1")
    if local_batch % n_micro:
        raise ValueError(
            f"per-data-shard batch {local_batch} not divisible by "
            f"pipeline_microbatches={n_micro}")


def _micro(x: torch.Tensor, m: int) -> torch.Tensor:
    return x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))


def _whole(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat(list(parts), dim=0)


class _Phase(torch.autograd.Function):
    """One GPipe phase: ``stage_fn(inputs, consts) -> outputs`` (tuples of
    [B_loc / M, ...] tensors, outputs shaped as the inputs) over the
    rank's stage; inputs and consts [B_loc, ...]."""

    @staticmethod
    def forward(ctx, stage_fn, n_micro, n_in, axis, build, *tensors):
        _, n_st, i = mesh._axis(axis)
        ins = [_micro(x, n_micro) for x in tensors[:n_in]]
        consts = tensors[n_in:]
        cs = [_micro(c, n_micro) for c in consts]
        ticks = n_micro + n_st - 1
        stash, last, recv = {}, [None] * n_micro, None
        for t in range(ticks):
            j = t - i                               # this stage's micro-batch
            cur = [x[t] for x in ins] if i == 0 and t < n_micro else recv
            if 0 <= j < n_micro:
                with torch.enable_grad() if build else torch.no_grad():
                    xin = [x.detach().requires_grad_(build) for x in cur]
                    cin = [c[j].detach().requires_grad_(build and c0.requires_grad)
                           for c, c0 in zip(cs, consts)]
                    out = tuple(stage_fn(xin, cin))
                if build:
                    stash[j] = (xin, cin, out)
                send = [o.detach() for o in out]
                if i == n_st - 1:
                    last[j] = send
            else:                                   # an inactive slot
                send = [torch.zeros_like(x[0]) for x in ins]
            if t < ticks - 1:
                recv = [mesh.rotate(x, axis) for x in send]
        # the collect: the last stage's outputs on every stage
        outs = []
        for k, x in enumerate(tensors[:n_in]):
            y = (_whole([last[j][k] for j in range(n_micro)]) if i == n_st - 1
                 else torch.empty_like(x))
            outs.append(mesh.broadcast_from(y, n_st - 1, axis))
        ctx.stash, ctx.meta = stash, (n_micro, n_in, axis, ticks)
        ctx.const_like = [(c.shape, c.dtype, c.device) for c in consts]
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gouts):
        n_micro, n_in, axis, ticks = ctx.meta
        _, n_st, i = mesh._axis(axis)
        gs = [_micro(g.contiguous(), n_micro) for g in gouts]
        d_in = [None] * n_micro
        d_c = [torch.zeros(s, dtype=dt, device=dev) if need else None
               for (s, dt, dev), need in zip(ctx.const_like, ctx.needs_input_grad[5 + n_in:])]
        d_cm = [_micro(d, n_micro) if d is not None else None for d in d_c]
        recv = None
        for t in reversed(range(ticks)):
            j = t - i
            if 0 <= j < n_micro:
                xin, cin, out = ctx.stash.pop(j)
                g = [x[j] for x in gs] if i == n_st - 1 else recv
                torch.autograd.backward(out, g)
                send = [x.grad for x in xin]
                for d, c in zip(d_cm, cin):
                    if d is not None and c.grad is not None:
                        d[j] += c.grad
                if i == 0:
                    d_in[j] = send
            else:
                send = [torch.zeros_like(x[0]) for x in gs]
            if t > 0:
                recv = [mesh.rotate(x, axis, shift=-1) for x in send]
        grads = []
        for k, g in enumerate(gouts):
            y = _whole([d_in[j][k] for j in range(n_micro)]) if i == 0 else torch.empty_like(g)
            grads.append(mesh.broadcast_from(y, 0, axis))
        for d in d_c:
            if d is not None:
                mesh.all_reduce_(d, axis)
        return (None, None, None, None, None, *grads, *d_c)


def run_phase(stage_fn: Callable, n_micro: int, inputs: Sequence[torch.Tensor],
              consts: Sequence[torch.Tensor], axis: str = PIPE_AXIS):
    """The GPipe phase of ``stage_fn`` over ``axis`` on the rank's rows:
    the last stage's outputs, on every stage of the axis."""
    build = torch.is_grad_enabled() and any(
        t.requires_grad for t in (*inputs, *consts))
    return _Phase.apply(stage_fn, n_micro, len(inputs), axis, build, *inputs, *consts)


def pipeline_dit_forward(p, cfg, *, n_micro: int, img: torch.Tensor,
                         img_ids: torch.Tensor, txt: torch.Tensor, txt_ids: torch.Tensor,
                         timesteps: torch.Tensor, y: torch.Tensor, guidance=None,
                         remat: bool = False, remat_policy=None, image_proj=None,
                         ip_params=None, ip_scale: float = 1.0,
                         axis: str = PIPE_AXIS) -> torch.Tensor:
    """``models.dit.dit_forward`` on the rank's rows with the block stack
    pipelined over the mesh's pipe axis; the same result on every pipe
    rank.  IP-Adapter conditioning is not supported under PP."""
    from ..models import dit as dit_m
    if image_proj is not None or ip_params is not None:
        raise NotImplementedError(
            "IP-adapter conditioning is not supported under pipeline "
            "parallelism (per-block IP params break the homogeneous stack)")
    n_st = mesh.axis_size(axis)
    if n_st <= 1:
        raise ValueError(
            f"mesh has no '{axis}' axis — build it with "
            "make_mesh(pipeline_parallel=N)")
    validate_pp(cfg, n_st, n_micro, img.shape[0])
    i = mesh._axis(axis)[2]
    img_h, txt_h, vec, cos, sin = dit_m.embed_inputs(p, cfg, img, img_ids, txt, txt_ids,
                                                     timesteps, y, guidance)
    dblock, sblock = dit_m.block_fns(remat, remat_policy)
    kd, ks = cfg.depth // n_st, cfg.depth_single_blocks // n_st
    doubles = list(p.double_blocks)[i * kd:(i + 1) * kd]
    singles = list(p.single_blocks)[i * ks:(i + 1) * ks]

    def double_stage(xs, cs):
        im, tx = xs
        v, co, si = cs
        for blk in doubles:
            im, tx = dblock(blk, im, tx, v, co, si, cfg.num_heads, None)
        return im, tx

    def single_stage(xs, cs):
        (x,) = xs
        v, co, si = cs
        for blk in singles:
            x = sblock(blk, x, v, co, si, cfg.num_heads, cfg.hidden_size, None)
        return (x,)

    img_h, txt_h = run_phase(double_stage, n_micro, (img_h, txt_h), (vec, cos, sin), axis)
    x = torch.cat([txt_h, img_h], dim=1)
    (x,) = run_phase(single_stage, n_micro, (x,), (vec, cos, sin), axis)
    return dit_m.final_layer(p, x[:, txt_h.shape[1]:], vec)


def pipe_owned(path: str) -> bool:
    """Whether the leaf at flat ``path`` lives on one stage (a block)."""
    return path.startswith(PIPE_PREFIXES)
