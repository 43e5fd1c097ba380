"""Data parallelism on ``torch.distributed``: the process group, the rank's
rows, and the collectives of the data-parallel step.

Port of the data-axis half of ``genhancer_tpu/parallel/mesh.py``.  In JAX
the data axis is a mesh axis and XLA inserts the collectives; here a rank is
one process with one device, and the step calls the collectives itself:

  * ``maybe_initialize_distributed`` joins the group that the launcher
    describes: torchrun's ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/
    ``MASTER_PORT`` (with ``LOCAL_RANK`` naming the rank's card), or JAX's
    manual contract ``GENHANCER_COORDINATOR``/``GENHANCER_NUM_PROCS``/
    ``GENHANCER_PROC_ID`` (``mesh.py:33-61``).  NCCL for a CUDA device,
    gloo for the CPU; a failing NCCL raises, there is no fallback;
  * each rank loads ``train_batch_size`` rows (JAX's batch is per process),
    draws the random values of the whole global batch from the shared
    generator and keeps its own rows (``local_rows``);
  * the gradients are summed over the ranks once per optimizer step, in flat
    buckets (``all_reduce_sum``);
  * ZeRO-1 (``shard_optimizer_state``, JAX ``shard_over_data:136``): a leaf
    whose leading dimension divides the world size keeps the moments of
    the rank's rows only (``row_range``), the update runs on those rows and
    the rows are then gathered on every rank (``all_gather_rows``).

The int8 scales that span a batch (a conv's per-tensor amax, the per-column
amax of the int8 dW over the tokens) are the global batch's
(``all_reduce_max``, over the data and seq axes where the rows span both),
and K8 runs on the rows gathered in one process's order
(``all_gather_dim`` over data, ``gather_tokens`` over seq).  Only collectives that gloo implements for CUDA
tensors are used
(``all_reduce``, ``broadcast``, ``all_gather`` into a list), and the
point-to-point ``rotate`` copies a CUDA tensor to the host on gloo, so a
gloo group can also run the step on CUDA tensors, staged through the host.
Outside an initialised group every helper is the one-process identity.

The 2-D mesh (``make_mesh``, JAX ``make_mesh:64-97``): with
``model_parallel: tp`` the ranks form a ``(world // tp, tp)`` grid, the
model axis innermost, so rank ``r`` has data index ``r // tp`` and model
index ``r % tp``.  The ranks of one model index form a data group, the
ranks of one data index a model group (``dist.new_group``; every rank
creates every group, in the same order).  Every data-parallel helper
takes the data axis, not the world: the rank's rows of a global
draw, the loaders' shards, the gradients' sum, the int8 scales that span
the batch and the ZeRO-1 row ranges.  The model ranks of one data index
draw and keep the same rows.  The collectives take ``group=`` "data"
(the default), "model", "seq", "pipe" or "world"; a group of one rank is
the identity.

The seq and pipe axes (JAX ``make_mesh:64-97``): with
``sequence_parallel: sp`` the grid is ``(data, model, seq)``, seq
innermost, so rank ``r`` has seq index ``r % sp``, model index
``(r // sp) % tp`` and data index ``r // (tp * sp)``; with
``pipeline_parallel: pp`` it is ``(data, pipe)``, pipe innermost.  PP
composes with the data axis only, JAX's ``ValueError`` otherwise.  The
ranks of one data and model index form a seq group, those of one data
index a pipe group.  The seq and pipe ranks of one data index draw and keep
the same rows.  ``rotate`` is JAX's ``ppermute`` ``[(i, (i + 1) % n)]``
on an axis: one ``isend``/``irecv`` pair per hop (``batch_isend_irecv``)
on NCCL; a gloo group, whose send and receive take CPU tensors only,
stages a CUDA tensor through the host.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# the size of one flat buffer of a bucketed collective
BUCKET_BYTES = 256 << 20
DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"


@dataclass(frozen=True)
class Mesh:
    """The (data, model[, seq]) or (data, pipe) grid of the ranks and this
    rank's groups (None where the group is the world, or a single rank)."""
    tp: int
    data: object
    model: object
    data_ranks: Tuple[int, ...]
    model_ranks: Tuple[int, ...]
    sp: int = 1
    pp: int = 1
    seq: object = None
    pipe: object = None
    seq_ranks: Tuple[int, ...] = ()
    pipe_ranks: Tuple[int, ...] = ()

    @property
    def inner(self) -> int:
        """The size of the innermost axis, seq or pipe (1 without one)."""
        return self.sp * self.pp


_MESH: Optional[Mesh] = None


def maybe_initialize_distributed(device, timeout_s: Optional[float] = None) -> None:
    """Join the process group the launcher's environment describes, on
    ``device`` (the rank's card, or the CPU); return at once when a group
    is already initialised (a harness that joined one itself) or when the
    environment names none (one process).  ``timeout_s``: the group's
    timeout for a collective (the default's otherwise)."""
    if not dist.is_available() or dist.is_initialized():
        return
    coord = os.environ.get("GENHANCER_COORDINATOR")
    if coord:
        init = f"tcp://{coord}"
        world, rank_ = int(os.environ["GENHANCER_NUM_PROCS"]), int(os.environ["GENHANCER_PROC_ID"])
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        init = "env://"
        world, rank_ = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        return
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method=init,
                            world_size=world, rank=rank_, **kw)


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def validate_mesh(n: int, tp: int = 1, sp: int = 1, pp: int = 1) -> None:
    """JAX ``make_mesh``'s ``ValueError``s: PP composes with data
    parallelism only, and the world must divide the axes."""
    if pp > 1 and (tp > 1 or sp > 1):
        raise ValueError(
            "pipeline_parallel composes with data parallelism only "
            f"(got model_parallel={tp}, sequence_parallel={sp})")
    if min(tp, sp, pp) < 1 or n % (tp * sp * pp):
        raise ValueError(f"{n} devices not divisible by model_parallel={tp} x "
                         f"sequence_parallel={sp} x pipeline_parallel={pp}")


def make_mesh(model_parallel: int = 1, sequence_parallel: int = 1,
              pipeline_parallel: int = 1) -> Mesh:
    """The mesh of the group's ranks, JAX's ``make_mesh`` layout: (data,
    model) with ``model_parallel`` ranks on the model axis (innermost), a
    seq axis innermost of all with ``sequence_parallel``, or (data, pipe)
    with ``pipeline_parallel``; and its sub-groups.  A collective of the
    whole group: every rank calls it, with the same sizes, and creates
    every group in the same order (data, model, seq, pipe).  Replaces an
    earlier mesh."""
    global _MESH
    n = world_size()
    tp, sp, pp = int(model_parallel or 1), int(sequence_parallel or 1), int(pipeline_parallel or 1)
    validate_mesh(n, tp, sp, pp)
    r, inner = rank(), sp * pp
    d_i, m_i, s_i = r // (tp * inner), (r // inner) % tp, r % inner

    def at(d, m, s):
        return d * tp * inner + m * inner + s

    n_data = n // (tp * inner)
    data_ranks = tuple(at(d, m_i, s_i) for d in range(n_data))
    model_ranks = tuple(at(d_i, m, s_i) for m in range(tp))
    inner_ranks = tuple(at(d_i, m_i, s) for s in range(inner))
    data = model = seq = pipe = None
    if is_distributed() and 1 < tp * inner < n:
        for m in range(tp):                  # every rank creates every group, in order
            for s in range(inner):
                g = dist.new_group([at(d, m, s) for d in range(n_data)])
                if (m, s) == (m_i, s_i):
                    data = g
    if is_distributed() and tp > 1:
        for d in range(n_data):
            for s in range(inner):
                g = dist.new_group([at(d, m, s) for m in range(tp)])
                if (d, s) == (d_i, s_i):
                    model = g
    if is_distributed() and inner > 1:
        for d in range(n_data):
            for m in range(tp):
                g = dist.new_group([at(d, m, s) for s in range(inner)])
                if (d, m) == (d_i, m_i):
                    seq, pipe = (g, None) if sp > 1 else (None, g)
    _MESH = Mesh(tp, data, model, data_ranks, model_ranks, sp, pp, seq, pipe,
                 inner_ranks if sp > 1 else (r,), inner_ranks if pp > 1 else (r,))
    return _MESH


def model_size() -> int:
    return _MESH.tp if _MESH is not None else 1


def _inner() -> int:
    return _MESH.inner if _MESH is not None else 1


def model_rank() -> int:
    return (rank() // _inner()) % model_size()


def seq_size() -> int:
    return _MESH.sp if _MESH is not None else 1


def seq_rank() -> int:
    return rank() % _inner() if seq_size() > 1 else 0


def pipe_size() -> int:
    return _MESH.pp if _MESH is not None else 1


def pipe_rank() -> int:
    return rank() % _inner() if pipe_size() > 1 else 0


def data_size() -> int:
    return world_size() // (model_size() * _inner())


def data_rank() -> int:
    return rank() // (model_size() * _inner())


def _axis(group: str):
    """(process group or None for the world, size, this rank's index) of an
    axis name."""
    if group == "world":
        return None, world_size(), rank()
    if group == DATA_AXIS:
        return (_MESH.data if _MESH is not None else None), data_size(), data_rank()
    if group == MODEL_AXIS:
        return (_MESH.model if _MESH is not None else None), model_size(), model_rank()
    if group == SEQ_AXIS:
        return (_MESH.seq if _MESH is not None else None), seq_size(), seq_rank()
    if group == PIPE_AXIS:
        return (_MESH.pipe if _MESH is not None else None), pipe_size(), pipe_rank()
    raise ValueError(f"unknown mesh axis {group!r}")


def _members(group: str) -> Tuple[int, ...]:
    """The global ranks of this rank's group on ``group``'s axis, in axis order."""
    if group == "world" or _MESH is None:
        return tuple(range(world_size()))
    m = _MESH
    return {DATA_AXIS: m.data_ranks, MODEL_AXIS: m.model_ranks, SEQ_AXIS: m.seq_ranks,
            PIPE_AXIS: m.pipe_ranks}[group]


def axis_size(group: str) -> int:
    return _axis(group)[1]


def local_rank() -> int:
    """The rank's card on its host (torchrun's ``LOCAL_RANK``, else 0)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def rank_device(device: torch.device) -> torch.device:
    """``cuda`` without an index is the rank's own card, ``cuda:LOCAL_RANK``."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank())
    return device


def row_range(shape: Sequence[int]) -> Optional[Tuple[int, int]]:
    """The rows ``[r0, r1)`` of a leaf of ``shape`` that this rank's ZeRO-1
    moments cover: ``shard_over_data``'s rule, the leading dimension split
    evenly over the data axis where it divides its size; None (the whole
    leaf on every rank) for a 0-d leaf or one it does not divide."""
    w = data_size()
    if len(shape) == 0 or shape[0] % w:
        return None
    n = shape[0] // w
    return data_rank() * n, (data_rank() + 1) * n


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a tensor drawn for the global batch (the data
    ranks' batches stacked in data-index order on the leading axis); the
    model ranks of one data index keep the same rows."""
    w = data_size()
    if w == 1:
        return x
    if x.shape[0] % w:
        raise ValueError(f"a global draw of {x.shape[0]} rows does not split over {w} ranks")
    n = x.shape[0] // w
    return x[data_rank() * n:(data_rank() + 1) * n]


def randn_rows(shape: Sequence[int], generator=None, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """This rank's rows of a standard normal draw for the global batch:
    ``shape[0]`` rows per rank, every rank drawing all ``data_size()``
    data ranks' rows from the shared generator (one process: ``torch.randn``)."""
    return local_rows(torch.randn((shape[0] * data_size(),) + tuple(shape[1:]),
                                  generator=generator, dtype=dtype, device=device))


def rand_rows(shape: Sequence[int], generator=None, device=None) -> torch.Tensor:
    """``randn_rows`` for a uniform float32 draw in [0, 1)."""
    return local_rows(torch.rand((shape[0] * data_size(),) + tuple(shape[1:]),
                                 generator=generator, device=device))


def host_local_batch_slice(global_batch: int) -> slice:
    """Which rows of the global batch this rank feeds (its data index's)."""
    per = global_batch // data_size()
    return slice(data_rank() * per, (data_rank() + 1) * per)


def _buckets(sizes: Sequence[int], bucket_bytes: int) -> List[List[int]]:
    """Indices in order, cut into runs of at most ``bucket_bytes`` (a larger
    item alone)."""
    out, cur, used = [], [], 0
    for i, n in enumerate(sizes):
        if cur and used + n > bucket_bytes:
            out.append(cur)
            cur, used = [], 0
        cur.append(i)
        used += n
    if cur:
        out.append(cur)
    return out


@torch.no_grad()
def all_reduce_sum(tensors: Sequence[torch.Tensor], bucket_bytes: int = BUCKET_BYTES,
                   group: str = DATA_AXIS) -> None:
    """Sum each tensor over the ranks of ``group``'s axis, in place: the
    tensors of one dtype are packed in order into flat buffers of about
    ``bucket_bytes``, one collective per buffer.  Every rank of the group
    passes the same tensors in the same order."""
    pg, size, _ = _axis(group)
    if size == 1:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        for idx in _buckets([t.numel() * t.element_size() for t in same], bucket_bytes):
            bucket = [same[i] for i in idx]
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.all_reduce(flat, group=pg)
            for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
                t.copy_(part.view_as(t))


def _axes(group) -> Tuple[str, ...]:
    return (group,) if isinstance(group, str) else tuple(group)


@torch.no_grad()
def all_reduce_max(t: torch.Tensor, group=DATA_AXIS) -> torch.Tensor:
    """``t``'s elementwise maximum over ``group``'s axis (or over each axis
    of a tuple in turn), in place (returned): a scale that spans the batch
    (an int8 amax over a whole call, or over a column's tokens) is the
    global batch's, as XLA takes it over the data and seq axes; a row that
    spans the model axis, the whole row's.  An empty ``t`` (every rank of
    the group holds no rows alike) skips the collective."""
    for axis in _axes(group):
        pg, size, _ = _axis(axis)
        if size > 1 and t.numel():
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=pg)
    return t


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``'s axis (or each axis of a tuple), in
    place (returned); an empty ``t`` skips the collective."""
    for axis in _axes(group):
        pg, size, _ = _axis(axis)
        if size > 1 and t.numel():
            dist.all_reduce(t, group=pg)
    return t


def gather_tokens(a: torch.Tensor, group: str = SEQ_AXIS) -> torch.Tensor:
    """Every rank's tokens of a [B, n_r, ...] tensor on ``group``'s axis,
    concatenated along dim 1 in axis order: the seq ranks' chunks of one
    stream back in one process's token order.  The ranks' ``n_r`` may
    differ (a chunk of [txt; img] holds a share of each stream, maybe
    none): each chunk is padded to the largest for the gather and its pad
    rows are dropped.  ``a`` itself on one rank."""
    pg, size, _ = _axis(group)
    if size == 1:
        return a
    n = torch.tensor([a.shape[1]], dtype=torch.int64, device=a.device)
    counts = [int(c) for c in all_gather_dim(n, 0, group)]
    c = max(counts)
    if a.shape[1] < c:
        a = torch.cat([a, a.new_zeros((a.shape[0], c - a.shape[1]) + tuple(a.shape[2:]))],
                      dim=1)
    a = a.contiguous()
    parts = [torch.empty_like(a) for _ in range(size)]
    dist.all_gather(parts, a, group=pg)
    return torch.cat([p[:, :k] for p, k in zip(parts, counts)], dim=1)


def all_gather_dim(t: torch.Tensor, dim: int, group: str) -> torch.Tensor:
    """The ranks' ``t`` of ``group``'s axis concatenated along ``dim`` in
    their order on the axis (a new tensor; ``t`` itself for one rank)."""
    pg, size, _ = _axis(group)
    if size == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=pg)
    return torch.cat(parts, dim=dim)


def reduce_scatter_dim(t: torch.Tensor, dim: int, group: str) -> torch.Tensor:
    """``t`` summed over ``group``'s axis, and this rank's ``1/size`` chunk
    of ``dim``: ``dist.reduce_scatter_tensor`` on NCCL; on gloo, which has
    no reduce-scatter for CUDA tensors, an all-reduce and the rank's
    slice."""
    pg, size, idx = _axis(group)
    if size == 1:
        return t
    n = t.shape[dim] // size
    if dist.get_backend(pg) == "nccl":
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((n,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=pg)
        return out.movedim(0, dim).contiguous()
    t = t.contiguous().clone()
    dist.all_reduce(t, group=pg)
    return t.narrow(dim, idx * n, n).contiguous()


def _p2p(send: torch.Tensor, recv: torch.Tensor, dst: int, src: int, pg) -> None:
    """One ``isend`` of ``send`` to global rank ``dst`` and one ``irecv``
    into ``recv`` from ``src``, issued together and waited for."""
    ops = [dist.P2POp(dist.isend, send, dst, group=pg),
           dist.P2POp(dist.irecv, recv, src, group=pg)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()


@torch.no_grad()
def rotate(x: torch.Tensor, group: str, shift: int = 1) -> torch.Tensor:
    """JAX's ``ppermute(x, axis, [(i, (i + shift) % n)])`` on ``group``'s
    axis: this rank's ``x`` goes to axis index ``i + shift``, and the
    tensor of index ``i - shift`` comes back (a new tensor; ``x`` itself
    on one rank).  Every rank of the group calls it with the same shape
    and dtype.  On gloo a CUDA tensor travels through the host."""
    pg, n, i = _axis(group)
    if n == 1:
        return x
    ranks = _members(group)
    dst, src = ranks[(i + shift) % n], ranks[(i - shift) % n]
    x = x.detach().contiguous()
    if dist.get_backend(pg) == "nccl":
        out = torch.empty_like(x)
        _p2p(x, out, dst, src, pg)
        return out
    if not x.is_cuda:
        out = torch.empty_like(x)
        _p2p(x, out, dst, src, pg)
        return out
    # through pinned host buffers (the caching host allocator keeps them)
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    _p2p(host, out, dst, src, pg)
    return out.to(x.device)


@torch.no_grad()
def broadcast_from(t: torch.Tensor, index: int, group: str) -> torch.Tensor:
    """``t`` of the rank at axis ``index`` of ``group``'s axis on every
    rank of the group, in place (returned)."""
    pg, n, _ = _axis(group)
    if n > 1:
        dist.broadcast(t, src=_members(group)[index], group=pg)
    return t


@torch.no_grad()
def all_gather_rows(locals_: Sequence[torch.Tensor],
                    outs: Optional[Sequence[torch.Tensor]] = None,
                    bucket_bytes: int = BUCKET_BYTES,
                    group: str = DATA_AXIS) -> List[torch.Tensor]:
    """Every rank's rows of each leaf over ``group``'s axis: ``outs[i]``
    (contiguous, ``w`` times the rows of ``locals_[i]``; allocated where
    not given) receives the j-th rank's ``locals_[i]`` at rows ``[j*n,
    (j+1)*n)``.  A local that is already the rank's rows of its out (a
    parameter updated in place) is not copied onto itself.  The bytes of
    all leaves are packed in order into flat buffers of about
    ``bucket_bytes``, one ``all_gather`` per buffer: a gather moves bits,
    so one byte buffer serves every dtype."""
    pg, w, r = _axis(group)
    if outs is None:
        outs = [t.new_empty((t.shape[0] * w,) + tuple(t.shape[1:])) for t in locals_]
    if w == 1:
        for o, t in zip(outs, locals_):
            if o.data_ptr() != t.data_ptr():
                o.copy_(t)
        return list(outs)
    nbytes = [t.numel() * t.element_size() for t in locals_]
    for idx in _buckets([n * w for n in nbytes], bucket_bytes):
        send = torch.cat([locals_[i].reshape(-1).view(torch.uint8) for i in idx])
        recv = [torch.empty_like(send) for _ in range(w)]
        dist.all_gather(recv, send, group=pg)
        for j in range(w):
            off = 0
            for i in idx:
                t, o = locals_[i], outs[i]
                n = t.shape[0]
                dst = o[j * n:(j + 1) * n]
                if not (j == r and dst.data_ptr() == t.data_ptr()):
                    dst.reshape(-1).view(torch.uint8).copy_(recv[j][off:off + nbytes[i]])
                off += nbytes[i]
    return list(outs)


def broadcast_flag(flag: bool, device) -> bool:
    """Rank 0's ``flag`` on every rank (a collective: every rank calls it)."""
    if not is_distributed():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=device)
    dist.broadcast(t, src=0)
    return bool(t.item())
