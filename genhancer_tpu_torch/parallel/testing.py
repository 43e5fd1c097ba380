"""Run the port's training paths on several ranks, for tests and the smoke run.

``launch(payload, world, workdir)`` starts ``world`` processes of

    python -m genhancer_tpu_torch.parallel.testing <payload.pt>

with torchrun's ``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` set, joins them with
a timeout, and returns what each rank wrote (``start`` returns the running
launch and its ``join`` the results, so that launches can overlap).  The payload (a ``torch.save``
dict written by the caller) names a scenario and its inputs; a rank joins a
gloo group through the payload's ``init_file`` (``file://``, so that
concurrent test processes cannot collide on a port) or, without one, lets
the ``Trainer`` join the group its environment describes (NCCL on a card).
Each group has its own timeout, and a rank that fails or outlives the
launch's timeout fails the launch: a hung collective fails one call.

The scenarios:

  * ``step``: one optimizer step of a task's step function on loaded
    weights, on this rank's rows of a global batch, with the global draws
    (``draws``, sliced by data index) or a seeded generator, optionally on
    the mesh (``model_parallel``, ``fsdp``, ``fsdp_min_size``,
    ``sequence_parallel``, ``pipeline_parallel``); returns the loss, the
    norm, the reduced gradients and the parameters, gathered to the
    reference layout, and the mesh's groups.  ``control`` runs a known
    fault instead, for a test to see it miss: ``per_rank_mean`` (each seq
    rank's loss the mean over its own tokens, the ranks' mean then),
    ``no_seq_sum`` (the gradients left unsummed over seq), and the int8
    faults ``per_rank_blocks`` (K8 on the rank's own rows, its dW then
    summed), ``sum_whole_again`` (the global dW summed over data and seq
    again), ``keep_pad`` (the chunks' pad rows left in K8's rows) and
    ``per_rank_amax`` (the per-column amax of each seq rank's tokens).
    ``record`` adds every SwitchBack call (``record_switchback``);
  * ``ring``: ``parallel.ring.ring_attention`` on this rank's chunks of
    given whole q, k, v (its rows on the data axis), each case forward and
    backward against a given output cotangent; returns o, dq, dk, dv of
    its chunk and the mesh's groups, and one ``rotate`` of the rank index
    each way on the seq axis;
  * ``pp_forward``: ``parallel.pp.pipeline_dit_forward`` of loaded DiT
    weights on this rank's rows of given whole inputs (``n_micro``,
    ``remat``, ``remat_policy``), the loss the global mean of the output's squares; returns
    the rank's output and the gradients summed as the step sums them
    (``control`` ``sum_all_over_pipe``: every leaf summed over pipe);
  * ``steps``: for each variant of a config, a ``Trainer``, ``steps``
    optimizer steps on this rank's rows of seeded global image batches
    (or of given global micro-batches, ``batches``), driven as the train
    loop drives them (with ``linears``, that scenario's payload, run
    first; with ``ring``, that one's run after; ``control`` a fault of the
    ``step`` scenario planted first); per step the loss, digests of
    the parameters and the int8 cache, the kernels' launches;
    at the end the gathered optimizer state, the resident parameter and
    moment bytes, the ZeRO-1 row ranges and the mesh's groups;
  * ``linears``: linears at given whole weights under DiT paths, placed
    on the model axis (``tp``), one forward and backward each through
    ``core.nn.linear`` inside a SwitchBack context (``dw``, reading the int8
    cache with ``cached``) on the rank's part of given whole inputs and
    output gradients; returns y, dx, dW, the bias's gradient and the cache,
    gathered whole;
  * ``int8_scales``: the int8 quantizers whose scales span a batch (a
    conv input's per-tensor, the dW's per-column) on this rank's rows of
    given global tensors, and the per-column int8 dW of the rank's rows (the
    global rows' on every rank);
  * ``dcp``: ``train.orbax_ckpt``'s save and restore of a placed task
    state (``scenario_dcp``);
  * ``serve``: a mesh ``InferenceEngine`` answering requests on rank 0,
    directly and through the HTTP server, the other ranks following
    (``scenario_serve``);
  * ``train``: a ``Trainer`` on its config, ``train()`` run to its end
    (optionally on this rank's rows of given global batches, optionally
    with rank 0's SIGTERM flag raised after a step); returns the history,
    the saved steps, the kernels' launches, the peak device
    memory and the final parameters (or their digests) and gathered
    moments.

The workers import torch and this package only.
"""

from __future__ import annotations

import contextlib
import datetime
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..tracing import launch_counts
from . import mesh as _mesh
from .mesh import local_rows

ROOT = Path(__file__).resolve().parents[2]
GROUP_TIMEOUT = 120.0


def digest(t: torch.Tensor) -> str:
    """A checksum of ``t``'s bits, computed where it lies: its dtype and
    shape, the sum of its 32-bit words and their position-weighted sum."""
    b = t.detach().contiguous().reshape(-1).view(torch.uint8)
    if b.numel() % 4:
        b = torch.cat([b, b.new_zeros(4 - b.numel() % 4)])
    x = b.view(torch.int32).to(torch.int64)
    w = torch.arange(x.numel(), device=x.device, dtype=torch.int64) % 1_000_003 + 1
    return f"{str(t.dtype)[6:]}{list(t.shape)}:{int(x.sum())}:{int((x * w).sum())}"


def moment_bytes(opt_state) -> int:
    """The bytes of the moment tensors the optimizer state holds."""
    total = 0
    for name in ("mu", "nu"):
        for leaf in opt_state[name].values():
            for t in (leaf if isinstance(leaf, tuple) else (leaf,)):
                total += t.numel() * t.element_size()
    return total


def expected_moment_bytes(trainable, opt_state) -> int:
    """The bytes the moments of ``trainable`` take when each leaf keeps the
    rows its ZeRO-1 range names (all rows elsewhere), in the dtypes of
    ``opt_state``'s moments."""
    rows = opt_state.get("rows", {})
    total = 0
    for name in ("mu", "nu"):
        for key, p in trainable.items():
            n = rows[key][1] - rows[key][0] if key in rows else (p.shape[0] if p.dim() else 1)
            per_row = p.numel() // max(p.shape[0], 1) if p.dim() else 1
            leaf = opt_state[name][key]
            if isinstance(leaf, tuple):     # Moment8: codes and one scale per row
                total += n * per_row * leaf.q.element_size() + n * leaf.s.element_size()
            else:
                total += n * per_row * leaf.element_size()
    return total


# the head counts of the DiT attention calls this process made (``_spy_heads``)
HEADS: set = set()


def _spy_heads() -> None:
    """Record the head count of every DiT attention call (K1's and K5's
    wrappers, read by ``core.attention`` at each call) in ``HEADS``."""
    from ..core.kernels import flash_attention as FA
    from ..core.kernels import short_attention as SA
    for mod, name in ((SA, "fused_rope_attention"), (FA, "flash_attention")):
        real = getattr(mod, name)
        if getattr(real, "_spied", False):
            continue

        def spy(q, *a, _real=real, **kw):
            HEADS.add(int(q.shape[2]))
            return _real(q, *a, **kw)
        spy._spied = True
        setattr(mod, name, spy)


class RowsLoader:
    """A loader over given global batches (dicts of numpy arrays with the
    global batch on axis 0): yields this rank's rows of each, in order."""

    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        from .mesh import host_local_batch_slice
        for b in self.batches:
            arrays = {k: v for k, v in b.items() if isinstance(v, np.ndarray)}
            rows = host_local_batch_slice(next(iter(arrays.values())).shape[0])
            yield {**b, **{k: v[rows] for k, v in arrays.items()}}

    def close(self) -> None:
        pass


def _patch_registry(overrides: Optional[dict]) -> None:
    """Replace the registry's model configs (``dit``, ``vae``, ``tower``:
    port config dataclasses) for this process."""
    from .. import registry
    overrides = overrides or {}
    if "dit" in overrides:
        registry.build_dit_config = lambda name: overrides["dit"]
    if "vae" in overrides:
        registry.build_vae_config = lambda name, ae_path=None: overrides["vae"]
    if "tower" in overrides:
        registry.tower_family_and_config = (
            lambda tower, size, clip_type=None: ("clip", overrides["tower"]))


def _rows(x, axis: int):
    from .mesh import data_rank, data_size
    n = x.shape[axis] // data_size()
    return x.narrow(axis, data_rank() * n, n)


def full_params(state) -> Dict[str, torch.Tensor]:
    """The trainable parameters in the reference layout (the sharded ones
    gathered: a collective)."""
    from .layout import gather
    return {k: gather(v.detach(), state.layout.get(k)) for k, v in state.trainable.items()}


def mesh_groups() -> dict:
    """This rank's data, model, seq and pipe indices and the ranks of its
    groups on those axes."""
    from . import mesh
    m = mesh._MESH
    return {"rank": mesh.rank(), "data_index": mesh.data_rank(),
            "model_index": mesh.model_rank(), "seq_index": mesh.seq_rank(),
            "pipe_index": mesh.pipe_rank(),
            "data_group": list(m.data_ranks) if m else list(range(mesh.world_size())),
            "model_group": list(m.model_ranks) if m else [mesh.rank()],
            "seq_group": list(m.seq_ranks) if m else [mesh.rank()],
            "pipe_group": list(m.pipe_ranks) if m else [mesh.rank()]}


def resident_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class _Recorder:
    """Delegates to an optimizer and keeps the (reduced) grads it was given."""

    def __init__(self, inner):
        self.inner, self.grads = inner, None
        self.emit_quant = getattr(inner, "emit_quant", False)

    def init(self, params, **kw):
        return self.inner.init(params, **kw)

    def apply(self, params, grads, state, **kw):
        self.grads = {k: g.detach().clone() for k, g in grads.items()}
        return self.inner.apply(params, grads, state, **kw)


def scenario_step(p: dict) -> dict:
    from ..tasks import image, video
    from ..train.config import Config
    from ..train.optim import make_optimizer
    from ..train.state import create_state, mark_whole_grads, place_state, with_quant_cache
    from ..train.step_utils import make_accum_train_step
    from .layout import gather
    from .mesh import make_mesh
    task = image if p["task"] == "image" else video
    spec, accum = p["spec"], int(p.get("accum", 1))
    mods = task.init_modules(spec, torch.Generator().manual_seed(0))
    mods.load_state_dict(p["state_dict"])
    rec = _Recorder(make_optimizer(Config._wrap(p["opt_cfg"]),
                                   emit_quant=bool(p.get("emit_quant"))))
    tp = int(p.get("model_parallel", 1))
    # the mesh first: the ZeRO-1 rows split over its data axis
    mesh = make_mesh(tp, spec.sequence_parallel, spec.pipeline_parallel)
    state = create_state(mods, task.trainable_predicate(spec, mods), rec)
    mark_whole_grads(state, spec.dit_quant)
    if p.get("control") in ("per_rank_blocks", "sum_whole_again"):
        state.whole = ()
    place_state(state, rec, tp, bool(p.get("fsdp")), p.get("fsdp_min_size"),
                spec.dit_cfg.hidden_size)
    if spec.dit_quant_cache and spec.dit_quant != "none":
        with_quant_cache(state)
    _control(p.get("control"))
    calls = record_switchback(state)[0] if p.get("record") else None
    step = (make_accum_train_step(task.make_loss_fn(spec, mesh), rec, accum) if accum > 1
            else task.make_train_step(spec, rec, mesh))
    batch = {k: _rows(v, 1 if accum > 1 else 0) for k, v in p["batch"].items()}
    draws = p.get("draws")
    if draws is not None:
        draws = [{k: [local_rows(m) for m in v] if isinstance(v, list) else local_rows(v)
                  for k, v in d.items()} for d in draws]
        if accum == 1:
            draws = draws[0]
    gen = torch.Generator().manual_seed(int(p.get("seed", 0)))
    state, m = step(state, batch, gen, draws)
    return {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
            "grads": {k: gather(g, state.layout.get(k)) for k, g in rec.grads.items()},
            "params": full_params(state), "groups": mesh_groups(),
            "local_shapes": {k: tuple(v.shape) for k, v in state.trainable.items()},
            "caches": {k: list(_whole_cache(state, k)) for k in (state.quant or {})},
            "calls": calls}


class _Tap(torch.autograd.Function):
    """Identity whose backward keeps the gradient that reaches it."""

    @staticmethod
    def forward(ctx, a, rec, key):
        ctx.rec, ctx.key = rec, key
        return a.clone()

    @staticmethod
    def backward(ctx, g):
        ctx.rec[ctx.key] = g.detach().to(ctx.rec["store"], copy=True)
        return g, None, None


def record_switchback(state, store=None) -> list:
    """Record every SwitchBack call of this process from now on, in call
    order: the weight's flat path, how its rows lie on the seq axis
    (``core.quant.row_split``), the dW kind, the inputs and the cache read,
    the output; the backward adds the output's gradient g as it reached
    the call (the rank's share, for a "vector" call), the dx and dW the
    call returned, and K8's operands as the call's backward built them
    (``k8``: ``core.quant.global_rows`` of g and of x).  ``store``: the
    device the copies are kept on (the call's own by default); returns
    (the records, a function that stops the recording)."""
    from ..core import quant
    names = {v.data_ptr(): k for k, v in state.trainable.items()}
    calls, orig = [], quant.switchback
    fwd, bwd, rows = quant._SwitchBack.forward, quant._SwitchBack.backward, quant.global_rows
    now = {"fwd": None, "bwd": None}

    def keep(t, to):
        return None if t is None else t.detach().to(to, copy=True)

    def spy(x, w, wq=None, ws=None, dw="bf16", **kw):
        to = store or x.device
        rec = dict(path=names.get(w.data_ptr()), split=quant.row_split(x), dw_kind=dw,
                   store=to, device=x.device, x=keep(x, to), w=keep(w, to),
                   wq=keep(wq, to), ws=keep(ws, to))
        now["fwd"] = rec
        try:
            y = orig(_Tap.apply(x, rec, "dx"), _Tap.apply(w, rec, "dW"), wq, ws, dw, **kw)
        finally:
            now["fwd"] = None
        rec["y"] = keep(y, to)
        calls.append(rec)
        return _Tap.apply(y, rec, "g")

    def forward(ctx, *args):
        ctx.record = now["fwd"]
        return fwd(ctx, *args)

    def backward(ctx, g):
        now["bwd"] = getattr(ctx, "record", None)
        try:
            return bwd(ctx, g)
        finally:
            now["bwd"] = None

    def global_rows(a, split=None):
        out = rows(a, split)
        rec = now["bwd"]
        if rec is not None:
            rec.setdefault("k8", []).append(keep(out, rec["store"]))
        return out

    quant.switchback, quant.global_rows = spy, global_rows
    quant._SwitchBack.forward = staticmethod(forward)
    quant._SwitchBack.backward = staticmethod(backward)

    def undo():
        quant.switchback, quant.global_rows = orig, rows
        quant._SwitchBack.forward = staticmethod(fwd)
        quant._SwitchBack.backward = staticmethod(bwd)
    return calls, undo


def _control(name: Optional[str]) -> None:
    """Plant the fault ``name`` of the ``step`` scenario in this process."""
    if name is None:
        return
    from . import mesh
    from ..train import flow
    if name == "per_rank_mean":
        real = flow.mse_loss

        def per_rank(pred, target, mask=None, tokens=None):
            return real(pred, target, mask) / mesh.seq_size()
        flow.mse_loss = per_rank
    elif name == "no_seq_sum":
        real_sum = mesh.all_reduce_sum

        def no_seq(tensors, *a, group=mesh.DATA_AXIS, **kw):
            if group != mesh.SEQ_AXIS:
                real_sum(tensors, *a, group=group, **kw)
        mesh.all_reduce_sum = no_seq
    elif name == "per_rank_blocks":        # K8 on the rank's own rows (with sum_whole_again)
        from ..core import quant
        quant.global_rows = lambda a, split=None: a.reshape(-1, a.shape[-1])
    elif name == "keep_pad":               # the chunks' pad rows left in K8's rows
        real_gather = mesh.gather_tokens

        def keep_pad(a, group=mesh.SEQ_AXIS):
            if mesh.axis_size(group) == 1:
                return a
            n = mesh.all_gather_dim(torch.tensor([a.shape[1]], device=a.device), 0, group)
            pad = int(n.max()) - a.shape[1]
            if pad:
                a = torch.cat([a, a.new_zeros((a.shape[0], pad) + tuple(a.shape[2:]))], dim=1)
            return mesh.all_gather_dim(a, 1, group)
        keep_pad.real = real_gather
        mesh.gather_tokens = keep_pad
    elif name == "per_rank_amax":          # the per-column amax of each seq rank's tokens
        real_max = mesh.all_reduce_max

        def no_seq_max(t, group=mesh.DATA_AXIS):
            axes = (group,) if isinstance(group, str) else tuple(group)
            return real_max(t, tuple(a for a in axes if a != mesh.SEQ_AXIS))
        mesh.all_reduce_max = no_seq_max
    elif name == "share_quantized":        # a vector call quantizes its rank's share of g
        from ..core import quant
        quant._seq_total = lambda g, split: g
    elif name != "sum_whole_again":        # that one: the step's ``whole`` left empty
        raise ValueError(f"unknown control {name!r}")


def scenario_ring(p: dict) -> dict:
    from . import mesh
    from .ring import chunk, ring_attention
    dev = torch.device(p.get("device", "cpu"))
    if dev.type == "cuda":
        dev = mesh.rank_device(dev)
    mesh.make_mesh(1, int(p["sp"]))
    n, r = mesh.seq_size(), mesh.seq_rank()
    out = {"groups": mesh_groups(), "cases": [],
           "rotated": [int(mesh.rotate(torch.tensor([mesh.rank()], device=dev),
                                       mesh.SEQ_AXIS, s)) for s in (1, -1)]}
    for case in p["cases"]:
        q, k, v, g = (local_rows(case[x]).to(dev) for x in ("q", "k", "v", "g"))
        (qc, lengths), (kc, _), (vc, _), (gc, _) = (chunk(x, n, r) for x in (q, k, v, g))
        qc, kc, vc = (x.clone().requires_grad_(True) for x in (qc, kc, vc))
        _sync(dev)
        t0 = time.perf_counter()
        o = ring_attention(qc, kc, vc, lengths)
        _sync(dev)
        t1 = time.perf_counter()
        o.backward(gc)
        _sync(dev)
        out["cases"].append({"o": o.detach().cpu(), "dq": qc.grad.cpu(), "dk": kc.grad.cpu(),
                             "dv": vc.grad.cpu(), "lengths": lengths,
                             "fwd_s": t1 - t0, "bwd_s": time.perf_counter() - t1})
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def scenario_pp_forward(p: dict) -> dict:
    from . import mesh
    from .pp import pipe_owned, pipeline_dit_forward
    from ..models import dit as dit_m
    mesh.make_mesh(1, 1, int(p["pp"]))
    dit = dit_m.DiT(p["cfg"], dtype=torch.float32)
    dit.load_state_dict(p["state_dict"])
    inputs = {k: local_rows(v) for k, v in p["inputs"].items()}
    out = pipeline_dit_forward(dit, p["cfg"], n_micro=int(p["n_micro"]),
                               remat=bool(p.get("remat")),
                               remat_policy=p.get("remat_policy"), **inputs)
    total = out.numel() * mesh.data_size()
    (out.float().square().sum() / total).backward()
    grads = {"dit." + k: v.grad if v.grad is not None else torch.zeros_like(v)
             for k, v in dit.named_parameters()}
    mesh.all_reduce_sum(list(grads.values()))
    pipe = list(grads.values()) if p.get("control") == "sum_all_over_pipe" else [
        g for k, g in grads.items() if pipe_owned(k)]
    mesh.all_reduce_sum(pipe, group=mesh.PIPE_AXIS)
    return {"out": out.detach(), "grads": grads, "groups": mesh_groups()}


def _whole_cache(state, key):
    """The int8 cache of ``key`` (codes, scales) in the reference layout."""
    from .layout import gather
    pl = state.layout.get(key)
    wq, ws = state.quant[key]
    return gather(wq, pl), gather(ws, pl.like((pl.shape[0],)) if pl else None)


def _spy_int8_operands(rec: dict) -> None:
    """Record, per call, the operands K8 receives (``int8_dw``: g2, x2) and
    the codes and scales of the per-column quantizer, under the key
    ``rec["path"]`` (the linear being run)."""
    from ..core import quant
    from ..core.kernels import int8_dw as K8
    real_dw, real_cols = K8.int8_dw, quant._quantize_cols
    if getattr(real_dw, "_spied", False):
        return

    def dw(g2, x2, out_dtype=torch.float32):
        rec.setdefault(rec["path"], {})["k8"] = (g2.detach().cpu(), x2.detach().cpu())
        return real_dw(g2, x2, out_dtype)

    def cols(x2, axes=(_mesh.DATA_AXIS,)):
        q, s = real_cols(x2, axes)
        rec.setdefault(rec["path"], {}).setdefault("cols", []).append((q.cpu(), s.cpu()))
        return q, s
    dw._spied = True
    K8.int8_dw, quant._quantize_cols = dw, cols


def _seq_share(g: torch.Tensor) -> torch.Tensor:
    """This seq rank's share of a whole gradient ``g`` whose shares sum to
    it exactly: index 0 holds g rounded to bf16, index 1 the rest (exact
    in float32), any other index zero."""
    g0 = g.to(torch.bfloat16).to(g.dtype)
    return {0: g0, 1: g - g0}.get(_mesh.seq_rank(), torch.zeros_like(g))


def scenario_linears(p: dict) -> dict:
    """See the module docstring; ``dp``/``sp`` add data ranks (each keeps
    its rows of x and g) and seq ranks (a [B, L, C] input: each keeps its
    chunk of the tokens, under the ring's scope; a [B, C] "vector" input:
    each keeps x whole and a share of g).  The gradients pass
    ``train.state.reduce_gradients`` as the step's do (the int8 dW kinds
    are ``whole``); y, dx and dW come back whole, with K8's operands and
    the per-column codes each rank saw (``control``: ``per_rank_blocks``,
    ``sum_whole_again``, ``keep_pad``, ``per_rank_amax``, or a list of
    them); ``dw`` a list of kinds runs each in turn: {kind: result}."""
    from .mesh import make_mesh
    sp = int(p.get("sp", 1))
    make_mesh(int(p["tp"]), sp)
    controls = p.get("control") or ()
    controls = (controls,) if isinstance(controls, str) else tuple(controls)
    for name in controls:
        _control(name)
    rec = {"path": None}
    _spy_int8_operands(rec)
    if not isinstance(p["dw"], str):        # several dW kinds: {kind: result}
        return {dw: _linears(p, dw, sp, controls, rec) for dw in p["dw"]}
    return _linears(p, p["dw"], sp, controls, rec)


def _linears(p: dict, dw: str, sp: int, controls, rec: dict) -> dict:
    from torch import nn as tnn
    from ..core import nn, quant
    from ..core.quant import quantize_cache
    from ..train.state import TrainState, reduce_gradients
    from . import ring
    from .layout import Placement, gather, place, shard
    from .mesh import DATA_AXIS, MODEL_AXIS, all_gather_dim, gather_tokens
    gather_tokens = getattr(gather_tokens, "real", gather_tokens)    # keep_pad spares the result
    for k in [k for k in rec if k != "path"]:
        del rec[k]
    root = tnn.ModuleDict()
    for path, (w, b) in p["weights"].items():     # a Linear at each dotted path
        parent, parts = root, path.split(".")
        for name in parts[:-1]:
            if name not in parent._modules:
                parent.add_module(name, tnn.ModuleDict())
            parent = parent._modules[name]
        lin = nn.Linear(w.shape[1], w.shape[0], device=w.device, dtype=w.dtype)
        with torch.no_grad():
            lin.weight.copy_(w)
            lin.bias.copy_(b)
        parent.add_module(parts[-1], lin)
    if p.get("static"):       # the static int8 base (a frozen int8 DiT, stage2_only)
        quant.quantize_lora_base(root, min_features=1)
    layout = place(root, int(p["tp"]), hidden=int(p["hidden"]))
    cache = (quantize_cache(dict(root.named_parameters()),
                            [k + ".weight" for k in p["weights"]], layout)
             if p.get("cached") else {})
    params = dict(root.named_parameters())
    whole = tuple(k + ".weight" for k in p["weights"]) if (
        dw in quant.GLOBAL_DW and not {"per_rank_blocks", "sum_whole_again"} & set(controls)
    ) else ()
    state = TrainState(root, params, {}, {}, layout=layout, whole=whole)
    scope = ring.ring_scope if sp > 1 else contextlib.nullcontext
    out = {}
    for path in p["weights"]:
        rec["path"] = path
        lin, pl = root.get_submodule(path), layout.get(path + ".weight")
        x, g = local_rows(p["x"][path]), local_rows(p["g"][path])
        tokens = sp > 1 and x.dim() == 3
        if tokens:
            lay = ring.token_layout(x.shape[1], 0)
            x, g = x[:, lay.txt], g[:, lay.txt]
        elif sp > 1:
            g = _seq_share(g)
        # the model-sharded columns of x (row-parallel) or of y and g (column)
        tp_mode = getattr(lin, "tp_mode", None) if pl is not None else None
        if tp_mode is not None:
            n = pl.shape[1 if tp_mode == "row" else 0]
            cols = Placement(tuple(x.shape[:-1]) + (n,),
                             (None,) * (x.dim() - 1) + (MODEL_AXIS,), pl.index)
            if tp_mode == "row":
                x = shard(x, cols)
            else:
                g = shard(g, cols)
        if path + ".weight" in cache:
            wq, ws = cache[path + ".weight"]
            lin.register_buffer("weight_sb_q", wq, persistent=False)
            lin.register_buffer("weight_sb_scale", ws, persistent=False)
        x = x.clone().requires_grad_(True)
        with nn.int8_training_ctx(full=dw == "cols", dw_int8=dw == "int8_dw"), scope():
            y = nn.linear(lin, x)
            y.backward(g)
        y, dx = y.detach(), x.grad
        if tp_mode == "row":
            dx = gather(dx, Placement(tuple(dx.shape[:-1]) + (pl.shape[1],), cols.spec, pl.index))
        elif tp_mode == "col":
            y = gather(y, Placement(tuple(y.shape[:-1]) + (pl.shape[0],), cols.spec, pl.index))
        if tokens:
            y, dx = gather_tokens(y), gather_tokens(dx)
        elif sp > 1:          # a vector's dx counts once over the seq ranks
            dx = _mesh.all_reduce_(dx.clone(), _mesh.SEQ_AXIS)
        y, dx = all_gather_dim(y, 0, DATA_AXIS), all_gather_dim(dx, 0, DATA_AXIS)
        grads = {k: g for k, g in ((path + ".weight", lin.weight.grad),
                                    (path + ".bias", lin.bias.grad)) if g is not None}
        local_dw = None if lin.weight.grad is None else lin.weight.grad.clone()
        reduce_gradients(state, grads)
        out[path] = {"y": y, "dx": dx, "dw": gather(grads.get(path + ".weight"), pl)
                     if local_dw is not None else None,
                     "dw_local": local_dw,
                     "split": "tokens" if tokens else ("vector" if sp > 1 else None),
                     "db": gather(grads[path + ".bias"], layout.get(path + ".bias")),
                     **rec.get(path, {})}
        if path + ".weight" in cache:
            wq, ws = cache[path + ".weight"]
            out[path]["cache"] = (gather(wq, pl), gather(ws, pl.like((pl.shape[0],))))
    return out


def scenario_int8_scales(p: dict) -> dict:
    from ..core import quant
    from .mesh import local_rows
    # the per-column dW of the rank's rows is the global rows' on every rank
    dw = quant._int8_dw_cols(local_rows(p["g2"]), local_rows(p["x2"]), torch.float32)
    return {"x": quant.quantize_activation_tensor(local_rows(p["x"])),
            "g": quant._quantize_cols(local_rows(p["g2"])), "dw": dw}


def global_images(step: int, batch: int, size: int, accum: int, seed: int = 0) -> dict:
    """The global batch of step ``step``: uniform images [batch, size, size,
    3] float32 (``[accum, batch, ...]`` with accumulation), from a seed."""
    rng = np.random.default_rng(seed * 1_000_003 + step)
    shape = ((accum,) if accum > 1 else ()) + (batch, size, size, 3)
    return {"image": rng.random(shape, dtype=np.float32)}


def run_steps(trainer, steps: int, keep_tensors: bool = False, seed: int = 0,
              batches: Optional[list] = None, start: int = 0) -> dict:
    """``steps`` optimizer steps of ``trainer`` on this rank's rows of the
    seeded global image batches (``global_images``), or of ``batches``
    (global micro-batches of any task, their array leaves, ``accum`` per
    step, in order), seeded and stepped as the train loop does; see the
    module docstring for what it returns."""
    from ..train import checkpoint as ckpt
    from .mesh import data_size, host_local_batch_slice
    dev, accum = trainer.device, trainer.accum
    per_rank = int(trainer.cfg.get_path("data_config.train_batch_size"))
    size = int(trainer.cfg.get_path("data_config.img_size", 224))
    out = {"loss": [], "params": [], "caches": [], "launches": [], "step_s": []}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(steps):
        step = trainer.state.step
        if batches is not None:
            i = start + len(out["loss"])
            micro = batches[i * accum:(i + 1) * accum]
            keys = [k for k, v in micro[0].items() if isinstance(v, np.ndarray)]
            g = {k: (np.stack([m[k] for m in micro]) if accum > 1 else micro[0][k])
                 for k in keys}
        else:
            g = global_images(step, per_rank * data_size(), size, accum, seed)
        rows = host_local_batch_slice(next(iter(g.values())).shape[1 if accum > 1 else 0])
        batch = {k: torch.from_numpy(np.ascontiguousarray(
            v[:, rows] if accum > 1 else v[rows])).to(dev) for k, v in g.items()}
        before = launch_counts()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        trainer._seed(step)
        trainer.state, m = trainer.step_fn(trainer.state, batch, trainer.generator)
        out["loss"].append(float(m["loss"]))
        out["step_s"].append(time.perf_counter() - t0)
        out["launches"].append({k: v - before[k] for k, v in launch_counts().items()})
        out["params"].append({k: digest(v) for k, v in trainer.state.trainable.items()})
        out["caches"].append({k: [digest(t) for t in v]
                              for k, v in (trainer.state.quant or {}).items()})
    opt = trainer.state.opt_state
    sd = ckpt.optimizer_state_dict(trainer.state)      # gathers the ZeRO-1 rows
    st = trainer.state
    full = full_params(st)
    if dev.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out.update(moments={k: digest(v) for k, v in sd.items()},
               moment_bytes=moment_bytes(opt),
               moment_bytes_expected=expected_moment_bytes(st.trainable, opt),
               param_bytes=resident_bytes(st.trainable.values()),
               frozen_bytes=resident_bytes([*st.frozen.values(), *(
                   b for n, b in st.modules.named_buffers()
                   if n.endswith((".weight_q", ".w_scale")))]),
               param_bytes_whole=resident_bytes(full.values()),
               sharded={k: list(pl.spec) for k, pl in st.layout.items()},
               full_params={k: digest(v) for k, v in full.items()},
               rows={k: list(r) for k, r in opt.get("rows", {}).items()},
               leaves=len(st.trainable), groups=mesh_groups())
    if keep_tensors:
        out["tensors"] = {
            "params": {k: v.detach().cpu().clone() for k, v in full.items()},
            "moments": {k: v.cpu().clone() for k, v in sd.items()},
            "caches": {k: [t.cpu().clone() for t in _whole_cache(st, k)]
                   for k in (st.quant or {})}}
    return out


def plan_vs_live(trainer) -> dict:
    """``train.plan``'s per-rank static bytes of the trainer's config on
    this world against the bytes its live state holds (call it before the
    first step: the chain promotes its moments to float32 there), with the
    activation estimate."""
    from ..train import plan as plan_m
    from . import mesh
    e = plan_m.plan(trainer.cfg, num_devices=mesh.world_size(), hbm_gb=80.0)["configured"]
    return {"live": plan_m.live_bytes(trainer.state),
            "plan": {k: round(e[f"{k}_gib"] * plan_m.GiB)
                     for k in ("trainable", "frozen", "opt_state")},
            "activations_est": e["activations_gib_est"] * plan_m.GiB,
            "note": e["activation_note"]}


def dcp_round_trip(trainer, out_dir: str) -> dict:
    """The sharded checkpoint backend on a trainer's live state: save it
    (``train.orbax_ckpt``), restore it into a fresh ``Trainer`` of the same
    config (another state: the init), compare every block bit for bit and
    the ZeRO-1 rows, then one more step on both on the same batch.  A
    collective: every rank calls it."""
    from ..train import orbax_ckpt
    from ..train.trainer import Trainer
    from . import mesh
    st, step = trainer.state, trainer.state.step
    _sync(trainer.device)
    t0 = time.perf_counter()
    path = orbax_ckpt.save_sharded(st, out_dir, step)
    save_s = time.perf_counter() - t0
    saved = {k: digest(v) for k, v in orbax_ckpt.entries(st).items()}
    fresh = Trainer(trainer.cfg.merged_with({"resume_from_checkpoint": None}),
                    device=trainer.device)
    fresh.loader.close()
    before = sum(digest(v) == saved[k] for k, v in orbax_ckpt.entries(fresh.state).items())
    _sync(trainer.device)
    t0 = time.perf_counter()
    orbax_ckpt.restore_sharded(fresh.state, out_dir, step)
    _sync(trainer.device)
    restore_s = time.perf_counter() - t0
    restored = {k: digest(v) for k, v in orbax_ckpt.entries(fresh.state).items()}
    caches = [{k: [digest(t) for t in v] for k, v in (x.state.quant or {}).items()}
              for x in (trainer, fresh)]
    a, b = run_steps(trainer, 1), run_steps(fresh, 1)
    out = {"step": step, "keys": len(saved), "sharded": sum("@" in k for k in saved),
           "equal_before": before, "restored_equal": restored == saved,
           "rows_equal": fresh.state.opt_state.get("rows") == st.opt_state.get("rows"),
           "count": (fresh.state.opt_state["count"], st.opt_state["count"]),
           "cache_equal": caches[0] == caches[1],
           "next_loss": (a["loss"][0], b["loss"][0]),
           "next_equal": a["loss"] == b["loss"] and a["params"] == b["params"]
           and a["caches"] == b["caches"],
           "bytes": orbax_ckpt.rank_bytes(path, mesh.rank()), "save_s": save_s,
           "restore_s": restore_s}
    del fresh
    return out


def _one_process_rows(g: torch.Tensor, x: torch.Tensor, split: Optional[str]):
    """The rows of a SwitchBack call's g and x that one process holds, in
    its order, built apart from ``core.quant.global_rows`` on a data axis
    of size 1: a token call's chunks come from every seq rank as objects,
    each its rank's real tokens of every sample (``ring.Layout``: no pad
    row), and are laid out sample by sample in seq order; a vector call's
    gradient is the sum of the seq ranks' shares in seq order (exact on
    two ranks), its x the rank's own (whole on every seq rank).  On the
    host."""
    import torch.distributed as dist
    pg, size, _ = _mesh._axis(_mesh.SEQ_AXIS)

    def every(a):
        if size == 1:
            return [a.detach().cpu()]
        parts = [None] * size
        dist.all_gather_object(parts, a.detach().cpu(), group=pg)
        return parts

    if split == "tokens":
        out = []
        for a in (g, x):
            parts = every(a)
            out.append(torch.cat([p[b] for b in range(a.shape[0]) for p in parts], 0))
        return out
    if split == "vector":
        shares = every(g)
        g = sum(shares[1:], shares[0])
    return [a.detach().cpu().reshape(-1, a.shape[-1]) for a in (g, x)]


def hold_switchback_calls(calls: list) -> dict:
    """Each SwitchBack call this rank recorded (``record_switchback``)
    against one process on the same whole inputs, on the same device: the
    call's x and g joined over the seq ranks (a token call's chunks in
    order, a vector call's gradient shares summed) and the data ranks, the
    one-process call run on them; y, dx and dW within 1e-5 of their largest
    element, and the codes and scales that span tokens bit for bit: K8's
    operands as the step built them against one process's rows, built
    apart from ``core.quant.global_rows`` (``_one_process_rows``); the
    per-column codes and scales against one process's quantization of the
    joined rows.  A collective: every rank calls it with its records of
    the same calls; the one-process calls run on every rank, so the data
    axis must be of size 1 (the seq axis joins the tokens)."""
    from ..core import nn, quant
    from . import mesh
    from .mesh import DATA_AXIS, SEQ_AXIS
    if mesh.data_size() != 1:
        raise ValueError("hold_switchback_calls: the one-process calls need a data axis of "
                         f"size 1, this mesh's is {mesh.data_size()}")

    def join(a, split):
        if split == "tokens":
            a = mesh.gather_tokens(a, SEQ_AXIS)
        return mesh.all_gather_dim(a, 0, DATA_AXIS)

    def rel(a, b):
        return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))

    worst = {"y": 0.0, "dx": 0.0, "dW": 0.0}
    codes_equal, n = 0, 0
    for c in calls:
        c = {k: v.to(c["device"]) if isinstance(v, torch.Tensor) else v for k, v in c.items()}
        split, kind = c["split"], c["dw_kind"]
        g = mesh.all_reduce_(c["g"].clone(), SEQ_AXIS) if split == "vector" else c["g"]
        xj, gj = join(c["x"], split), join(g, split)
        x1 = xj.clone().requires_grad_(True)
        w1 = c["w"].clone().requires_grad_(True)
        with nn.int8_training_ctx(full=kind == "cols", dw_int8=kind == "int8_dw"):
            y1 = quant.switchback(x1, w1, c["wq"], c["ws"], kind)
        y1.backward(gj)
        dx = c["dx"]
        if split == "vector":
            dx = mesh.all_reduce_(dx.clone(), SEQ_AXIS)
        got = {"y": join(c["y"], split if split == "tokens" else None),
               "dx": join(dx, split if split == "tokens" else None), "dW": c["dW"]}
        for k, ref in (("y", y1), ("dx", x1.grad), ("dW", w1.grad)):
            worst[k] = max(worst[k], rel(got[k], ref.detach()))
        # the quantizers that span the call's rows, as the step ran them
        if kind == "int8_dw":
            k8 = c.get("k8") or ()
            ok = len(k8) == 2 and all(
                torch.equal(got.to(ref.device), ref)
                for got, ref in zip(k8, _one_process_rows(c["g"], c["x"], split)))
        else:
            axes = (DATA_AXIS, SEQ_AXIS) if split == "tokens" else (DATA_AXIS,)
            ok = True
            for local, whole in ((g, gj), (c["x"], xj)):
                q, sc = quant._quantize_cols(local.reshape(-1, local.shape[-1]), axes)
                q1, s1 = quant._quantize_cols(whole.reshape(-1, whole.shape[-1]), ())
                q = join(q.reshape(local.shape), split if split == "tokens" else None)
                ok = ok and torch.equal(sc, s1) and torch.equal(q.reshape(q1.shape), q1)
        codes_equal += int(ok)
        n += 1
    return {"calls": n, "codes_equal": codes_equal, "worst": worst,
            "kinds": sorted({c["dw_kind"] for c in calls}),
            "splits": sorted({str(c["split"]) for c in calls})}


def scenario_steps(p: dict) -> dict:
    from ..train.config import Config
    from ..train.trainer import Trainer
    _patch_registry(p.get("registry"))
    _spy_heads()
    _control(p.get("control"))
    runs = {}
    linears = scenario_linears(p["linears"]) if p.get("linears") else None
    for name, overrides in p["variants"].items():
        HEADS.clear()
        overrides = dict(overrides)
        reg = overrides.pop("__registry__", None)
        if reg is not None:
            _patch_registry(reg)
        trainer = Trainer(Config._wrap(p["cfg"]).merged_with(overrides), device=p["device"])
        trainer.loader.close()
        plan = plan_vs_live(trainer) if p.get("plan") else None
        steps = int(p["steps"])
        held = None
        if p.get("hold_calls"):         # the last step's SwitchBack calls, held in-rank
            runs[name] = run_steps(trainer, steps - 1, batches=p.get("batches"))
            calls, undo = record_switchback(trainer.state, p.get("hold_store"))
            last = run_steps(trainer, 1, batches=p.get("batches"), start=steps - 1)
            undo()
            held = hold_switchback_calls(calls)
            del calls
            for k in ("loss", "params", "caches", "launches", "step_s"):
                runs[name][k] += last[k]
            runs[name]["peak_bytes"] = max(runs[name].get("peak_bytes", 0),
                                           last.get("peak_bytes", 0))
        else:
            runs[name] = run_steps(trainer, steps, bool(p.get("keep_tensors")),
                                   batches=p.get("batches"))
        runs[name].update(heads=sorted(HEADS), plan=plan, held=held)
        if p.get("dcp") and name in p.get("dcp_variants", [name]):
            runs[name]["dcp"] = dcp_round_trip(trainer, os.path.join(p["dcp"], name))
        if reg is not None:
            _patch_registry(p.get("registry"))
        del trainer
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    ring = scenario_ring(p["ring"]) if p.get("ring") else None
    return {"runs": runs, "linears": linears, "ring": ring}


def scenario_train(p: dict) -> dict:
    from ..train.config import Config
    from ..train.trainer import Trainer
    from ..train import checkpoint as ckpt
    from .mesh import rank
    _patch_registry(p.get("registry"))
    _spy_heads()
    trainer = Trainer(Config._wrap(p["cfg"]), device=p["device"])
    groups = mesh_groups()
    plan = plan_vs_live(trainer) if p.get("plan") else None
    if p.get("batches") is not None:
        trainer.loader.close()
        trainer.loader = RowsLoader(p["batches"])
    stop_after = p.get("sigterm_after")
    if stop_after is not None and rank() == 0:
        inner = trainer.step_fn

        def step_fn(state, batch, generator=None):
            out = inner(state, batch, generator)
            if state.step == stop_after:    # the flag SIGTERM's handler sets
                trainer._preempted = True
            return out
        trainer.step_fn = step_fn
    if trainer.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(trainer.device)
    before = launch_counts()
    trainer.train()
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    sd = ckpt.optimizer_state_dict(trainer.state)
    full = full_params(trainer.state)
    st = trainer.state
    out = {"history": trainer.history, "saved_steps": trainer.saved_steps,
           "step": trainer.state.step, "launches": launches, "groups": groups,
           "heads": sorted(HEADS), "param_bytes": resident_bytes(st.trainable.values()),
           "frozen_bytes": resident_bytes(st.frozen.values()),
           "local_shapes": {k: tuple(v.shape) for k, v in st.trainable.items()},
           "moment_bytes": moment_bytes(trainer.state.opt_state), "plan": plan,
           "rows": {k: list(r) for k, r in trainer.state.opt_state.get("rows", {}).items()}}
    if trainer.device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(trainer.device)
    if p.get("digests"):     # the full-width run: checksums, not the tensors
        out["params"] = {k: digest(v) for k, v in full.items()}
    else:
        out["params"] = {k: v.detach().cpu().clone() for k, v in full.items()}
        out["moments"] = {k: v.cpu().clone() for k, v in sd.items()}
    # after everything above: the round trip steps the trainer once more
    out["dcp"] = dcp_round_trip(trainer, p["dcp"]) if p.get("dcp") else None
    return out


def scenario_dcp(p: dict) -> dict:
    """The sharded checkpoint backend (``train.orbax_ckpt``) on a task
    state placed on the mesh (``model_parallel``, ``fsdp``, the optimizer
    config's ZeRO-1): state A takes one update from seeded gradients and is
    saved at step 7, a fresh state B (another init, another update) is
    restored from it; returns each key's equality before and after, the
    local shapes, the rows, the restored step and count, the gathers the
    save made, the rank's bytes written and the seconds, and whether B's
    int8 cache is the one its restored masters give (``control``
    ``plain_rows``: the ZeRO-1 row blocks saved under the leaf's bare key,
    as a plain tensor)."""
    from ..core.quant import quantize_cache
    from ..tasks import image
    from ..train import orbax_ckpt
    from ..train.config import Config
    from ..train.optim import make_optimizer
    from ..train.state import (apply_gradients, create_state, mark_whole_grads, place_state,
                               with_quant_cache)
    from . import layout as layout_m
    from . import mesh
    spec, tp = p["spec"], int(p.get("model_parallel", 1))
    mesh.make_mesh(tp)
    if p.get("control") == "plain_rows":
        real = orbax_ckpt._block
        orbax_ckpt._block = lambda pl, rows: real(pl, None)

    def build(seed):
        mods = image.init_modules(spec, torch.Generator().manual_seed(seed))
        opt = make_optimizer(Config._wrap(p["opt_cfg"]), emit_quant=bool(p.get("emit_quant")))
        st = create_state(mods, image.trainable_predicate(spec, mods), opt)
        mark_whole_grads(st, spec.dit_quant)
        place_state(st, opt, tp, bool(p.get("fsdp")), p.get("fsdp_min_size"),
                    spec.dit_cfg.hidden_size)
        if spec.dit_quant_cache and spec.dit_quant != "none":
            with_quant_cache(st)
        gen = torch.Generator().manual_seed(100 + seed)
        apply_gradients(st, {k: torch.randn(v.shape, generator=gen).to(v.dtype)
                             for k, v in st.trainable.items()}, opt)
        return st

    a = build(0)
    a.step = 7
    gathers = []
    spies = [(mesh, "all_gather_rows"), (mesh, "all_gather_dim"), (layout_m, "gather")]
    reals = [getattr(m, n) for m, n in spies]
    for (m, n), real in zip(spies, reals):
        setattr(m, n, lambda *a_, _r=real, _n=n, **k: gathers.append(_n) or _r(*a_, **k))
    t0 = time.perf_counter()
    path = orbax_ckpt.save_sharded(a, p["dir"], 7)
    seconds = time.perf_counter() - t0
    for (m, n), real in zip(spies, reals):
        setattr(m, n, real)
    b = build(1)
    ea = orbax_ckpt.entries(a)
    before = {k: torch.equal(v, orbax_ckpt.entries(b)[k]) for k, v in ea.items()}
    t0 = time.perf_counter()
    orbax_ckpt.restore_sharded(b, p["dir"], 7)
    restore_s = time.perf_counter() - t0
    eb = orbax_ckpt.entries(b)
    cache_ok = None
    if b.quant is not None:
        want = quantize_cache(b.trainable, sorted(b.quant), b.layout)
        cache_ok = all(torch.equal(b.quant[k][0], want[k][0])
                       and torch.equal(b.quant[k][1], want[k][1]) for k in want)
    return {"keys": sorted(ea), "before": before,
            "equal": {k: torch.equal(v, eb[k]) for k, v in ea.items()},
            "shapes": {k: tuple(v.shape) for k, v in ea.items()},
            "rows": dict(a.opt_state.get("rows", {})), "step": b.step,
            "count": b.opt_state["count"], "gathers": gathers, "seconds": seconds,
            "restore_s": restore_s, "bytes": orbax_ckpt.rank_bytes(path, mesh.rank()),
            "cache_ok": cache_ok, "layout": {k: list(pl.spec) for k, pl in a.layout.items()}}


def _serve_phase(p: dict, ph: dict) -> dict:
    """One engine of ``scenario_serve`` (see there)."""
    import io
    import threading
    import urllib.error
    import urllib.request
    from ..serve.engine import InferenceEngine
    from ..serve.http import ServeApp
    from ..tasks import image
    from . import mesh
    kw = dict(num_devices=ph.get("num_devices", 1), model_parallel=ph.get("model_parallel", 1),
              buckets=ph["buckets"], num_steps=ph["num_steps"], quant=ph.get("quant", "none"),
              wire_dtype=ph.get("wire_dtype", "float32"))
    dev = torch.device(p.get("device", "cpu"))
    real_rows = mesh.randn_rows
    if ph.get("control") == "own_noise":     # each data rank draws its own rows' noise alone
        mesh.randn_rows = lambda shape, generator=None, dtype=torch.float32, device=None: \
            torch.randn(tuple(shape), generator=generator, dtype=dtype, device=device)
    try:
        t0 = time.perf_counter()
        if p.get("config"):
            eng = InferenceEngine.from_config(p["config"], device=dev, **kw)
        else:
            mods = image.build_modules(p["spec"])
            mods.load_state_dict(p["state_dict"])
            eng = InferenceEngine(p["spec"], mods, device=dev, **kw)
        out = {"buckets": list(eng.buckets), "layout": sorted(eng.layout),
               "groups": mesh_groups(), "answers": [], "http": [],
               "build_s": time.perf_counter() - t0}
        before = launch_counts()
        if mesh.rank() != 0:
            eng.follow()
            out["launches"] = {k: v - before[k] for k, v in launch_counts().items()}
            return out
        for op, images, seed in ph["requests"]:
            _sync(eng.device)
            t0 = time.perf_counter()
            res = (eng.reconstruct(images, seed=seed) if op == "reconstruct"
                   else eng.embed(images))
            out["answers"].append((res, time.perf_counter() - t0))
        out["launches"] = {k: v - before[k] for k, v in launch_counts().items()}
        if not ph.get("http"):
            eng.stop()
            return out
        from PIL import Image
        app = ServeApp(eng, max_wait_ms=float(ph.get("max_wait_ms", 1.0)))
        server, thread = app.serve_background()
        port = server.server_address[1]
        buf = io.BytesIO()
        Image.fromarray(ph["jpeg_image"]).save(buf, format="JPEG", quality=95)
        body = buf.getvalue()

        def post(path):
            req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                         headers={"Content-Type": "image/jpeg"})
            try:
                with urllib.request.urlopen(req, timeout=300) as r:
                    out["http"].append((path, r.status, r.headers["Content-Type"], r.read()))
            except urllib.error.HTTPError as e:     # the answer's body says why
                out["http"].append((path, e.code, e.headers.get("Content-Type"), e.read()))
        try:
            # unseeded, so that the batcher may group them (a seeded request
            # runs alone: its noise is the seed's, not its batch's)
            paths = ["/v1/reconstruct"] * int(ph.get("http_reconstructs", 1))
            posts = [threading.Thread(target=post, args=(q,)) for q in paths]
            for th in posts:
                th.start()
            for th in posts:
                th.join(timeout=300)
            post("/v1/embed")
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/stats", timeout=30) as r:
                out["stats"] = json.loads(r.read())
        finally:
            app.close()                 # stops the followers too
            thread.join(timeout=30)
        if eng._failed is not None:     # the followers are lost in a collective: end the launch
            raise RuntimeError(f"the mesh engine failed: {eng._failed}; HTTP answers "
                               f"{[(q, st, b[:300]) for q, st, _, b in out['http']]}")
        return out
    finally:
        mesh.randn_rows = real_rows


def scenario_serve(p: dict) -> dict:
    """Mesh ``InferenceEngine``s, one per entry of ``phases`` (each a dict
    of ``num_devices``, ``model_parallel``, ``quant``, ``buckets``,
    ``num_steps``, ``wire_dtype``, ``requests`` — ``(op, images, seed)`` —
    and optionally ``http``, ``http_reconstructs``, ``max_wait_ms``,
    ``jpeg_image``, ``control`` ``own_noise``: each data rank draws its
    rows' noise alone), built from ``config`` (a stage-1 YAML, random
    weights from its seed) or from ``spec`` and ``state_dict``: rank 0
    answers the requests directly, then, with ``http``, concurrent JPEG
    unseeded reconstructs and an embed through the HTTP server
    (``ServeApp``), and
    stops the followers; the other ranks follow.  Without ``phases`` the
    payload itself is the one phase.  Returns each phase's answers and
    seconds, its buckets, placed leaves and the mesh's groups."""
    import gc as gc_m
    phases = p.get("phases") or [p]
    outs = []
    for ph in phases:
        outs.append(_serve_phase(p, ph))
        gc_m.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return outs if p.get("phases") else outs[0]


SCENARIOS = {"step": scenario_step, "dcp": scenario_dcp, "serve": scenario_serve, "steps": scenario_steps, "train": scenario_train,
             "int8_scales": scenario_int8_scales, "linears": scenario_linears,
             "ring": scenario_ring, "pp_forward": scenario_pp_forward}


class Launch:
    """The rank processes of one ``start``; ``join`` waits for them."""

    def __init__(self, procs, workdir: Path, world: int, timeout: float):
        self.procs, self.workdir, self.world = procs, workdir, world
        self.deadline, self.timeout = time.monotonic() + timeout, timeout

    def join(self) -> List[dict]:
        """The ranks' results in rank order.  Raises (with each failed
        rank's last output) if a rank fails or outlives the launch's
        timeout; every process is gone when it returns."""
        try:
            for proc, _ in self.procs:
                proc.wait(timeout=max(self.deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            pass
        finally:
            self.kill()
        failed = [(r, proc.returncode) for r, (proc, _) in enumerate(self.procs)
                  if proc.returncode != 0]
        if failed:
            tails = "\n".join(f"--- rank {r} (rc {rc}):\n"
                              + (self.workdir / f"rank{r}.log").read_text()[-3000:]
                              for r, rc in failed)
            raise RuntimeError(f"{len(failed)} of {self.world} ranks failed or timed out "
                               f"({self.timeout:.0f} s):\n{tails}")
        return [torch.load(self.workdir / f"out{r}.pt", weights_only=False)
                for r in range(self.world)]

    def kill(self) -> None:
        for proc, log in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()


def start(payload: dict, world: int, workdir, timeout: float = 300.0,
          env: Optional[Dict[str, str]] = None) -> Launch:
    """Start ``payload`` on ``world`` ranks, each a process of this module;
    ``join`` the returned launch for their results."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    path = workdir / "payload.pt"
    torch.save(payload, path)
    base = {**os.environ, **(env or {}), "WORLD_SIZE": str(world),
            "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])}
    procs = []
    try:
        for r in range(world):
            log = open(workdir / f"rank{r}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "genhancer_tpu_torch.parallel.testing", str(path)],
                env={**base, "RANK": str(r), "LOCAL_RANK": base.get("LOCAL_RANK", "0")},
                stdout=log, stderr=subprocess.STDOUT, cwd=str(ROOT)), log))
    except BaseException:
        Launch(procs, workdir, world, timeout).kill()
        raise
    return Launch(procs, workdir, world, timeout)


def launch(payload: dict, world: int, workdir, timeout: float = 300.0,
           env: Optional[Dict[str, str]] = None) -> List[dict]:
    """Run ``payload`` on ``world`` ranks (``start`` then ``join``):
    the ranks' results in rank order."""
    return start(payload, world, workdir, timeout, env).join()


def main(argv=None) -> None:
    path = Path((argv or sys.argv[1:])[0])
    p = torch.load(path, weights_only=False)   # written by ``launch`` of this process tree
    import torch.distributed as dist
    torch.set_num_threads(int(p.get("threads", 1)))
    rank_ = int(os.environ["RANK"])
    if p.get("init_file"):
        dist.init_process_group("gloo", init_method=f"file://{p['init_file']}", rank=rank_,
                                world_size=int(os.environ["WORLD_SIZE"]),
                                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    try:
        out = SCENARIOS[p["scenario"]](p)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.save(out, path.parent / f"out{rank_}.pt")


if __name__ == "__main__":
    main()
