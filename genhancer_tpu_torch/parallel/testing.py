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
    ``no_seq_sum`` (the gradients left unsummed over seq);
  * ``ring``: ``parallel.ring.ring_attention`` on this rank's chunks of
    given whole q, k, v (its rows on the data axis), each case forward and
    backward against a given output cotangent; returns o, dq, dk, dv of
    its chunk and the mesh's groups, and one ``rotate`` of the rank index
    each way on the seq axis;
  * ``pp_forward``: ``parallel.pp.pipeline_dit_forward`` of loaded DiT
    weights on this rank's rows of given whole inputs (``n_micro``,
    ``remat``), the loss the global mean of the output's squares; returns
    the rank's output and the gradients summed as the step sums them
    (``control`` ``sum_all_over_pipe``: every leaf summed over pipe);
  * ``steps``: for each variant of a config, a ``Trainer``, ``steps``
    optimizer steps on this rank's rows of seeded global image batches
    (or of given global micro-batches, ``batches``), driven as the train
    loop drives them (with ``linears``, that scenario's payload, run
    first; with ``ring``, that one's run after); per step the loss, digests of
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
    given global tensors, and the per-column int8 dW summed over the ranks;
  * ``train``: a ``Trainer`` on its config, ``train()`` run to its end
    (optionally on this rank's rows of given global batches, optionally
    with rank 0's SIGTERM flag raised after a step); returns the history,
    the saved steps, the kernels' launches, the peak device
    memory and the final parameters (or their digests) and gathered
    moments.

The workers import torch and this package only.
"""

from __future__ import annotations

import datetime
import gc
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

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


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch counter in this process, by its ``LAUNCHES`` key."""
    from ..core.kernels import adamw, flash_attention, int8_dw, rowquant, short_attention
    return {k: v for m in (short_attention, flash_attention, adamw, rowquant, int8_dw)
            for k, v in m.LAUNCHES.items()}


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
    from ..train.state import create_state, place_state, with_quant_cache
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
    place_state(state, rec, tp, bool(p.get("fsdp")), p.get("fsdp_min_size"),
                spec.dit_cfg.hidden_size)
    if spec.dit_quant_cache and spec.dit_quant != "none":
        with_quant_cache(state)
    _control(p.get("control"))
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
            "caches": {k: list(_whole_cache(state, k)) for k in (state.quant or {})}}


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
    else:
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
                               remat=bool(p.get("remat")), **inputs)
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


def scenario_linears(p: dict) -> dict:
    from torch import nn as tnn
    from ..core import nn
    from ..core.quant import quantize_cache
    from .layout import Placement, gather, place, shard
    from .mesh import MODEL_AXIS, make_mesh
    make_mesh(int(p["tp"]))
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
    layout = place(root, int(p["tp"]), hidden=int(p["hidden"]))
    cache = (quantize_cache(dict(root.named_parameters()),
                            [k + ".weight" for k in p["weights"]], layout)
             if p.get("cached") else {})
    out = {}
    for path in p["weights"]:
        lin, pl = root.get_submodule(path), layout[path + ".weight"]
        x, g = p["x"][path], p["g"][path]
        # the model-sharded columns of x (row-parallel) or of y and g (column)
        cols = Placement((x.shape[0], pl.shape[1 if lin.tp_mode == "row" else 0]),
                         (None, MODEL_AXIS), pl.index)
        if lin.tp_mode == "row":
            x = shard(x, cols)
        else:
            g = shard(g, cols)
        if path + ".weight" in cache:
            wq, ws = cache[path + ".weight"]
            lin.register_buffer("weight_sb_q", wq, persistent=False)
            lin.register_buffer("weight_sb_scale", ws, persistent=False)
        x = x.clone().requires_grad_(True)
        with nn.int8_training_ctx(full=p["dw"] == "cols", dw_int8=p["dw"] == "int8_dw"):
            y = nn.linear(lin, x)
        y.backward(g)
        y, dx = y.detach(), x.grad
        if lin.tp_mode == "row":
            dx = gather(dx, cols)
        else:
            y = gather(y, cols)
        out[path] = {"y": y, "dx": dx, "dw": gather(lin.weight.grad, pl),
                     "db": gather(lin.bias.grad, layout.get(path + ".bias"))}
        if path + ".weight" in cache:
            wq, ws = cache[path + ".weight"]
            out[path]["cache"] = (gather(wq, pl), gather(ws, pl.like((pl.shape[0],))))
    return out


def scenario_int8_scales(p: dict) -> dict:
    from ..core import quant
    from .mesh import all_reduce_sum, local_rows
    dw = quant._int8_dw_cols(local_rows(p["g2"]), local_rows(p["x2"]), torch.float32)
    all_reduce_sum([dw])
    return {"x": quant.quantize_activation_tensor(local_rows(p["x"])),
            "g": quant._quantize_cols(local_rows(p["g2"])), "dw": dw}


def global_images(step: int, batch: int, size: int, accum: int, seed: int = 0) -> dict:
    """The global batch of step ``step``: uniform images [batch, size, size,
    3] float32 (``[accum, batch, ...]`` with accumulation), from a seed."""
    rng = np.random.default_rng(seed * 1_000_003 + step)
    shape = ((accum,) if accum > 1 else ()) + (batch, size, size, 3)
    return {"image": rng.random(shape, dtype=np.float32)}


def run_steps(trainer, steps: int, keep_tensors: bool = False, seed: int = 0,
              batches: Optional[list] = None) -> dict:
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
            micro = batches[len(out["loss"]) * accum:(len(out["loss"]) + 1) * accum]
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


def scenario_steps(p: dict) -> dict:
    from ..train.config import Config
    from ..train.trainer import Trainer
    _patch_registry(p.get("registry"))
    _spy_heads()
    runs = {}
    linears = scenario_linears(p["linears"]) if p.get("linears") else None
    for name, overrides in p["variants"].items():
        HEADS.clear()
        trainer = Trainer(Config._wrap(p["cfg"]).merged_with(overrides), device=p["device"])
        trainer.loader.close()
        runs[name] = run_steps(trainer, int(p["steps"]), bool(p.get("keep_tensors")),
                               batches=p.get("batches"))
        runs[name]["heads"] = sorted(HEADS)
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
           "moment_bytes": moment_bytes(trainer.state.opt_state),
           "rows": {k: list(r) for k, r in trainer.state.opt_state.get("rows", {}).items()}}
    if trainer.device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(trainer.device)
    if p.get("digests"):     # the full-width run: checksums, not the tensors
        out["params"] = {k: digest(v) for k, v in full.items()}
        return out
    out["params"] = {k: v.detach().cpu().clone() for k, v in full.items()}
    out["moments"] = {k: v.cpu().clone() for k, v in sd.items()}
    return out


SCENARIOS = {"step": scenario_step, "steps": scenario_steps, "train": scenario_train,
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
