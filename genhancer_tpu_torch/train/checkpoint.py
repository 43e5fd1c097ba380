"""Checkpoints in the reference layout, resume, and the stage-2 HF export.

Port of ``genhancer_tpu/train/checkpoint.py``.  A stage-1 run
writes torch state-dict ``.bin`` files under the reference key names — image
mode ``checkpoint-dit-N.bin``, ``checkpoint-project-clip-N.bin`` and
``checkpoint-project-t5-N.bin`` (``train_SigLIP_stage1.py:284-300``), video
mode ``checkpoint-dit-N.bin``, ``checkpoint-project-clip-N.bin`` and
``checkpoint-visual-adapter-N.bin`` (``train_OpenAICLIP_video_stage1.py:
501-514``) — the port's modules carry those names, so each loads with
``strict=True`` in either package — plus ``optimizer-state-N.bin``, which is framework
internal: the port writes its own positional layout (the step count, then
each moment leaf in sorted path order; an 8-bit moment as its codes and
scales, ``mu.i.q`` and ``mu.i.s``) and resumes from it.  The ``.bin`` files
hold the float masters only: the int8 weight cache is rebuilt from them.

Step discovery uses a strict regex over ``checkpoint-dit-(\\d+).bin``.

Stage 2 writes the same stage-1 component files and optimizer state (its
moments include the tower's LoRA leaves) and, beside them, the
LoRA-merged tower as an HF model directory (``export_hf_tower``).  A resume
reloads the components and the optimizer state only: the LoRA factors
restart from their initial values while their moments come back, as the
JAX package does (``checkpoint.py:192-207``).

Tensor parallelism and FSDP (the state's ``layout``): every rank gathers
each sharded leaf, its moments and its 8-bit scales to the reference layout
before rank 0 writes (``async_ckpt.gather_sharded:65``), so the files are
those of one process; a load cuts each rank's block out of them, whatever
the mesh that wrote them.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, List, Optional

import torch

from ..core.kernels.adamw import Moment8
from ..parallel import layout as layout_m
from ..parallel import mesh
from ..weights import hf_io
from ..weights.hf_io import StateDict

STAGE1_FILES = {
    "image": (("dit", "checkpoint-dit-{step}.bin"),
              ("project_clip", "checkpoint-project-clip-{step}.bin"),
              ("project_t5", "checkpoint-project-t5-{step}.bin")),
    "video": (("dit", "checkpoint-dit-{step}.bin"),
              ("project_clip", "checkpoint-project-clip-{step}.bin"),
              ("visual_adapter", "checkpoint-visual-adapter-{step}.bin")),
}
_PRUNE_PREFIXES = ("checkpoint-dit-", "checkpoint-project-clip-", "checkpoint-project-t5-",
                   "checkpoint-visual-adapter-", "optimizer-state-")
_STEP_RE = re.compile(r"checkpoint-dit-(\d+)\.bin$")
# each component's flat path prefix in the module tree
_PREFIX = {"dit": "dit.", "project_clip": "clip.project_clip.",
           "project_t5": "clip.project_t5.", "visual_adapter": "visual_adapter."}


def _components(modules, kind: str):
    """{file component: module} of an ``init_modules``-layout tree."""
    out = {"dit": modules["dit"], "project_clip": modules["clip"]["project_clip"]}
    if kind == "image":
        out["project_t5"] = modules["clip"]["project_t5"]
    else:
        out["visual_adapter"] = modules["visual_adapter"]
    return out


def load_stage1_components(modules, load_dir: str, load_step: int,
                           kind: str = "image", layout: Optional[dict] = None) -> None:
    """Load the stage-1 ``.bin`` files of ``load_step`` (``kind``: image or
    video) into ``init_modules``-layout modules, in place; a sharded leaf
    (``layout``) takes the rank's block."""
    targets = _components(modules, kind)
    for name, pattern in STAGE1_FILES[kind]:
        path = os.path.join(load_dir, pattern.format(step=int(load_step)))
        if not os.path.exists(path):
            raise FileNotFoundError(f"stage-1 checkpoint file missing: {path}")
        sd = layout_m.shard_state_dict(hf_io.load_state_dict(path), layout or {}, _PREFIX[name])
        targets[name].load_state_dict(sd, strict=True)


def stage1_state_dicts(state, kind: str = "image") -> Dict[str, StateDict]:
    """{file component: its module's state dict} of ``state`` (``kind``:
    image or video): the tensors are the live ones, not copies, but for
    the sharded leaves, gathered whole (a collective under a layout: every
    rank calls it)."""
    return {name: layout_m.full_state_dict(module, state.layout, _PREFIX[name])
            for name, module in _components(state.modules, kind).items()}


def write_stage1(components: Dict[str, StateDict], optimizer: StateDict, output_dir: str,
                 step: int, kind: str = "image") -> List[str]:
    """Write ``stage1_state_dicts``' component ``.bin`` files and
    ``optimizer_state_dict``'s ``optimizer-state-{step}.bin``; returns the
    paths."""
    os.makedirs(output_dir, exist_ok=True)
    written = []
    for name, pattern in STAGE1_FILES[kind]:
        path = os.path.join(output_dir, pattern.format(step=step))
        hf_io.save_state_dict(components[name], path)
        written.append(path)
    path = os.path.join(output_dir, f"optimizer-state-{step}.bin")
    hf_io.save_state_dict(optimizer, path)
    written.append(path)
    return written


def save_stage1(state, output_dir: str, step: int, kind: str = "image") -> List[str]:
    """Write the reference stage-1 component ``.bin`` files (``kind``: image
    or video) and the optimizer state of ``state`` at ``step``; returns the
    paths."""
    return write_stage1(stage1_state_dicts(state, kind), optimizer_state_dict(state),
                        output_dir, step, kind)


def optimizer_state_dict(state) -> StateDict:
    """The optimizer state positionally: ``count``, ``mu.i``/``nu.i`` for the
    i-th trainable path in sorted order (``mu.i.q``/``mu.i.s`` for an 8-bit
    moment), and the train ``step``; the moments are the live tensors.

    ZeRO-1: the moments of the leaves the state's ``rows`` names are
    gathered from every rank first (``gather_sharded:65``), and so are the
    blocks of the leaves the state's ``layout`` shards, so the file is the
    same whatever the mesh.  A collective: every rank calls it, in the same
    order."""
    opt = state.opt_state
    sd = {"count": torch.tensor(int(opt["count"])), "step": torch.tensor(int(state.step))}
    rows = opt.get("rows", {})
    names, leaves = [], []
    for i, key in enumerate(sorted(state.trainable)):
        pl = state.layout.get(key)
        for name in ("mu", "nu"):
            leaf = opt[name][key]
            parts = ([(f"{name}.{i}.q", leaf.q), (f"{name}.{i}.s", leaf.s)]
                     if isinstance(leaf, Moment8) else [(f"{name}.{i}", leaf)])
            for n, t in parts:
                if key in rows:
                    names.append(n)
                    leaves.append(t.detach())
                elif pl is not None:
                    sd[n] = layout_m.gather(t.detach(), _moment_placement(pl, n, t))
                else:
                    sd[n] = t.detach()
    sd.update(zip(names, mesh.all_gather_rows(leaves)))
    return sd


def _moment_placement(pl, name: str, t):
    """The placement of a moment tensor of a leaf placed by ``pl``: the
    leaf's, or for an 8-bit moment's per-row scales [rows, 1] the leaf's
    on the rows."""
    return pl.like((pl.shape[0], 1)) if name.endswith(".s") else pl


def save_optimizer_state(state, path: str) -> None:
    hf_io.save_state_dict(optimizer_state_dict(state), path)


def load_optimizer_state(state, path: str) -> None:
    """Restore what ``optimizer_state_dict`` wrote into ``state``, in place:
    each moment lands on its parameter's device in the saved dtype; under
    ZeRO-1 a leaf the state's ``rows`` names keeps this rank's rows only,
    whatever the world size that wrote the file."""
    sd = hf_io.load_state_dict(path)
    keys = sorted(state.trainable)
    rows = state.opt_state.get("rows", {})
    n_saved = sum(1 for k in sd if k.startswith("mu.") and not k.endswith(".s"))
    if n_saved != len(keys):
        raise ValueError(f"{path}: {n_saved} moment leaves for {len(keys)} trainable leaves")

    def mine(t, key, n):
        if key in state.layout:
            return layout_m.shard(t, _moment_placement(state.layout[key], n, t))
        return t[rows[key][0]:rows[key][1]].contiguous() if key in rows else t

    for i, key in enumerate(keys):
        p = state.trainable[key]
        whole = state.layout[key].shape if key in state.layout else tuple(p.shape)
        for name in ("mu", "nu"):
            if f"{name}.{i}.q" in sd:
                n = f"{name}.{i}"
                q, s = sd[n + ".q"], sd[n + ".s"]
                shape, want = (tuple(q.shape), tuple(s.shape)), (tuple(whole), (whole[0], 1))
                leaf = Moment8(mine(q, key, n + ".q").to(p.device),
                               mine(s, key, n + ".s").to(p.device))
            else:
                full = sd[f"{name}.{i}"]
                shape, want = tuple(full.shape), tuple(whole)
                leaf = mine(full, key, name).to(p.device)
            if shape != want:
                raise ValueError(f"optimizer leaf {name}.{i} ({key}) shape mismatch: "
                                 f"{shape} vs {want}")
            state.opt_state[name][key] = leaf
    state.opt_state["count"] = int(sd["count"])
    state.step = int(sd["step"])


def all_steps(output_dir: str) -> List[int]:
    if not os.path.isdir(output_dir):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(output_dir)
                  if (m := _STEP_RE.match(name)))


def prune_checkpoints(output_dir: str, total_limit: int) -> List[int]:
    """Keep only the newest ``total_limit`` checkpoint steps
    (``checkpoints_total_limit``); returns the pruned steps."""
    steps = all_steps(output_dir)
    if total_limit <= 0 or len(steps) <= total_limit:
        return []
    doomed = steps[: len(steps) - total_limit]
    for s in doomed:
        for p in _PRUNE_PREFIXES:
            path = os.path.join(output_dir, f"{p}{s}.bin")
            if os.path.exists(path):
                os.remove(path)
    return doomed


def latest_step(output_dir: str) -> Optional[int]:
    steps = all_steps(output_dir)
    return max(steps) if steps else None


def resume_latest(state, output_dir: str, kind: str = "image") -> None:
    """``resume_from_checkpoint: latest``: load the newest step's components
    and optimizer state into ``state``, in place (no checkpoint: unchanged)."""
    step = latest_step(output_dir)
    if step is None:
        return
    with torch.no_grad():
        load_stage1_components(state.modules, output_dir, step, kind, state.layout)
    opt_path = os.path.join(output_dir, f"optimizer-state-{step}.bin")
    if os.path.exists(opt_path):
        load_optimizer_state(state, opt_path)
    else:
        state.step = step


# ---------------------------------------------------------------------------
# stage-2 HF export
# ---------------------------------------------------------------------------

def export_hf_tower(state, out_dir: str, base_config: Optional[dict] = None,
                    base_model_dir: Optional[str] = None) -> str:
    """Write the LoRA-merged tower as an HF model directory
    (``merge_and_unload().save_pretrained``, ``checkpoint.py:214-238``).
    The training tower is left as it is."""
    from . import lora
    return write_hf_tower(lora.merged_state_dict(state.modules["clip"]["model"]), out_dir,
                          base_config, base_model_dir)


def write_hf_tower(merged: StateDict, out_dir: str, base_config: Optional[dict] = None,
                   base_model_dir: Optional[str] = None) -> str:
    """``merged`` (``lora.merged_state_dict``) as ``pytorch_model.bin`` under
    the HF key names; ``config.json`` (and ``preprocessor_config.json``)
    copied from ``base_model_dir`` where it has one, else ``base_config``
    written."""
    os.makedirs(out_dir, exist_ok=True)
    hf_io.save_state_dict(merged, os.path.join(out_dir, "pytorch_model.bin"))
    if base_model_dir and os.path.exists(os.path.join(base_model_dir, "config.json")):
        shutil.copy(os.path.join(base_model_dir, "config.json"),
                    os.path.join(out_dir, "config.json"))
        pre = os.path.join(base_model_dir, "preprocessor_config.json")
        if os.path.exists(pre):
            shutil.copy(pre, os.path.join(out_dir, "preprocessor_config.json"))
    elif base_config is not None:
        with open(os.path.join(out_dir, "config.json"), "w") as f:
            json.dump(base_config, f, indent=2)
    return out_dir
