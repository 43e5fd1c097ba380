"""Stage-1 checkpoints in the reference layout, and resume.

Port of ``genhancer_tpu/train/checkpoint.py`` (stage 1).  A stage-1 run
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
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import torch

from ..core.kernels.adamw import Moment8

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


def _components(modules, kind: str):
    """{file component: module} of an ``init_modules``-layout tree."""
    out = {"dit": modules["dit"], "project_clip": modules["clip"]["project_clip"]}
    if kind == "image":
        out["project_t5"] = modules["clip"]["project_t5"]
    else:
        out["visual_adapter"] = modules["visual_adapter"]
    return out


def load_stage1_components(modules, load_dir: str, load_step: int,
                           kind: str = "image") -> None:
    """Load the stage-1 ``.bin`` files of ``load_step`` (``kind``: image or
    video) into ``init_modules``-layout modules, in place."""
    targets = _components(modules, kind)
    for name, pattern in STAGE1_FILES[kind]:
        path = os.path.join(load_dir, pattern.format(step=int(load_step)))
        if not os.path.exists(path):
            raise FileNotFoundError(f"stage-1 checkpoint file missing: {path}")
        sd = torch.load(path, map_location="cpu", weights_only=True)
        targets[name].load_state_dict(sd, strict=True)


def save_stage1(state, output_dir: str, step: int, kind: str = "image") -> List[str]:
    """Write the reference stage-1 component ``.bin`` files (``kind``: image
    or video) and the optimizer state of ``state`` at ``step``; returns the
    paths."""
    os.makedirs(output_dir, exist_ok=True)
    written = []
    for name, module in _components(state.modules, kind).items():
        pattern = dict(STAGE1_FILES[kind])[name]
        path = os.path.join(output_dir, pattern.format(step=step))
        torch.save({k: v.detach().cpu() for k, v in module.state_dict().items()}, path)
        written.append(path)
    path = os.path.join(output_dir, f"optimizer-state-{step}.bin")
    save_optimizer_state(state, path)
    written.append(path)
    return written


def save_optimizer_state(state, path: str) -> None:
    """The optimizer state positionally: ``count``, ``mu.i``/``nu.i`` for the
    i-th trainable path in sorted order (``mu.i.q``/``mu.i.s`` for an 8-bit
    moment), and the train ``step``."""
    opt = state.opt_state
    sd = {"count": torch.tensor(int(opt["count"])), "step": torch.tensor(int(state.step))}
    for i, key in enumerate(sorted(state.trainable)):
        for name in ("mu", "nu"):
            leaf = opt[name][key]
            if isinstance(leaf, Moment8):
                sd[f"{name}.{i}.q"], sd[f"{name}.{i}.s"] = (t.detach().cpu() for t in leaf)
            else:
                sd[f"{name}.{i}"] = leaf.detach().cpu()
    torch.save(sd, path)


def load_optimizer_state(state, path: str) -> None:
    """Restore what ``save_optimizer_state`` wrote into ``state``, in place:
    each moment lands on its parameter's device in the saved dtype."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    keys = sorted(state.trainable)
    n_saved = sum(1 for k in sd if k.startswith("mu.") and not k.endswith(".s"))
    if n_saved != len(keys):
        raise ValueError(f"{path}: {n_saved} moment leaves for {len(keys)} trainable leaves")
    for i, key in enumerate(keys):
        p = state.trainable[key]
        for name in ("mu", "nu"):
            if f"{name}.{i}.q" in sd:
                q, s = sd[f"{name}.{i}.q"], sd[f"{name}.{i}.s"]
                leaf = Moment8(q.to(p.device), s.to(p.device))
                shape, want = (tuple(q.shape), tuple(s.shape)), (tuple(p.shape), (p.shape[0], 1))
            else:
                leaf = sd[f"{name}.{i}"].to(p.device)
                shape, want = tuple(leaf.shape), tuple(p.shape)
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
        load_stage1_components(state.modules, output_dir, step, kind)
    opt_path = os.path.join(output_dir, f"optimizer-state-{step}.bin")
    if os.path.exists(opt_path):
        load_optimizer_state(state, opt_path)
    else:
        state.step = step
