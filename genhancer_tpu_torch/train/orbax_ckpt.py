"""Sharded checkpoint backend on ``torch.distributed.checkpoint`` (DCP).

Port of ``genhancer_tpu/train/orbax_ckpt.py``.  The file, the config value
(``checkpoint_backend: orbax``) and the directory name (``orbax-{step}``)
keep the JAX package's names, so the module lists, the published configs
and the step listings line up; the files inside are DCP's (``.metadata``
and one ``__{rank}_0.distcp`` per writing rank) and this module's
``genhancer.json``.  The port neither reads nor writes Orbax files.

The default backend (``train.checkpoint``) writes the reference layout
(``checkpoint-dit-{step}.bin`` ...): every rank gathers its sharded leaves
and rank 0 writes the whole state.  This backend saves the training state
(the trainable leaves, the optimizer moments, the step and the optimizer's
count) with no gather: every rank writes only its own blocks, and a
restore loads each rank's blocks in place, onto the live state's layout.
The files are written as the torch backend's are, with no fsync.

DCP writes a plain tensor that sits under one key on every rank once, as
replicated.  A sharded leaf's block therefore goes under a key that names
its place in the whole leaf (``_block``): a ZeRO-1 row range
(``@rows{r0}:{r1}``, ``mesh.row_range``), or the rank's index on each axis
that a TP or FSDP placement shards (``@model1of2``, ``@data0of2``, in the
placement's axis order, ``parallel.layout``); a replicated leaf keeps its
bare key and is written by one rank.  A restore reads the keys of the live
state, so it needs the mesh and placements that saved (the torch backend's
files are mesh-independent): another mesh raises ``ValueError``.

The int8 SwitchBack weight cache is derived state and is never saved; a
restore rebuilds it from the restored masters (``state.with_quant_cache``).
Stage-2 HF exports still go through the torch writer (``train.trainer``).
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, List, Optional, Tuple

import torch

from ..parallel import mesh
from ..core.kernels.adamw import Moment8

_ORBAX_RE = re.compile(r"orbax-(\d+)$")
META = "genhancer.json"
WRITE_THREADS = 4


def ckpt_path(output_dir: str, step: int) -> str:
    return os.path.abspath(os.path.join(output_dir, f"orbax-{step}"))


def _block(pl, rows: Optional[Tuple[int, int]]) -> str:
    """The key suffix naming the rank's block of a leaf: its ZeRO-1 rows,
    its index on each axis its placement shards, or "" (replicated)."""
    if rows is not None:
        return f"@rows{rows[0]}:{rows[1]}"
    if pl is None:
        return ""
    parts = []
    for axis in pl.spec:
        if axis is not None:
            _, size, idx = mesh._axis(axis)
            parts.append(f"{axis}{idx}of{size}")
    return "@" + ",".join(parts)


def _moment_parts(leaf) -> List[Tuple[str, torch.Tensor]]:
    if isinstance(leaf, Moment8):
        return [(".q", leaf.q), (".s", leaf.s)]
    return [("", leaf)]


def entries(state) -> Dict[str, torch.Tensor]:
    """``{key: the rank's tensor}`` of everything a checkpoint holds: the
    trainable leaves (``trainable/<path>``) and the moments
    (``opt/mu/<path>``, ``opt/nu/<path>``, with ``.q``/``.s`` for an 8-bit
    one), each key carrying its block's suffix (``_block``)."""
    opt = state.opt_state
    rows = opt.get("rows", {})
    out = {}
    for path in sorted(state.trainable):
        pl = state.layout.get(path)
        out[f"trainable/{path}{_block(pl, None)}"] = state.trainable[path].detach()
        for name in ("mu", "nu"):
            for suffix, t in _moment_parts(opt[name][path]):
                out[f"opt/{name}/{path}{suffix}{_block(pl, rows.get(path))}"] = t
    return out


def _mesh_sizes() -> dict:
    return {"world": mesh.world_size(), "data": mesh.data_size(), "model": mesh.model_size(),
            "seq": mesh.seq_size(), "pipe": mesh.pipe_size()}


def save_sharded(state, output_dir: str, step: int) -> str:
    """Collective: every rank calls it with its blocks of ``state``.
    Writes ``{output_dir}/orbax-{step}`` (each rank its own blocks; the
    replicated leaves once) and returns the path."""
    import torch.distributed.checkpoint as dcp
    path = ckpt_path(output_dir, step)
    sd = entries(state)
    if mesh.rank() == 0:
        os.makedirs(path, exist_ok=True)
    # four writer threads per rank; no fsync, as the torch backend's files
    # (the page cache writes them back)
    dcp.save(sd, storage_writer=dcp.FileSystemWriter(path, thread_count=WRITE_THREADS,
                                                     sync_files=False))
    if mesh.rank() == 0:
        meta = {"step": int(state.step), "count": int(state.opt_state["count"]),
                "mesh": _mesh_sizes()}
        with open(os.path.join(path, META + ".tmp"), "w") as f:
            json.dump(meta, f)
        os.replace(os.path.join(path, META + ".tmp"), os.path.join(path, META))
    if mesh.is_distributed():
        torch.distributed.barrier()     # the metadata is on disk before any rank goes on
    return path


def rank_bytes(path: str, rank: int) -> int:
    """The bytes rank ``rank`` wrote into a checkpoint directory (its DCP
    data files)."""
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)
               if f.startswith(f"__{rank}_") and f.endswith(".distcp"))


def restore_sharded(state, output_dir: str, step: int):
    """Collective: load the checkpoint of ``step`` into ``state`` in place,
    each rank its own blocks onto the live layout (ZeRO-1 rows, TP and FSDP
    blocks, replicated leaves); the step and the optimizer's count come
    back, and the int8 cache, if any, is rebuilt from the restored masters.
    Returns ``state``."""
    import torch.distributed.checkpoint as dcp
    from .state import with_quant_cache
    path = ckpt_path(output_dir, step)
    with open(os.path.join(path, META)) as f:
        meta = json.load(f)
    sd = entries(state)
    saved = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    missing = sorted(set(sd) - set(saved))
    if missing:
        raise ValueError(
            f"{path} was saved on the mesh {meta['mesh']}, this run's is {_mesh_sizes()}: "
            f"{len(missing)} of its blocks are not in the checkpoint (first: {missing[0]}); "
            "restore on the saving mesh, or use checkpoint_backend: torch, whose files "
            "any mesh reads")
    with torch.no_grad():
        dcp.load(sd, storage_reader=dcp.FileSystemReader(path))
    state.step = int(meta["step"])
    state.opt_state["count"] = int(meta["count"])
    if state.quant is not None:
        with_quant_cache(state)
    return state


def all_steps(output_dir: str) -> List[int]:
    if not os.path.isdir(output_dir):
        return []
    out = []
    for name in os.listdir(output_dir):
        m = _ORBAX_RE.match(name)
        if m and os.path.isfile(os.path.join(output_dir, name, META)):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(output_dir: str) -> Optional[int]:
    steps = all_steps(output_dir)
    return steps[-1] if steps else None


def prune(output_dir: str, total_limit: int) -> List[int]:
    """Keep the newest ``total_limit`` checkpoints of this backend (as
    ``checkpoint.prune_checkpoints`` does for the torch backend's); rank 0
    only.  Returns the removed steps."""
    steps = all_steps(output_dir)
    drop = steps[:-total_limit] if total_limit else []
    for s in drop:
        shutil.rmtree(ckpt_path(output_dir, s), ignore_errors=True)
    return drop
