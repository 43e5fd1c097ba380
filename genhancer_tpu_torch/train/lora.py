"""LoRA injection and merge for tower fine-tuning (stage 2).

Port of ``genhancer_tpu/train/lora.py`` on ``nn.Module``s, with peft's
semantics (``train_SigLIP_stage2_all.py:134-143``):

  * ``targets``: an explicit list of leaf names (SigLIP: ``SIGLIP_TARGETS``)
    or ``"all-linear"``, every module with a 2-D ``weight`` whose path holds
    no ``embedding``/``embeddings``/``logit_scale`` — the CLIP projection
    heads included (``lora.py:54-59``); paths are the JAX package's own;
  * init: ``lora_A`` [r, in] kaiming-uniform (bound sqrt(3/in), drawn in
    float32), ``lora_B`` zeros [out, r] and ``lora_scale`` = alpha/r (a
    persistent buffer), all three in the weight's dtype;
  * ``bias: lora_only``: the factors and the biases of wrapped modules
    train (``lora_trainable_paths``);
  * ``merge``: W' = (W.f32 + (B.f32 @ A.f32) * scale) in W's dtype, the
    factors dropped (``merge_and_unload`` before the HF export), and with
    them QLoRA's derived ``weight_q``/``w_scale`` (``lora.py:105-113``): the
    export of a QLoRA run merges into the kept float weight, so it equals
    the export of the same factors on the unquantized tower byte for byte.
    ``merged_state_dict`` computes the same tensors without copying the
    tower (the checkpoint writer snapshots it).

The factors become attributes of the wrapped module, so its state-dict keys
are the JAX tree's paths (``...q_proj.lora_A``) and ``core.nn.linear`` adds
the branch.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn as tnn

SIGLIP_TARGETS = ("k_proj", "v_proj", "q_proj", "out_proj", "fc1", "fc2")
_FACTORS = ("lora_A", "lora_B", "lora_scale")
_QUANT = ("weight_q", "w_scale")     # QLoRA's derived int8 base, never exported


def _iter_linears(root: tnn.Module) -> Iterator[Tuple[str, tnn.Module]]:
    """(path, module) for every module holding a 2-D ``weight`` parameter."""
    for path, m in root.named_modules():
        w = m._parameters.get("weight")
        if w is not None and w.dim() == 2:
            yield path, m


def _matches(path: str, targets) -> bool:
    if targets == "all-linear":
        return not any(s in path for s in ("embedding", "embeddings", "logit_scale"))
    return path.rsplit(".", 1)[-1] in targets


def inject(tower: tnn.Module, generator: torch.Generator, r: int = 16, alpha: float = 16.0,
           targets="all-linear") -> Tuple[tnn.Module, List[str]]:
    """Wrap the targeted modules of ``tower`` in place, drawing each A from
    ``generator`` in module order; returns (tower, wrapped paths)."""
    wrapped: List[str] = []
    for path, m in list(_iter_linears(tower)):
        if not _matches(path, targets):
            continue
        w = m.weight
        out_dim, in_dim = w.shape
        bound = math.sqrt(3.0 / in_dim)     # kaiming_uniform(a=sqrt(5))
        a = torch.empty((r, in_dim), dtype=torch.float32, device=w.device)
        with torch.no_grad():
            a.uniform_(-bound, bound, generator=generator)
        m.lora_A = tnn.Parameter(a.to(w.dtype))
        m.lora_B = tnn.Parameter(torch.zeros((out_dim, r), dtype=w.dtype, device=w.device))
        m.register_buffer("lora_scale", torch.tensor(alpha / r, dtype=w.dtype, device=w.device))
        wrapped.append(path)
    return tower, wrapped


def wrapped_paths(tower: tnn.Module) -> List[str]:
    return [path for path, m in tower.named_modules() if "lora_A" in m._parameters]


def _merged_weight(m) -> torch.Tensor:
    """``m``'s weight with its LoRA branch folded in; ``m`` is a module or a
    dict of its state-dict entries."""
    get = m.__getitem__ if isinstance(m, dict) else m.__getattr__
    w = get("weight")
    delta = (get("lora_B").to(torch.float32) @ get("lora_A").to(torch.float32)) \
        * get("lora_scale").to(torch.float32)
    return (w.to(torch.float32) + delta).to(w.dtype)


@torch.no_grad()
def merge(tower: tnn.Module) -> tnn.Module:
    """A copy of ``tower`` with every LoRA factor folded into its weight and
    dropped, QLoRA's ``weight_q``/``w_scale`` dropped everywhere
    (``lora.py:87-113``); ``tower`` is left as it is."""
    merged = copy.deepcopy(tower)
    for path in wrapped_paths(merged):
        m = merged.get_submodule(path)
        m.weight.copy_(_merged_weight(m))
        for name in _FACTORS:
            delattr(m, name)
    for m in merged.modules():
        for name in _QUANT:
            if name in m._buffers:
                delattr(m, name)
    return merged


@torch.no_grad()
def merged_state_dict(tower: tnn.Module, sd: Optional[Dict[str, torch.Tensor]] = None
                      ) -> Dict[str, torch.Tensor]:
    """``merge(tower).state_dict()``, keys in the same order, without the
    copy: the merged weights are new tensors on the tower's device, every
    other entry is the tower's own tensor.  ``sd``: the tower's state dict
    to merge instead of its own (FSDP: its blocks gathered whole)."""
    sd = tower.state_dict() if sd is None else sd
    merged = {}
    for p in wrapped_paths(tower):
        pre = f"{p}." if p else ""
        merged[pre + "weight"] = _merged_weight({n: sd[pre + n] for n in ("weight", *_FACTORS)})
    return {k: merged.get(k, v) for k, v in sd.items()
            if k.rsplit(".", 1)[-1] not in _FACTORS}


def lora_trainable_paths(tower: tnn.Module) -> List[str]:
    """The paths that train under ``bias: lora_only``: each wrapped
    module's bias (where it has one), ``lora_A`` and ``lora_B``."""
    out = []
    for path in wrapped_paths(tower):
        m = tower.get_submodule(path)
        names = (["bias"] if getattr(m, "bias", None) is not None else []) + ["lora_A", "lora_B"]
        out += [f"{path}.{n}" if path else n for n in names]
    return out
