"""JAX parameter trees and HF tower state dicts -> this package's state dicts.

The JAX package keeps its parameters as nested dicts with numpy leaves
(image tasks ``{dit, vae, clip{model, project_clip, project_t5}}``, video
tasks ``{dit, vae, clip{model, project_clip}, visual_adapter}``).
``state_dicts_from_jax`` flattens such a tree into torch state dicts under
the reference torch names — exactly what ``genhancer_tpu.weights.hf_convert``
``dit_to_torch`` / ``vae_to_torch`` / ``tower_to_torch`` / ``module_to_torch``
write — which this package's modules load with ``strict=True``:

  * the DiT's grouped streams are renamed (``double_blocks.{i}.img.attn`` ->
    ``double_blocks.{i}.img_attn``);
  * conv weights are transposed HWIO -> OIHW (every 4-D leaf is a conv);
  * the tower's text side is dropped by an explicit list for the
    vision-only tower of stage 1 and serving, and kept for stage 2's
    ``CLIPModel``; a stage-2 tree's LoRA leaves (``lora_A``, ``lora_B``,
    ``lora_scale``) keep their paths, which are the port's parameter and
    buffer names;
  * int8 trees (``core.quant`` surgery): a linear's ``weight_q`` [o, i] and
    ``w_scale`` [o, 1] are kept as they are, a conv's ``weight_q`` goes
    HWIO -> OIHW while its ``w_scale`` keeps the [1, 1, 1, O] layout;
    ``load_jax_params`` swaps the matching port modules for
    ``core.nn.Int8Layer`` first, so both packages compute the same.

The generative core's extra trees ride along under their own keys:
``controlnet`` (``models.controlnet``: the DiT's prologue and block names,
renamed the same way), ``ip`` (``models.ip_adapter``: the keys are the
port's, the tree's ``num_tokens``/``cross_attention_dim`` integers are
module attributes, not tensors) and ``t5`` (``models.towers.t5``: HF's
names in both packages).

HF ``CLIPModel`` and ``SiglipModel`` state dicts are already the port
tower's names and layouts (the patch embedding is OIHW in both): a merged
tower's ``state_dict()`` is its HF state dict (``hf_convert.tower_to_torch``'s
counterpart), and ``tower_from_hf`` (``tower_from_torch``'s) only drops the
``position_ids`` buffers and, for a vision-only tower, the text side.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]

# tower keys of the text side of an HF CLIPModel or SiglipModel
TEXT_SIDE_PREFIXES = ("text_model.", "text_projection.", "logit_scale", "logit_bias")
# 0-d in the port's towers (and JAX's init), [1] in an HF SiglipModel
_SCALARS = ("logit_scale", "logit_bias")


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dict/list tree -> flat {'a.b.0.c': leaf}."""
    out: Dict[str, Any] = {}

    def rec(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, f"{path}.{k}" if path else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, f"{path}.{i}" if path else str(i))
        else:
            out[path] = node

    rec(tree, prefix)
    return out


def to_tensor(v) -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16) -> a CPU tensor of the same dtype
    and shape (0-d stays 0-d: ``logit_scale``, ``lora_scale``)."""
    v = np.array(v, order="C", copy=True)
    if v.dtype.name == "bfloat16":
        return torch.from_numpy(v.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(v)


def _leaf(v, key: str = "") -> torch.Tensor:
    t = to_tensor(v)
    if t.ndim == 4 and not key.endswith("w_scale"):
        return t.permute(3, 2, 0, 1).contiguous()                     # HWIO -> OIHW
    return t


def _dit_name(key: str) -> str:
    """double_blocks.{i}.img.attn.qkv -> double_blocks.{i}.img_attn.qkv."""
    parts = key.split(".")
    if parts[0] == "double_blocks":
        return ".".join(parts[:2] + [f"{parts[2]}_{parts[3]}"] + parts[4:])
    return key


def dit_state_dict(tree) -> StateDict:
    return {_dit_name(k): _leaf(v, k) for k, v in flatten_tree(tree).items()}


def vae_state_dict(tree) -> StateDict:
    return {k: _leaf(v, k) for k, v in flatten_tree(tree).items()}


def tower_state_dict(tree, text_side: bool = False) -> StateDict:
    """CLIP tower -> vision_model.* and visual_projection.*, SigLIP tower ->
    vision_model.* (+ the text side's keys with ``text_side``); SigLIP's
    patch conv HWIO -> OIHW like every 4-D leaf."""
    return {k: _leaf(v, k) for k, v in flatten_tree(tree).items()
            if text_side or not k.startswith(TEXT_SIDE_PREFIXES)}


def tower_from_hf(sd: StateDict, text_side: bool = True) -> StateDict:
    """An HF ``CLIPModel``/``SiglipModel`` state dict -> the port tower's:
    ``position_ids`` dropped, ``logit_scale``/``logit_bias`` 0-d, and the
    text side dropped too unless ``text_side``."""
    return {k: v.reshape(()) if k in _SCALARS else v for k, v in sd.items()
            if not k.endswith("position_ids")
            and (text_side or not k.startswith(TEXT_SIDE_PREFIXES))}


def module_state_dict(tree) -> StateDict:
    """Projectors and the visual adapter: the JAX keys are already the torch
    Sequential names."""
    return {k: _leaf(v, k) for k, v in flatten_tree(tree).items()}


# the IP tree's static integers (module attributes in the port)
_IP_STATIC = ("num_tokens", "cross_attention_dim")


def ip_state_dict(tree) -> StateDict:
    """An ``init_ip_params`` tree -> the ``IPAdapter``'s state dict."""
    return {k: _leaf(v, k) for k, v in flatten_tree(tree).items()
            if not k.endswith(_IP_STATIC)}


# the extra trees of the generative core: tree key -> its state-dict function
_EXTRAS = {"controlnet": dit_state_dict, "ip": ip_state_dict, "t5": module_state_dict}


def adopt_int8(root, sd: StateDict) -> None:
    """Swap, in place, each module of ``root`` whose state-dict entries in
    ``sd`` are int8 factors (``<path>.weight_q``) for a ``core.nn.Int8Layer``
    of those shapes, keeping its bias parameter."""
    from ..core import nn, quant
    for key, wq in sd.items():
        if not key.endswith(".weight_q"):
            continue
        path = key[: -len(".weight_q")]
        mod = root.get_submodule(path)
        if not isinstance(mod, nn.Int8Layer):
            quant.swap_module(root, path, nn.Int8Layer(
                torch.empty_like(wq), torch.empty_like(sd[path + ".w_scale"]),
                getattr(mod, "bias", None)))


def state_dicts_from_jax(params, text_side: bool = False) -> Dict[str, StateDict]:
    """An image or video tree (numpy leaves) -> ``{"dit", "vae", "tower",
    "project_clip"}`` state dicts plus ``"project_t5"`` (image) or
    ``"visual_adapter"`` (video); the tower's text side only with
    ``text_side``.  A ``controlnet``, ``ip`` or ``t5`` tree beside them (or
    alone) gives the state dict of that key."""
    out = {key: fn(params[key]) for key, fn in _EXTRAS.items() if key in params}
    if "clip" not in params:
        return out
    clip = params["clip"]
    out.update({
        "dit": dit_state_dict(params["dit"]),
        "vae": vae_state_dict(params["vae"]),
        "tower": tower_state_dict(clip["model"], text_side),
        "project_clip": module_state_dict(clip["project_clip"]),
    })
    if "project_t5" in clip:
        out["project_t5"] = module_state_dict(clip["project_t5"])
    if "visual_adapter" in params:
        out["visual_adapter"] = module_state_dict(params["visual_adapter"])
    return out


def load_jax_params(modules, params, layout=None) -> None:
    """Load a JAX parameter tree into ``init_modules``-layout modules of the
    same task kind (strict: every key on both sides must match; a stage-2
    tower, a ``CLIPModel``, takes the text side as well).  A ``controlnet``,
    ``ip`` or ``t5`` tree loads into ``modules[key]`` (a ``ControlNet``,
    ``IPAdapter`` or ``T5Encoder``), whose IP integers must equal the
    tree's.  Modules placed on the mesh (``layout``, ``parallel.layout``:
    TP and FSDP blocks, keyed by flat path) take each rank's block of the
    converted weights."""
    for key in _EXTRAS:
        if key in params:
            _load_extra(key, modules[key], params[key])
    if "clip" not in params:
        return
    from ..parallel.layout import shard_state_dict
    sds = state_dicts_from_jax(params, text_side=hasattr(modules["clip"]["model"], "text_model"))
    adopt_int8(modules["vae"], sds["vae"])
    adopt_int8(modules["clip"]["model"], sds["tower"])

    def load(module, sd, prefix):
        module.load_state_dict(shard_state_dict(sd, layout or {}, prefix), strict=True)

    load(modules["dit"], sds["dit"], "dit.")
    load(modules["vae"], sds["vae"], "vae.")
    load(modules["clip"]["model"], sds["tower"], "clip.model.")
    load(modules["clip"]["project_clip"], sds["project_clip"], "clip.project_clip.")
    if "project_t5" in modules["clip"] or "project_t5" in sds:
        load(modules["clip"]["project_t5"], sds["project_t5"], "clip.project_t5.")
    if "visual_adapter" in modules or "visual_adapter" in sds:
        load(modules["visual_adapter"], sds["visual_adapter"], "visual_adapter.")


def _load_extra(key: str, module, tree) -> None:
    if key == "ip":
        ipm, want = module.image_proj_model, tree["image_proj_model"]
        got = (ipm.num_tokens, ipm.cross_attention_dim)
        if got != tuple(int(want[k]) for k in _IP_STATIC):
            raise ValueError(f"IP adapter (num_tokens, cross_attention_dim) {got} != the "
                             f"tree's {tuple(int(want[k]) for k in _IP_STATIC)}")
    module.load_state_dict(_EXTRAS[key](tree), strict=True)
