"""Torch state-dict files and HF model directories.

The port's own copy of ``genhancer_tpu/weights/torch_io.py:68-146``: the
reference keeps everything as ``torch.save(state_dict())`` ``.bin`` files
(the checkpoints of ``train.checkpoint`` too) and HF ``save_pretrained``
directories (``pytorch_model.bin`` or ``model.safetensors``, each possibly
sharded behind an index).  Tensors stay torch tensors in their stored
dtype; ``load_state_dict`` on a module casts them.  ``.safetensors`` files
are read here without the ``safetensors`` package: an 8-byte little-endian
header length, a JSON header ``{name: {dtype, shape, data_offsets}}``, then
the raw bytes.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict

import torch

StateDict = Dict[str, torch.Tensor]

_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
              "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def save_state_dict(sd: StateDict, path: str) -> None:
    """Write ``sd`` (CPU copies of its tensors) as a ``torch.load``-able
    ``.bin`` that HF ``from_pretrained`` reads."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: v.detach().cpu().contiguous() for k, v in sd.items()}, path)


def load_state_dict(path: str) -> StateDict:
    return torch.load(path, map_location="cpu", weights_only=True)


def load_safetensors(path: str) -> StateDict:
    """Every tensor of a ``.safetensors`` file, on the CPU."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if len(data) < 8:
        raise ValueError(f"{path}: not a safetensors file ({len(data)} bytes)")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > len(data):
        raise ValueError(f"{path}: header of {n} bytes overruns the file")
    header = json.loads(data[8:8 + n].decode("utf-8"))
    base, out = 8 + n, {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(meta["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {meta['dtype']}, which the port "
                             "does not read")
        begin, end = meta["data_offsets"]
        shape = tuple(meta["shape"])
        numel = 1
        for s in shape:
            numel *= s
        if end - begin != numel * torch.empty((), dtype=dtype).element_size() \
                or base + end > len(data):
            raise ValueError(f"{path}: {name}'s offsets {begin}-{end} do not hold {shape} "
                             f"{meta['dtype']}")
        # a copy of the bytes: aligned for the dtype, and owned by the tensor
        t = (torch.frombuffer(bytearray(data[base + begin: base + end]), dtype=dtype)
             if numel else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(shape)
    return out


def load_hf_dir_state_dict(model_dir: str) -> StateDict:
    """The weights of an HF model directory: ``pytorch_model.bin`` or
    ``model.safetensors``, else the shards named by
    ``model.safetensors.index.json`` / ``pytorch_model.bin.index.json``."""
    bin_path = os.path.join(model_dir, "pytorch_model.bin")
    st_path = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(bin_path):
        return load_state_dict(bin_path)
    if os.path.exists(st_path):
        return load_safetensors(st_path)
    for name in ("model.safetensors.index.json", "pytorch_model.bin.index.json"):
        idx = os.path.join(model_dir, name)
        if os.path.exists(idx):
            break
    else:
        raise FileNotFoundError(f"no weights found in {model_dir}")
    with open(idx) as f:
        weight_map = json.load(f)["weight_map"]
    out: StateDict = {}
    for shard in sorted(set(weight_map.values())):
        sp = os.path.join(model_dir, shard)
        out.update(load_safetensors(sp) if shard.endswith(".safetensors")
                   else load_state_dict(sp))
    return out


def load_hf_config(model_dir: str) -> dict:
    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f)
