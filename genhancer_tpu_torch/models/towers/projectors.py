"""Conditioning heads bridging the tower to the DiT.

Port of ``genhancer_tpu/models/towers/projectors.py``:

  * ``project_clip`` / ``project_t5`` (image mode) are LayerNorm(eps 1e-5)
    -> Linear -> exact GELU -> Linear, with the torch ``nn.Sequential``
    indices "0", "1", "3" as module names so ``checkpoint-project-*-N.bin``
    loads strictly;
  * ``VisualPromptAdapter`` (video modes) is Linear(d, 2d) -> SiLU ->
    Linear(2d, 4096) -> LayerNorm(eps 1e-5) over the tower's patch tokens
    (``projectors.py:37-49``), under ``proj.0`` / ``proj.2`` / ``proj.3`` so
    ``checkpoint-visual-adapter-N.bin`` loads strictly.
"""

from __future__ import annotations

import torch
from torch import nn as tnn

from ...core import nn


class Projector(tnn.Module):
    def __init__(self, in_dim: int, out_dim: int, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.add_module("0", nn.LayerNorm(in_dim, **fk))
        self.add_module("1", nn.Linear(in_dim, out_dim, **fk))
        self.add_module("3", nn.Linear(out_dim, out_dim, **fk))


def projector(p: Projector, x: torch.Tensor) -> torch.Tensor:
    # torch LayerNorm default eps is 1e-5
    x = nn.layernorm(p._modules["0"], x, eps=1e-5)
    x = nn.gelu_exact(nn.linear(p._modules["1"], x))
    return nn.linear(p._modules["3"], x)


class VisualPromptAdapter(tnn.Module):
    def __init__(self, in_dim: int = 1024, out_dim: int = 4096, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.proj = tnn.ModuleDict({"0": nn.Linear(in_dim, 2 * in_dim, **fk),
                                    "2": nn.Linear(2 * in_dim, out_dim, **fk),
                                    "3": nn.LayerNorm(out_dim, **fk)})


def visual_adapter(p: VisualPromptAdapter, x: torch.Tensor) -> torch.Tensor:
    h = nn.silu(nn.linear(p.proj["0"], x))
    h = nn.linear(p.proj["2"], h)
    return nn.layernorm(p.proj["3"], h, eps=1e-5)
