"""Weights from the run's seed, made on the card in a few large draws, for
the program and the reference alike.

Every parameter the stage-1 step reads (``reference.model.param_shapes``,
in its fixed order) takes its values from one stream of uniform draws on
[-1, 1), drawn ``CHUNK`` values at a time from one ``torch.Generator`` on
the device, scaled by the parameter's kind:

  * a weight of two or more dimensions: ``U(-a, a)``, ``a = sqrt(3 / fan_in)``
    (unit variance through the layer, PyTorch's default scale);
  * a 1-d ``weight`` or ``scale`` (the norms' gains): ``1 + U(-0.1, 0.1)``;
  * a bias: ``U(-0.02, 0.02)``; the CLIP class embedding: ``U(-sqrt 3, sqrt 3)``.

The program's parameters take the values in their own dtype (the DiT's
bfloat16 rounds them); the reference rounds the DiT's to the configuration's
parameter dtype itself.  The same seed on the same device gives the same
values.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from .reference import model as ref_model
from .reference.step import DTYPES

CHUNK = 1 << 27


def _affine(name: str, shape: Sequence[int]) -> Tuple[float, float]:
    if len(shape) >= 2:
        return math.sqrt(3.0 / math.prod(shape[1:])), 0.0
    if name.endswith("class_embedding"):
        return math.sqrt(3.0), 0.0
    if name.endswith("bias"):
        return 0.02, 0.0
    return 0.1, 1.0


def _generator_seed(seed: int) -> int:
    return (int(seed) * 2654435761 + 97) % (1 << 63)


def draw(shapes: List[Tuple[str, tuple]], seed: int, device,
         put: Callable[[str, int, torch.Tensor], None]) -> None:
    """Call ``put(name, offset, values)`` with float32 ``values`` for the
    flat elements ``[offset, offset + len)`` of each parameter."""
    g = torch.Generator(device=device)
    g.manual_seed(_generator_seed(seed))
    bounds, lo = [], 0
    for name, shape in shapes:
        n = math.prod(shape)
        bounds.append((name, lo, lo + n, _affine(name, shape)))
        lo += n
    total, leaf = lo, 0
    for c0 in range(0, total, CHUNK):
        c1 = min(total, c0 + CHUNK)
        u = torch.rand(c1 - c0, generator=g, device=device).mul_(2).sub_(1)
        while leaf < len(bounds) and bounds[leaf][1] < c1:
            name, a, b, (scale, shift) = bounds[leaf]
            s, e = max(a, c0), min(b, c1)
            put(name, s - a, u[s - c0:e - c0] * scale + shift)
            if b > c1:
                break
            leaf += 1
        del u


def fill_program(modules: torch.nn.Module, model: dict, seed: int,
                 prefixes: Sequence[str] = ()) -> None:
    """Overwrite the program's parameters with the seed's values.

    Every name of ``param_shapes`` must be a parameter of ``modules`` of the
    same shape, and the program's other parameters must lie under the
    configuration's ``unused`` prefixes (modules the step never reads);
    ``prefixes`` limits the fill to names under them (a frozen subset)."""
    flat = dict(modules.named_parameters())
    shapes = ref_model.param_shapes(model)
    wanted = [(n, s) for n, s in shapes if not prefixes or n.startswith(tuple(prefixes))]
    for n, s in wanted:
        if n not in flat or tuple(flat[n].shape) != tuple(s):
            got = tuple(flat[n].shape) if n in flat else "missing"
            raise RuntimeError(f"the program's parameter {n} is {got}, the configuration "
                               f"gives {tuple(s)}")
    names = {n for n, _ in shapes}
    extra = [n for n in flat if n not in names
             and not n.startswith(tuple(model.get("unused", ())))
             and (not prefixes or n.startswith(tuple(prefixes)))]
    if extra:
        raise RuntimeError(f"the program has parameters the step's reference does not: "
                           f"{extra[:5]} ({len(extra)})")
    keep = {n for n, _ in wanted}

    @torch.no_grad()
    def put(name, offset, values):
        if name in keep:
            dst = flat[name].data.view(-1)
            dst[offset:offset + values.numel()].copy_(values)

    draw(shapes, seed, next(iter(flat.values())).device, put)


def reference_params(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seed's values as float32 tensors, the DiT's rounded to the
    configuration's parameter dtype."""
    shapes = ref_model.param_shapes(model)
    out = {n: torch.empty(s, dtype=torch.float32, device=device) for n, s in shapes}

    def put(name, offset, values):
        out[name].view(-1)[offset:offset + values.numel()].copy_(values)

    draw(shapes, seed, device, put)
    store = DTYPES[model["dit_param_dtype"]]
    for n, t in out.items():
        if n.startswith("dit."):
            t.copy_(t.to(store))
    return out
