"""The comparison that decides ``correct``: the program's first optimizer
steps against the plain reference's, from the same weights, pixels and
random draws.

The readings, each a number that the workload file's ``limits`` may hold
to a limit of its own (those it names decide ``correct``):

  * ``loss_gap``: the largest ``|loss_p - loss_r| / |loss_r|`` over the
    checked steps; ``loss1_gap`` that of the first step alone;
  * ``grad_gap``: over the trained leaves, the largest gap between the norms
    of the first step's clipped gradient, the program's worked out from its
    optimizer state after that step (``mu / (1 - beta1)``); ``update_gap``
    the same of each leaf's change over the checked steps.  A leaf's gap is
    ``|norm_p - norm_r|`` over the larger of the reference's norm of that
    leaf and of the median leaf;
  * ``grad_diff``: the same leaves' first clipped gradient, its relative
    difference ``|g_p - g_r| / max(|g_r|, median leaf's |g_r|)`` on a
    sample of ``SAMPLE`` elements of each leaf drawn from the seed, the
    worst leaf; ``grad_diff_median`` the median leaf's ``|g_p - g_r| /
    |g_r|``.  A norm is blind to rounding noise that has no direction (it
    moves it at second order); the difference is not;
  * ``input_rows_off`` (set by the harness, where it checks the input
    stage): the number of recorded training rows that are not the
    reference's own decode of the raw shards.

Leaves whose reference gradient is under a thousandth of the median leaf's
(moved by round-off alone) are left out of all leaf readings, by that rule
and not by name.  A number that is not finite reads infinite.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import torch

SMALL_GRADIENT = 1e-3
SAMPLE = 1 << 16
READINGS = ("loss_gap", "loss1_gap", "grad_gap", "update_gap", "grad_diff", "grad_diff_median",
            "input_rows_off")


def sample_indices(numels: Dict[str, int], seed: int) -> Dict[str, torch.Tensor]:
    """Flat indices of up to ``SAMPLE`` elements of each leaf, from the seed."""
    g = torch.Generator().manual_seed(int(seed) % (1 << 63))
    out = {}
    for k in sorted(numels):
        n = numels[k]
        out[k] = (torch.arange(n) if n <= SAMPLE
                  else torch.randint(0, n, (SAMPLE,), generator=g))
    return out


def _gap(p: float, r: float, scale: float) -> float:
    return abs(p - r) / scale if math.isfinite(p) and math.isfinite(r) else math.inf


def _worst(gaps: Dict[str, float]) -> Tuple[float, str]:
    worst, leaf = 0.0, ""
    for k, g in gaps.items():
        if not g <= worst:
            worst, leaf = g, k
    return worst, leaf


def _norm_gaps(prog: Dict[str, float], ref: Dict[str, float], keys: List[str]):
    med = statistics.median(ref.values())
    return {k: _gap(prog.get(k, math.nan), ref[k], max(ref[k], med)) for k in keys}


def _diffs(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keys: List[str]):
    """({leaf: |p - r| / max(|r|, median |r|)}, {leaf: |p - r| / |r|})."""
    norms = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keys}
    med = statistics.median(norms.values()) if norms else 0.0
    d = {k: float(torch.linalg.vector_norm(prog[k].double() - ref[k].double())) for k in keys}
    d = {k: v if math.isfinite(v) else math.inf for k, v in d.items()}
    return ({k: d[k] / max(norms[k], med) for k in keys},
            {k: d[k] / norms[k] if norms[k] > 0 else math.inf for k in keys})


def readings(prog: dict, ref: dict):
    """({number: reading}, {number: where it was worst}, {leaf: the first
    gradient's sampled relative difference})."""
    losses = {f"step {i + 1}": _gap(p, r, abs(r))
              for i, (p, r) in enumerate(zip(prog["loss"], ref["loss"]))}
    loss, step = _worst(losses)
    g_ref = ref["grad_norm"]
    med = statistics.median(g_ref.values())
    kept = [k for k, v in g_ref.items() if v >= SMALL_GRADIENT * med]
    grad, g_leaf = _worst(_norm_gaps(prog["grad_norm"], g_ref, kept))
    upd, u_leaf = _worst(_norm_gaps(prog["update_norm"], ref["update_norm"], kept))
    gd, gd_rel = _diffs(prog["grad_sample"], ref["grad_sample"], kept)
    grad_diff, gd_leaf = _worst(gd)
    values = {"loss_gap": loss, "loss1_gap": losses["step 1"], "grad_gap": grad,
              "update_gap": upd, "grad_diff": grad_diff,
              "grad_diff_median": statistics.median(gd_rel.values())}
    where = {"loss_gap": step, "grad_gap": g_leaf, "update_gap": u_leaf, "grad_diff": gd_leaf,
             "left_out": ",".join(sorted(set(g_ref) - set(kept)))}
    return values, where, gd_rel


def judge(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(values[n] <= lim for n, lim in limits.items())


def checks(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """The result line's last key: each number held to a limit, beside it."""
    return {n: {"value": values[n], "limit": lim} for n, lim in limits.items()}
