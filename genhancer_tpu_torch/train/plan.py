"""Shape-only memory and parallelism planner (``genhancer-plan-torch``).

Port of ``genhancer_tpu/train/plan.py``.  It answers "will this config fit
on these cards, and which knobs should I turn?" before any card is rented:
the task state is built on the ``meta`` device through the real
``create_task_state`` (``shape_state``: every leaf's shape and dtype, the
optimizer moments included, as ``optimizer.init`` makes them; no weight is
materialized, no HF tower directory, stage-1 file or data shard is opened),
and the bytes each rank keeps follow the port's own placement rules on that
tree: the DiT's TP spec (``parallel.tp.port_spec``, JAX's
``dit_param_spec`` through ``jax_path``), FSDP's blocks
(``parallel.fsdp.fsdp_spec``) of the trainable and frozen leaves and of the
static int8 factors, the ZeRO-1 row ranges (``mesh.row_range``'s rule) of
the moments of the leaves no placement shards, 8-bit moments (codes and a
float32 scale per row) where the optimizer keeps them.  The seq and pipe
axes keep every parameter whole on every rank and only shrink the data
axis (``dp = n / (tp * sp * pp)``).  Static residency is therefore the live
state's, byte for byte.

The activation peak is JAX's labelled heuristic (``plan.py:99-141``),
carried over as it is so that the two packages give the same report; it is
not a measurement of this port (``chip_smoke.py`` prints it beside the
measured peak).  The port's ``train_batch_size`` is each data rank's, so a
rank's tokens are ``train_batch_size x seq / sp``.

The escalation ladder and its legality rules are JAX's: cheapest
collective first, never FSDP under SP or PP or with the fused optimizer.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..core.kernels.adamw import Moment8
from ..parallel import fsdp as fsdp_m
from ..parallel import tp as tp_m
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS
from ..tasks import factory, image as image_task, video as video_task
from . import optim

GiB = 1024.0 ** 3
# the buffers that are state leaves (static int8 factors), as parallel.layout
_BUFFER_LEAVES = ("weight_q", "w_scale")


def shape_state(cfg):
    """(spec, ckpt_kind, state, optimizer): the task state of ``cfg`` on
    the meta device, as one process builds it (no mesh), its optimizer
    state from ``optimizer.init``; nothing is read from disk.  The plan is
    for cards that need not be present: ``num_devices`` is not held to
    this process's world."""
    spec, _, ckpt_kind = factory.build_spec(cfg.merged_with({"num_devices": None}))
    spec = dataclasses.replace(spec, tower_dir=None, vae_path=None)
    task = image_task if ckpt_kind == "image" else video_task
    # the moments as one process makes them (whole leaves): the placement
    # rules below shard them
    optimizer = optim.make_optimizer(
        cfg.merged_with({"shard_optimizer_state": False}),
        total_steps=int(cfg.get("max_train_steps") or 1000),
        emit_quant=(cfg.get("dit_quant", "none") != "none"
                    and cfg.get("fused_optimizer") == "pallas"))
    state = task.create_task_state(torch.Generator(), spec, optimizer, device="meta")
    return spec, ckpt_kind, state, optimizer


def _meta(shape) -> torch.Tensor:
    return torch.empty(tuple(shape), device="meta")


def _leaf_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def leaf_spec(path: str, shape, dp: int, tp: int, fsdp: bool, fsdp_min: int) -> Tuple:
    """The spec of the leaf at flat ``path`` under the trainer's placement
    (``parallel.layout.leaf_placement`` with a data axis of ``dp``)."""
    base = (tp_m.port_spec(path[len("dit."):], _meta(shape))
            if tp > 1 and path.startswith("dit.") else ())
    return tuple(fsdp_m.fsdp_spec(_meta(shape), dp, base, fsdp_min) if fsdp else base)


def _shard_factor(spec, dp: int, tp: int) -> int:
    f = 1
    for ax in spec:
        f *= dp if ax == DATA_AXIS else (tp if ax == MODEL_AXIS else 1)
    return f


def _params_bytes(flat: Dict[str, torch.Tensor], dp: int, tp: int, fsdp: bool,
                  fsdp_min: int) -> int:
    """Per-rank bytes of a flat ``{path: tensor}`` under the placements."""
    return sum(_leaf_bytes(t) // _shard_factor(leaf_spec(path, t.shape, dp, tp, fsdp,
                                                         fsdp_min), dp, tp)
               for path, t in flat.items())


def _moments_bytes(trainable: Dict[str, torch.Tensor], opt_state: dict, dp: int, tp: int,
                   fsdp: bool, fsdp_min: int, zero1: bool) -> int:
    """Per-rank bytes of the moments: a moment of a placed leaf keeps its
    block (an 8-bit moment's per-row scales where the rows are sharded),
    else its ZeRO-1 rows where the leading dimension divides the data axis
    (``optim.shard_rows``), else all of it."""
    total = 0
    for path, p in trainable.items():
        spec = leaf_spec(path, p.shape, dp, tp, fsdp, fsdp_min)
        f = _shard_factor(spec, dp, tp)
        rows_f = _shard_factor(spec[:1], dp, tp)
        if not spec and zero1 and p.dim() and p.shape[0] % dp == 0:
            f = rows_f = dp
        for name in ("mu", "nu"):
            leaf = opt_state[name][path]
            if isinstance(leaf, Moment8):
                total += _leaf_bytes(leaf.q) // f + _leaf_bytes(leaf.s) // rows_f
            else:
                total += _leaf_bytes(leaf) // f
    return total


def static_leaves(state) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(trainable, frozen) flat dicts of a state: the frozen ones are the
    frozen parameters and the static int8 factors (``weight_q``,
    ``w_scale`` buffers), the leaves the placement shards."""
    frozen = dict(state.frozen)
    for name, b in state.modules.named_buffers():
        if name.rsplit(".", 1)[-1] in _BUFFER_LEAVES:
            frozen[name] = b
    return dict(state.trainable), frozen


def _activation_bytes(spec, cfg, dp: int, sp: int) -> Tuple[int, str]:
    """Coarse DiT activation-peak heuristic, labelled as such (JAX's
    ``_activation_bytes``).

    Per-rank tokens T = train_batch_size x (joint seq / sp) (the port's
    batch is each data rank's).  Without remat each block keeps ~10 live
    intermediates of width hidden (qkv, attention out, two MLP tensors,
    norms/modulation, residuals) in compute_dtype; with remat ~2 per block
    boundary survive to the backward.  Flash attention keeps the score
    matrix O(L), so it adds no L^2 term.  Stage 2 adds the tower under
    autograd (~10 width-units per layer, 2 with tower_remat)."""
    bs = int(cfg.get_path("data_config.train_batch_size", cfg.get("train_batch_size", 16)))
    n_cond = getattr(spec, "n_cond", 1)
    patch = spec.tower_cfg.vision.patch_size if hasattr(spec.tower_cfg, "vision") else 14
    seq = n_cond * (spec.clip_image_size // patch) ** 2 + (spec.img_size // 16) ** 2
    t_per_dev = bs * (seq / sp)
    width = spec.dit_cfg.hidden_size
    blocks = spec.dit_cfg.depth + spec.dit_cfg.depth_single_blocks
    live = 2 if spec.remat else 10
    itemsize = torch.empty((), dtype=spec.compute_dtype).element_size()
    est = int(t_per_dev * width * blocks * live * itemsize)
    note = (f"~{live} live tensors/block x {blocks} blocks x "
            f"{int(t_per_dev)} tokens/device x {width} wide "
            f"({'remat' if spec.remat else 'no remat'}; heuristic +/-2x)")
    if spec.stage != "stage1" and hasattr(spec.tower_cfg, "vision"):
        v = spec.tower_cfg.vision
        t_live = 2 if getattr(spec, "tower_remat", False) else 10
        t_tok = bs * n_cond * ((v.image_size // v.patch_size) ** 2 + 1)
        t_est = int(t_tok * v.hidden_size * v.num_layers * t_live * itemsize)
        est += t_est
        note += (f" + tower-under-autodiff ~{t_est / GiB:.2f} GiB "
                 f"({int(t_tok)} tok x {v.num_layers} layers x "
                 f"{v.hidden_size} wide"
                 f"{'; tower_remat' if t_live == 2 else ''})")
    return est, note


def visible_devices() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def plan(cfg, num_devices: Optional[int] = None, hbm_gb: float = 80.0) -> Dict:
    """Residency report and the first knob escalation that fits.

    Returns {'task', 'num_devices', 'hbm_gb', 'ckpt_kind', 'configured',
    'candidates', 'recommendation'}; each entry carries per-rank GiB of
    the trainable and frozen leaves, the optimizer state, the gradients,
    the activation estimate, and the total against ``hbm_gb``."""
    spec, ckpt_kind, state, _ = shape_state(cfg)
    n = int(num_devices or cfg.get("num_devices") or visible_devices())
    if n < 1:
        raise ValueError("num_devices: give it (--num_devices) or set it in the config; "
                         "no card is visible to count")
    tp0 = int(cfg.get("model_parallel", 1) or 1)
    sp0 = int(cfg.get("sequence_parallel", 1) or 1)
    pp0 = int(cfg.get("pipeline_parallel", 1) or 1)
    fsdp_min = int(cfg.get("fsdp_min_size", fsdp_m.MIN_SHARD_SIZE))
    trainable, frozen = static_leaves(state)

    def entry(name: str, *, tp: int, fsdp: bool, zero1: bool,
              remat: Optional[bool] = None, tower_remat: Optional[bool] = None) -> Dict:
        dp = max(1, n // (tp * sp0 * pp0))
        repl = {k: v for k, v in dict(remat=remat, tower_remat=tower_remat).items()
                if v is not None}
        sp_eff = dataclasses.replace(spec, **repl) if repl else spec
        t_b = _params_bytes(trainable, dp, tp, fsdp, fsdp_min)
        f_b = _params_bytes(frozen, dp, tp, fsdp, fsdp_min)
        m_b = _moments_bytes(trainable, state.opt_state, dp, tp, fsdp, fsdp_min, zero1)
        g_b = t_b          # the gradients take the (placed) trainable leaves' bytes
        a_b, a_note = _activation_bytes(sp_eff, cfg, dp, sp0)
        total = t_b + f_b + m_b + g_b + a_b
        return {"name": name, "dp": dp, "tp": tp,
                "trainable_gib": t_b / GiB, "frozen_gib": f_b / GiB,
                "opt_state_gib": m_b / GiB, "grads_gib": g_b / GiB,
                "activations_gib_est": a_b / GiB, "activation_note": a_note,
                "total_gib": total / GiB, "fits": total / GiB <= hbm_gb,
                "knobs": {"model_parallel": tp, "fsdp": fsdp,
                          "shard_optimizer_state": zero1,
                          **({} if remat is None else {"remat": remat}),
                          **({} if tower_remat is None else {"tower_remat": tower_remat})}}

    configured = entry("as configured", tp=tp0, fsdp=bool(cfg.get("fsdp", False)),
                       zero1=bool(cfg.get("shard_optimizer_state", False)))

    # escalation ladder: cheapest-collective knob first
    candidates: List[Dict] = [configured]
    if not configured["fits"]:
        # tower remat only exists where a tower sits under autograd
        t_r = True if (spec.stage != "stage1" and hasattr(spec.tower_cfg, "vision")) else None
        ladder = [("+ shard_optimizer_state (ZeRO-1)", dict(tp=tp0, fsdp=False, zero1=True)),
                  ("+ remat", dict(tp=tp0, fsdp=False, zero1=True, remat=True))]
        if t_r:
            ladder.append(("+ remat + tower_remat",
                           dict(tp=tp0, fsdp=False, zero1=True, remat=True, tower_remat=True)))
        t_tag = " + tower_remat" if t_r else ""
        # fsdp rungs only where fsdp is legal (factory.validate_parallelism:
        # no PP/SP/fused optimizer): never a combination the trainer rejects
        fsdp_ok = sp0 == 1 and pp0 == 1 and cfg.get("fused_optimizer") != "pallas"
        if fsdp_ok:
            ladder += [(f"+ fsdp (ZeRO-3){t_tag}",
                        dict(tp=tp0, fsdp=True, zero1=True, tower_remat=t_r)),
                       (f"+ fsdp + remat{t_tag}",
                        dict(tp=tp0, fsdp=True, zero1=True, remat=True, tower_remat=t_r))]
        for tp in (2, 4, 8):
            if fsdp_ok and tp > tp0 and n % (tp * sp0 * pp0) == 0:
                try:
                    tp_m.validate_tp(spec.dit_cfg, tp)
                except ValueError:
                    continue
                ladder.append((f"+ fsdp + remat{t_tag} + model_parallel {tp}",
                               dict(tp=tp, fsdp=True, zero1=True, remat=True,
                                    tower_remat=t_r)))
        for name, kw in ladder:
            e = entry(name, **kw)
            if abs(e["total_gib"] - candidates[-1]["total_gib"]) < 1e-9:
                continue   # the knob is a no-op here (dp = 1, remat already on)
            candidates.append(e)
            if e["fits"]:
                break

    fitting = [c for c in candidates if c["fits"]]
    rec = (fitting[0]["name"] if fitting else
           "nothing fits — raise num_devices, lower the batch, or shrink the model")
    return {"task": cfg["task"], "num_devices": n, "hbm_gb": hbm_gb,
            "ckpt_kind": ckpt_kind, "configured": configured,
            "candidates": candidates, "recommendation": rec}


def live_bytes(state) -> Dict[str, int]:
    """The bytes this rank's live state holds, as ``plan`` counts them:
    trainable and frozen leaves (with the static int8 factors) and the
    optimizer moments."""
    trainable, frozen = static_leaves(state)
    moments = 0
    for name in ("mu", "nu"):
        for leaf in state.opt_state[name].values():
            for t in ((leaf.q, leaf.s) if isinstance(leaf, Moment8) else (leaf,)):
                moments += _leaf_bytes(t)
    return {"trainable": sum(_leaf_bytes(t) for t in trainable.values()),
            "frozen": sum(_leaf_bytes(t) for t in frozen.values()), "opt_state": moments}
