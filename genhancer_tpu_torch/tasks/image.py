"""Image-mode tasks: stage 1 (projectors + DiT) and stage 2 (tower LoRA).

Port of ``genhancer_tpu/tasks/image.py``: ``TaskSpec`` (the static
description the engine and the trainer read), ``init_modules``
(random-init module tree in the reference layout ``{dit, vae,
clip{model, project_clip, project_t5}}``, the tower from
``clip_config.model_dir`` where one is given), ``trainable_predicate``,
``make_loss_fn`` (the inline ``{image}`` branch: frozen VAE encode under
``torch.no_grad()``, the tower, logit-normal t, interpolation, DiT
forward, float32 MSE against the velocity), ``make_train_step`` and
``create_task_state``.

The tower is CLIP/MetaCLIP (kind ``clip``) or SigLIP so400m (kind
``siglip``, whose MAP-pooled 1152-d output feeds the projectors).  Stage 1
trains the DiT and the projectors on a frozen vision-only tower (under
``torch.no_grad()``).  Stage 2 (``stage2_only``: the tower's LoRA alone,
gradients passing through the frozen DiT and projectors; ``stage2_all``:
LoRA + DiT + projectors) builds the whole ``CLIPModel`` or ``SiglipModel``,
wraps it with LoRA (``train.lora``; ``lora_*`` of the spec) and runs the
tower under autograd inside ``core.nn.lora_dropout_ctx``
(``image.py:206-275``): K2 (K5 at the SigLIP-384 tower's 729 tokens) saves
each row's log-sum-exp and K2b (K5b) runs the tower's attention backward;
``tower_remat`` checkpoints each tower layer
(``models.towers.encoder.tower_remat_scope``).

The precomputed caches (``data.precompute``) gate the frozen paths by batch
key (``image.py:206-240``): ``{image}`` runs the VAE and the tower inline;
``{moments, image}`` (the latent cache, every stage) samples the posterior
from the cached moments and runs the tower on the cached crop;
``{moments, cls}`` (the stage-1 features cache) skips the tower as well.

Random draws come from one ``torch.Generator``; a test hands the loss the
JAX package's own draws instead (``draws``: ``t`` [B], ``x0`` [B, L, C],
``vae_noise`` [B, h, w, z], and in stage 2 ``lora_masks``, one bool keep-mask
per LoRA-wrapped call in call order).

The int8 stack (``configs/tpu_fast_stage1.yaml``): ``tower_quant: int8``
and ``vae_quant: int8`` quantize the frozen tower's linears and the VAE
encoder's wide convs at init (``init_modules``, module surgery of
``core.quant``); ``dit_quant`` (int8 | int8_full | int8_dw) runs the DiT's
large linears through SwitchBack inside ``core.nn.int8_training_ctx``, and
``dit_quant_cache`` (set with ``fused_optimizer: pallas``) keeps their int8
copies in the state, emitted by the optimizer (K4/K6) after the first step.
In stage 2 ``tower_quant: int8`` is QLoRA (``core.quant.quantize_lora_base``
on the whole LoRA-wrapped model, text side included: the int8 base beside
the kept float weights), and in ``stage2_only`` ``dit_quant`` gives the
frozen DiT the same static int8 base, run outside the SwitchBack context
(``image.py:150-175, 256-261``).

Sequence and pipeline parallelism (``image.py:284-342``): with
``sequence_parallel`` the loss opens ``parallel.ring.ring_scope`` around the
DiT forward, which then returns the velocity of the rank's img tokens, and
the loss holds them against the same tokens of the target over the whole
token count (``flow.mse_loss``'s ``tokens``); with ``pipeline_parallel``
the DiT runs as ``parallel.pp.pipeline_dit_forward`` with
``pipeline_microbatches`` (0: one per stage).  Both need the mesh
(``parallel.mesh.make_mesh``) with the matching axis, else JAX's
``ValueError``; PP with ``dit_quant`` raises JAX's ``ValueError``.  SP with
``dit_quant`` runs the int8 DiT on the rank's tokens: the scales and K8's
blocks that span tokens are taken over every seq rank's (``core.quant``),
so each SwitchBack call is one process's.

``remat`` checkpoints each DiT block under ``remat_policy``
(``models.dit``, ``image.py:269-270``).  ``tower_quant: int8`` on the SigLIP
tower quantizes its linears as on CLIP's (``core/quant.py:468-480``): every
linear with min(out, in) >= 64 whose path names no embedding — each layer's
q, k, v, out_proj, fc1, fc2 and the MAP head's ``out_proj`` and MLP; the
head's packed ``in_proj_weight`` has no ``weight`` and stays float, as in
JAX.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn as tnn

from .. import registry, tracing
from ..core import quant
from ..core.nn import init_weights, int8_training_ctx, lora_dropout_ctx
from ..models import dit as dit_m
from ..models import vae as vae_m
from ..models.towers.encoder import tower_remat_scope
from ..models.towers.projectors import Projector
from ..parallel.mesh import data_size, local_rows, randn_rows
from ..train import flow, lora
from ..train import step_utils
from ..train.state import TrainState, create_state, mark_whole_grads, with_quant_cache
from .conditioning import (VAE_MEAN, VAE_STD, image_conditioning,
                           image_conditioning_from_cls, normalize, tower_features,
                           tower_stats)


@dataclass(frozen=True)
class TaskSpec:
    """Static description of one image task."""
    stage: str                       # "stage1" | "stage2_only" | "stage2_all"
    tower_kind: str                  # "clip" | "siglip"
    img_size: int                    # VAE input resolution
    clip_image_size: int
    dit_cfg: dit_m.DiTConfig
    vae_cfg: vae_m.VAEConfig
    tower_cfg: object                # CLIPConfig | SiglipConfig
    clip_dim: int = 768
    t5_dim: int = 4096
    scale_factor: float = 1.0
    guidance: float = 4.0
    lora_r: int = 16
    lora_alpha: float = 16.0
    lora_targets: object = "all-linear"
    lora_bias: str = "lora_only"
    lora_dropout: float = 0.0
    remat: bool = False
    # what each remat'd DiT block keeps (models.dit.REMAT_POLICIES)
    remat_policy: str = "full"
    tower_remat: bool = False         # checkpoint each tower layer (stage 2)
    compute_dtype: torch.dtype = torch.bfloat16
    # the reference stores DiT params in bf16; tower, projectors and VAE
    # stay float32 and are cast at use
    dit_param_dtype: torch.dtype = torch.bfloat16
    vae_dtype: torch.dtype = torch.float32   # conv dtype of the frozen encode
    # int8 (core.quant): the frozen tower's linears and the VAE encoder's
    # convs with in and out channels >= vae_quant_min_ch
    tower_quant: str = "none"         # "none" | "int8"
    vae_quant: str = "none"           # "none" | "int8"
    vae_quant_min_ch: int = quant.INT8_CONV_MIN_CH
    # SwitchBack int8 training of the DiT: "int8" (float32-product dW),
    # "int8_full" (per-column int8 dW), "int8_dw" (K8's per-block int8 dW)
    dit_quant: str = "none"
    # the optimizer-maintained int8 weight cache (with fused_optimizer: pallas)
    dit_quant_cache: bool = False
    # a local HF model directory holding the tower's weights
    # (clip_config.model_dir), or None for random init
    tower_dir: Optional[str] = None
    # the FLUX ae.safetensors the VAE loads (ae_path / $AE), or None for
    # random init
    vae_path: Optional[str] = None
    # ring attention over the mesh's seq axis (parallel.ring)
    sequence_parallel: int = 1
    # the GPipe DiT over the mesh's pipe axis (parallel.pp); 0 micro-batches
    # = one per stage
    pipeline_parallel: int = 1
    pipeline_microbatches: int = 0

    @property
    def latent_hw(self) -> Tuple[int, int]:
        f = 2 ** (len(self.vae_cfg.ch_mult) - 1)   # f8 for the FLUX VAE
        return (self.img_size // f, self.img_size // f)

    @property
    def tower_hidden(self) -> int:
        """Width of the class token the projectors take (``image.py:115-118``)."""
        return (self.tower_cfg.vision.hidden_size if self.tower_kind == "siglip"
                else self.tower_cfg.projection_dim)


STAGES = ("stage1", "stage2_only", "stage2_all")
DIT_QUANT = ("none", "int8", "int8_full", "int8_dw")


def is_stage2(spec) -> bool:
    return spec.stage in ("stage2_only", "stage2_all")


def build_modules(spec: TaskSpec, device=None) -> tnn.ModuleDict:
    """Uninitialised modules in the reference layout, on ``device``: the
    vision-only tower in stage 1, the whole ``CLIPModel`` or ``SiglipModel``
    in stage 2."""
    d = spec.tower_hidden
    tower_cls = registry.tower_class(spec.tower_kind, is_stage2(spec))
    return tnn.ModuleDict({
        "dit": dit_m.DiT(spec.dit_cfg, device=device, dtype=spec.dit_param_dtype),
        "vae": vae_m.AutoEncoder(spec.vae_cfg, device=device),
        "clip": tnn.ModuleDict({
            "model": tower_cls(spec.tower_cfg, device=device),
            "project_clip": Projector(d, spec.clip_dim, device=device),
            "project_t5": Projector(d, spec.t5_dim, device=device),
        }),
    })


def init_modules(spec: TaskSpec, generator: torch.Generator,
                 device=None) -> tnn.ModuleDict:
    """Random-init modules drawn from ``generator`` (on ``device``), the
    tower's weights from ``spec.tower_dir`` and the VAE's from
    ``spec.vae_path`` where they are set, LoRA injected in stage 2 (its A's
    drawn from ``generator`` after everything else), and then, in JAX's
    order, the spec's frozen int8 surgery applied (``quantize_modules``)."""
    require_ported(spec)
    modules = init_weights(build_modules(spec, device), generator)
    load_pretrained(spec, modules, device)
    if is_stage2(spec):
        lora.inject(modules["clip"]["model"], generator, r=spec.lora_r,
                    alpha=spec.lora_alpha, targets=spec.lora_targets)
    return quantize_modules(spec, modules)


def load_pretrained(spec, modules: tnn.ModuleDict, device=None) -> None:
    """The weight files of an image or video spec, in place: the tower from
    ``spec.tower_dir`` (the whole model in stage 2) and the VAE from
    ``spec.vae_path``."""
    if spec.tower_dir is not None:
        modules["clip"]["model"], _ = registry.load_tower(
            spec.tower_kind, spec.tower_cfg, spec.tower_dir, text_side=is_stage2(spec),
            device=device)
    if spec.vae_path is not None:
        registry.load_vae(modules["vae"], spec.vae_path)


def quantize_modules(spec, modules: tnn.ModuleDict) -> tnn.ModuleDict:
    """``init_modules:150-175`` (image and video specs), in place:
    ``tower_quant: int8`` swaps the stage-1 tower's eligible linears
    (min(out, in) >= 64) for int8 ones and gives the stage-2 tower QLoRA's
    int8 base beside its kept weights; ``vae_quant: int8`` swaps the encoder
    convs whose in and out channels reach ``vae_quant_min_ch``; in
    ``stage2_only`` a ``dit_quant`` gives the frozen DiT the static int8
    base (it takes no dW, and its kept masters take the stage-1 load)."""
    for knob in ("tower_quant", "vae_quant"):
        if getattr(spec, knob) not in ("none", "int8"):
            raise ValueError(f"{knob} must be none|int8, got {getattr(spec, knob)!r}")
    stage2 = spec.stage in ("stage2_only", "stage2_all")
    if spec.tower_quant == "int8":
        (quant.quantize_lora_base if stage2 else quant.quantize_linear_tree)(
            modules["clip"]["model"])
    if spec.vae_quant == "int8":
        quant.quantize_conv_tree(modules["vae"].encoder, spec.vae_quant_min_ch)
    if spec.stage == "stage2_only" and spec.dit_quant != "none":
        quant.quantize_lora_base(modules["dit"])
    return modules


def require_ported(spec: TaskSpec) -> None:
    """Raise for a stage the image task does not have."""
    if spec.stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {spec.stage!r}")


def trainable_predicate(spec: TaskSpec, modules=None) -> Callable[[str], bool]:
    """Which flat paths train — parity with the reference requires_grad
    setup (``image.py:178-198``): stage 1 the DiT and both projectors
    (train_SigLIP_stage1.py:131,137-141); stage2_only the tower's LoRA
    factors and the biases of the wrapped modules (``bias: lora_only``);
    stage2_all those, the DiT and the projectors.  Stage 2 reads the
    wrapped set from ``modules``."""
    require_ported(spec)
    lora_paths = set()
    if is_stage2(spec):
        lora_paths = {"clip.model." + p
                      for p in lora.lora_trainable_paths(modules["clip"]["model"])}

    def stage1(path: str) -> bool:
        return (path.startswith("dit.")
                or ".project_clip." in path or ".project_t5." in path)

    def pred(path: str) -> bool:
        if spec.stage == "stage1":
            return stage1(path)
        if spec.stage == "stage2_only":
            return path in lora_paths
        return path in lora_paths or stage1(path)

    return pred


def make_loss_fn(spec: TaskSpec, mesh=None):
    """loss_fn(modules, batch, generator, draws=None) -> float32 scalar.

    ``batch`` (on the modules' device, + optional ``valid`` [B]): ``image``
    [B, H, W, 3] float32 in [0, 1]; or the latent cache's ``moments``
    [B, h, w, 2z] float32 and ``image`` (the cached crop); or the features
    cache's ``moments`` and ``cls`` [B, P] float32."""
    require_ported(spec)
    ring_ctx = ring_ctx_factory(spec, mesh)
    dit_apply = functools.partial(dit_apply_factory(spec, mesh), remat=spec.remat,
                                  remat_policy=spec.remat_policy)
    f32, cd = torch.float32, spec.compute_dtype
    # stage2_only's DiT is frozen and carries a static int8 base: no SwitchBack
    dit_ctx = dit_quant_ctx("none" if spec.stage == "stage2_only" else spec.dit_quant)

    def loss_fn(modules, batch, generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        draws = draws or {}
        if "moments" in batch:
            # the frozen encoder ran offline: sample the posterior from the
            # cached moments with the same draw as the inline path
            moments = batch["moments"].to(f32)
            b, dev = moments.shape[0], moments.device
            z = vae_m.diagonal_gaussian(moments, generator=generator,
                                        noise=draws.get("vae_noise"))
            x1_lat = spec.vae_cfg.scale_factor * (z - spec.vae_cfg.shift_factor)
        else:
            imgs = batch["image"]                   # [B, H, W, 3] in [0, 1]
            b, dev = imgs.shape[0], imgs.device
            with torch.no_grad():
                # frozen VAE encode: normalised in float32, convs at vae_dtype
                vae_in = normalize(imgs, VAE_MEAN, VAE_STD).to(f32)
                x1_lat = vae_m.vae_encode(modules["vae"], spec.vae_cfg, vae_in, generator,
                                          dtype=spec.vae_dtype, noise=draws.get("vae_noise"))
        x1 = dit_m.pack_latent(x1_lat).to(f32)
        if "cls" in batch:
            # the stage-1 features cache: the frozen tower ran offline too
            cond = image_conditioning_from_cls(modules["clip"], batch["cls"].to(f32),
                                               spec.latent_hw, compute_dtype=cd)
        elif is_stage2(spec):
            imgs = batch["image"]
            # the LoRA-wrapped tower trains: under autograd, its branches'
            # inputs dropped (peft parity, train_SigLIP_stage2_all.py:134-143)
            with lora_dropout_ctx(generator, spec.lora_dropout, draws.get("lora_masks")), \
                    tower_remat_scope(spec.tower_remat):
                cond = image_conditioning(spec.tower_kind, modules["clip"], imgs,
                                          spec.tower_cfg, spec.latent_hw, compute_dtype=cd)
        else:
            imgs = batch["image"]
            with torch.no_grad():
                # frozen tower: its class token feeds the (trained) projectors
                mean, std = tower_stats(spec.tower_kind)
                px = normalize(imgs, mean, std).to(cd)
                cls_tok, _ = tower_features(spec.tower_kind, modules["clip"], px,
                                            spec.tower_cfg)
            cond = image_conditioning_from_cls(modules["clip"], cls_tok, spec.latent_hw,
                                               compute_dtype=cd)
        t = draws.get("t")
        if t is None:
            # data parallel: the global batch's draw, this rank's rows
            t = local_rows(flow.sample_timesteps(b * data_size(), spec.scale_factor,
                                                 generator, dev))
        x0 = draws.get("x0")
        if x0 is None:
            x0 = randn_rows(x1.shape, generator, f32, dev)
        xt = flow.interpolate(x1, x0, t)
        guidance = torch.full((b,), spec.guidance, dtype=cd, device=dev)
        with dit_ctx(), ring_ctx():
            pred = dit_apply(
                modules["dit"], spec.dit_cfg, img=xt.to(cd), img_ids=cond["img_ids"],
                txt=cond["txt"].to(cd), txt_ids=cond["txt_ids"], timesteps=t.to(cd),
                y=cond["vec"].to(cd), guidance=guidance)
        # "valid" gates batch rows padded up to a full batch
        return masked_loss(spec, pred, flow.velocity_target(x1, x0), batch.get("valid"),
                           cond["txt"].shape[1])

    return loss_fn


def ring_ctx_factory(spec, mesh):
    """``_ring_ctx_factory:284-300`` (image and video specs): a () ->
    context opening the ring scope under ``sequence_parallel`` (a null one
    without), after checking the mesh."""
    sp = spec.sequence_parallel
    if sp <= 1:
        return contextlib.nullcontext
    if mesh is None:
        raise ValueError(
            f"sequence_parallel={sp} needs the mesh: "
            "pass mesh= to make_loss_fn/make_train_step (the trainer builds "
            "it with make_mesh(sequence_parallel=N))")
    if mesh.sp != sp:
        raise ValueError(f"mesh seq axis {mesh.sp} != spec.sequence_parallel={sp}")
    from ..parallel import ring
    return ring.ring_scope


def dit_apply_factory(spec, mesh):
    """``_dit_apply_factory:316-342``: the DiT forward, ``dit_forward`` or
    the GPipe pipeline under ``pipeline_parallel``, after checking the mesh
    and ``dit_quant``."""
    pp = spec.pipeline_parallel
    if pp <= 1:
        return dit_m.dit_forward
    if mesh is None:
        raise ValueError(
            f"pipeline_parallel={pp} needs the mesh: pass mesh= to "
            "make_loss_fn/make_train_step (the trainer builds it with "
            "make_mesh(pipeline_parallel=N))")
    if mesh.pp != pp:
        raise ValueError(f"mesh pipe axis {mesh.pp} != spec.pipeline_parallel={pp}")
    if spec.dit_quant != "none":
        raise ValueError(
            "pipeline_parallel does not compose with dit_quant (the "
            "SwitchBack int8 paths — incl. the optimizer-emitted weight "
            "cache, which is keyed on the unstacked per-block layout — are "
            "not validated under the stage shard_map); set dit_quant: none")
    from ..parallel import pp as pp_m
    return functools.partial(pp_m.pipeline_dit_forward,
                             n_micro=spec.pipeline_microbatches or pp)


def masked_loss(spec, pred, target, valid, l_txt: int):
    """``flow.mse_loss`` of the DiT's prediction; under
    ``sequence_parallel`` ``pred`` holds the rank's img tokens
    (``parallel.ring.Layout.img``), which the target is cut to, and the
    count takes every img token."""
    with tracing.span(tracing.LOSS):
        if spec.sequence_parallel > 1:
            from ..parallel import ring
            lay = ring.token_layout(l_txt, target.shape[1])
            return flow.mse_loss(pred, target[:, lay.img], mask=valid, tokens=target.shape[1])
        return flow.mse_loss(pred, target, mask=valid)


def dit_quant_ctx(dit_quant: str):
    """A () -> context opening ``int8_training_ctx`` for the DiT forward
    (``image.py:255-262``), or a null one for ``dit_quant: none``."""
    if dit_quant not in DIT_QUANT:
        raise ValueError(f"dit_quant must be one of {DIT_QUANT}, got {dit_quant!r}")
    if dit_quant == "none":
        return contextlib.nullcontext
    return lambda: int8_training_ctx(full=dit_quant == "int8_full",
                                     dw_int8=dit_quant == "int8_dw")


def make_train_step(spec: TaskSpec, optimizer, mesh=None):
    """(state, batch, generator, draws=None) -> (state, metrics), one
    optimizer step without accumulation; ``mesh``: ``parallel.mesh.
    make_mesh``'s, needed under sequence or pipeline parallelism."""
    return step_utils.make_train_step(make_loss_fn(spec, mesh), optimizer)


def create_task_state(generator: torch.Generator, spec: TaskSpec, optimizer,
                      device=None) -> TrainState:
    modules = init_modules(spec, generator, device=device)
    state = create_state(modules, trainable_predicate(spec, modules), optimizer)
    mark_whole_grads(state, spec.dit_quant)
    if spec.dit_quant_cache and spec.dit_quant != "none":
        # the forward reads the int8 copies instead of quantizing W each step
        state = with_quant_cache(state)
    return state
