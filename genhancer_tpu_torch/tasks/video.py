"""Video-mode tasks: middle-frame, next-frame, 2-frame and sliding-window
prediction, stage 1 and stage 2 (``stage2_all``).

Port of ``genhancer_tpu/tasks/video.py``.  One parameterized
implementation covers the four reference trainer families:

  * middle  — cond (start t=0, end t=2) -> target middle t=1;
  * next    — cond (current t=0) -> target next t=1;
  * next2   — cond (t=0, t=1) -> target t=2;
  * sliding — cond (t=0, 1, 2) -> target t=3 over per-video windows, which
    arrive pre-windowed from the host loader with a ``valid`` mask.

The conditioning is the tower's *patch tokens* through the trained
VisualPromptAdapter (``tasks.conditioning.video_conditioning``).  Modules:
``{dit, vae, clip{model, project_clip}, visual_adapter}``; ``project_clip``
is kept for the checkpoint layout, but the video forward never reaches it,
so it takes no gradient and no weight decay (``video.py:160-171``).

Stage 1 runs the vision-only tower frozen, under ``torch.no_grad()``.
Stage 2 (``stage2_all``, ``video.py:114-141,160-171,215-221``) builds the
whole ``CLIPModel``, wraps it with LoRA (``train.lora``, the spec's
``lora_*``), trains the DiT, the visual adapter and the LoRA paths, and runs
the tower under autograd inside ``core.nn.lora_dropout_ctx`` (K2 saves
each row's lse, K2b runs the tower's attention backward) and, with
``tower_remat``, inside ``tower_remat_scope``: each encoder layer
checkpointed, its dropout masks replayed in the recompute.

Random draws come from one ``torch.Generator``; a test hands the loss the
JAX package's own draws instead (``draws``: ``t`` [B], ``x0`` [B, L, C],
``vae_noise`` [B, h, w, z], and in stage 2 ``lora_masks``, one bool
keep-mask per LoRA-wrapped call in call order).

The video features cache (``data.precompute``, stage 1) hands the loss
``{moments, cond_patches, cond_vecs}``: the posterior is sampled from the
cached moments and the tower is skipped (``video.py:188-200``).  The int8
knobs are the image task's (``tasks.image.quantize_modules``, ``video.py:
141-156``): ``tower_quant: int8`` swaps the stage-1 tower's linears for
int8 ones and gives the stage-2 tower QLoRA's base, ``vae_quant`` the
encoder's wide convs, and ``dit_quant`` runs the DiT through SwitchBack, its
int8 copies kept in the state where the fused optimizer emits them
(``dit_quant_cache``, K4).

The SigLIP so400m tower (``tower: siglip``; no published video config uses
it) gives every post-LN token of each frame to the adapter and its
MAP-pooled vector, averaged over the frames, to the DiT's ``vector_in``
(``video.py:118, 210-228``), so its width must be the DiT's ``vec_in_dim``:
JAX's loss fails on a mismatch inside its first product, the port's
``require_ported`` raises ``ValueError`` naming the two widths (so400m's
1152 against flux-dev's 768).  Sequence and pipeline parallelism run as in the image task (``tasks.image.
ring_ctx_factory``, ``dit_apply_factory``, ``masked_loss``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn as tnn

from ..core import quant
from ..core.nn import init_weights, lora_dropout_ctx
from ..models import dit as dit_m
from ..models import vae as vae_m
from .. import registry
from ..models.towers.encoder import tower_remat_scope
from ..models.towers.projectors import Projector, VisualPromptAdapter
from ..parallel.mesh import data_size, local_rows, randn_rows
from ..train import flow, lora
from ..train import step_utils
from ..train.state import TrainState, create_state, mark_whole_grads, with_quant_cache
from .conditioning import (VAE_MEAN, VAE_STD, normalize, tower_features, tower_stats,
                           video_conditioning)
from .image import (dit_apply_factory, dit_quant_ctx, load_pretrained, masked_loss,
                    quantize_modules, ring_ctx_factory)

VIDEO_MODES: Dict[str, Dict] = {
    "middle": {"n_cond": 2, "frame_times": (0.0, 2.0), "target_time": 1.0},
    "next": {"n_cond": 1, "frame_times": (0.0,), "target_time": 1.0},
    "next2": {"n_cond": 2, "frame_times": (0.0, 1.0), "target_time": 2.0},
    "sliding": {"n_cond": 3, "frame_times": (0.0, 1.0, 2.0), "target_time": 3.0},
}


@dataclass(frozen=True)
class VideoTaskSpec:
    """Static description of one video task."""
    mode: str                        # key into VIDEO_MODES
    stage: str                       # "stage1" | "stage2_all"
    tower_kind: str                  # "clip" | "siglip"
    img_size: int                    # VAE input resolution
    clip_image_size: int
    dit_cfg: dit_m.DiTConfig
    vae_cfg: vae_m.VAEConfig
    tower_cfg: object                # CLIPConfig | SiglipConfig
    clip_dim: int = 768
    t5_dim: int = 4096
    adapter_in_dim: int = 1024       # the tower's patch-token width
    scale_factor: float = 1.0
    guidance: float = 4.0
    lora_r: int = 16
    lora_alpha: float = 16.0
    lora_targets: object = "all-linear"
    lora_dropout: float = 0.0          # the published stage-2 configs: 0.1
    remat: bool = False
    remat_policy: str = "full"
    tower_remat: bool = False          # checkpoint each tower layer (stage 2)
    compute_dtype: torch.dtype = torch.bfloat16
    dit_param_dtype: torch.dtype = torch.bfloat16
    vae_dtype: torch.dtype = torch.float32   # conv dtype of the frozen encode
    tower_quant: str = "none"
    vae_quant: str = "none"
    vae_quant_min_ch: int = quant.INT8_CONV_MIN_CH
    dit_quant: str = "none"
    dit_quant_cache: bool = False      # the optimizer-maintained int8 weight cache
    # a local HF model directory holding the tower's weights
    # (clip_config.model_dir), or None for random init
    tower_dir: Optional[str] = None
    # the FLUX ae.safetensors the VAE loads (ae_path / $AE), or None
    vae_path: Optional[str] = None
    sequence_parallel: int = 1         # ring attention (image.TaskSpec)
    pipeline_parallel: int = 1         # the GPipe DiT (parallel.pp)
    pipeline_microbatches: int = 0     # 0 = one per stage

    @property
    def n_cond(self) -> int:
        return VIDEO_MODES[self.mode]["n_cond"]

    @property
    def frame_times(self) -> Tuple[float, ...]:
        return VIDEO_MODES[self.mode]["frame_times"]

    @property
    def target_time(self) -> float:
        return VIDEO_MODES[self.mode]["target_time"]

    @property
    def latent_hw(self) -> Tuple[int, int]:
        f = 2 ** (len(self.vae_cfg.ch_mult) - 1)   # f8 for the FLUX VAE
        return (self.img_size // f, self.img_size // f)

    @property
    def patch_grid(self) -> int:
        return self.clip_image_size // self.tower_cfg.vision.patch_size


STAGES = ("stage1", "stage2_all")


def is_stage2(spec) -> bool:
    return spec.stage == "stage2_all"


def build_modules(spec: VideoTaskSpec, device=None) -> tnn.ModuleDict:
    """Uninitialised modules in the reference layout, on ``device``: the
    vision-only tower in stage 1, the whole ``CLIPModel`` or ``SiglipModel``
    in stage 2."""
    tower_cls = registry.tower_class(spec.tower_kind, is_stage2(spec))
    return tnn.ModuleDict({
        "dit": dit_m.DiT(spec.dit_cfg, device=device, dtype=spec.dit_param_dtype),
        "vae": vae_m.AutoEncoder(spec.vae_cfg, device=device),
        "clip": tnn.ModuleDict({
            "model": tower_cls(spec.tower_cfg, device=device),
            "project_clip": Projector(spec.clip_dim, spec.clip_dim, device=device),
        }),
        "visual_adapter": VisualPromptAdapter(spec.adapter_in_dim, spec.t5_dim,
                                              device=device),
    })


def init_modules(spec: VideoTaskSpec, generator: torch.Generator,
                 device=None) -> tnn.ModuleDict:
    """Random-init modules drawn from ``generator`` (on ``device``), the
    tower's weights from ``spec.tower_dir`` and the VAE's from
    ``spec.vae_path`` where they are set, in stage 2
    LoRA injected (its A's drawn from ``generator`` after everything else),
    then the spec's frozen int8 surgery (``image.quantize_modules``)."""
    require_ported(spec)
    modules = init_weights(build_modules(spec, device), generator)
    load_pretrained(spec, modules, device)
    if is_stage2(spec):
        lora.inject(modules["clip"]["model"], generator, r=spec.lora_r,
                    alpha=spec.lora_alpha, targets=spec.lora_targets)
    return quantize_modules(spec, modules)


def require_ported(spec: VideoTaskSpec) -> None:
    """Raise for the options of a video spec that the port does not run."""
    if spec.stage not in STAGES:
        raise ValueError(f"video stage must be one of {STAGES}, got {spec.stage!r}")
    if spec.tower_kind == "siglip" and spec.tower_cfg.vision.hidden_size != spec.dit_cfg.vec_in_dim:
        raise ValueError(
            f"the SigLIP tower in video mode feeds its {spec.tower_cfg.vision.hidden_size}-d "
            f"pooled vector to the DiT's vector_in, which takes vec_in_dim="
            f"{spec.dit_cfg.vec_in_dim}: give the DiT vec_in_dim="
            f"{spec.tower_cfg.vision.hidden_size} (the JAX loss fails on the same product)")


def trainable_predicate(spec: VideoTaskSpec, modules=None) -> Callable[[str], bool]:
    """Stage 1 trains the DiT and the visual adapter; stage 2 adds the
    tower's LoRA factors and the biases of the wrapped modules (``bias:
    lora_only``), read from ``modules``."""
    require_ported(spec)
    lora_paths = set()
    if is_stage2(spec):
        lora_paths = {"clip.model." + p
                      for p in lora.lora_trainable_paths(modules["clip"]["model"])}

    def pred(path: str) -> bool:
        return (path.startswith("dit.") or path.startswith("visual_adapter.")
                or path in lora_paths)

    return pred


def make_loss_fn(spec: VideoTaskSpec, mesh=None):
    """loss_fn(modules, batch, generator, draws=None) -> float32 scalar.

    ``batch`` (on the modules' device, + ``valid`` [B], the sliding loader's
    padded rows): ``cond`` [B, n_cond, H, W, 3] and ``target`` [B, H, W, 3],
    float32 in [0, 1]; or the features cache's ``moments`` [B, h, w, 2z]
    float32, ``cond_patches`` [B, n_cond, L_p, D] float16 and ``cond_vecs``
    [B, n_cond, P] float32."""
    require_ported(spec)
    ring_ctx = ring_ctx_factory(spec, mesh)
    dit_apply = dit_apply_factory(spec, mesh)
    f32, cd = torch.float32, spec.compute_dtype
    dit_ctx = dit_quant_ctx(spec.dit_quant)

    def loss_fn(modules, batch, generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        draws = draws or {}
        if "moments" in batch:
            # the frozen VAE and tower ran offline: the posterior is sampled
            # from the cached moments with the inline path's draw
            moments = batch["moments"].to(f32)
            z = vae_m.diagonal_gaussian(moments, generator=generator,
                                        noise=draws.get("vae_noise"))
            x1_lat = spec.vae_cfg.scale_factor * (z - spec.vae_cfg.shift_factor)
            patches, vecs = batch["cond_patches"].to(cd), batch["cond_vecs"].to(cd)
            b, n_cond, dev = patches.shape[0], patches.shape[1], patches.device
        else:
            cond, target = batch["cond"], batch["target"]
            b, n_cond, dev = cond.shape[0], cond.shape[1], cond.device
            with torch.no_grad():
                # frozen VAE encode of the target frame
                vae_in = normalize(target, VAE_MEAN, VAE_STD).to(f32)
                x1_lat = vae_m.vae_encode(modules["vae"], spec.vae_cfg, vae_in, generator,
                                          dtype=spec.vae_dtype, noise=draws.get("vae_noise"))
            # one tower pass over all b * n_cond conditioning frames: frozen
            # in stage 1; in stage 2 under autograd, its LoRA branches'
            # inputs dropped (peft parity)
            mean, std = tower_stats(spec.tower_kind)
            px = normalize(cond.reshape((b * n_cond,) + tuple(cond.shape[2:])), mean,
                           std).to(cd)
            if is_stage2(spec):
                with lora_dropout_ctx(generator, spec.lora_dropout, draws.get("lora_masks")), \
                        tower_remat_scope(spec.tower_remat):
                    vecs_flat, patches_flat = tower_features(spec.tower_kind, modules["clip"],
                                                             px, spec.tower_cfg)
            else:
                with torch.no_grad():
                    vecs_flat, patches_flat = tower_features(spec.tower_kind, modules["clip"],
                                                             px, spec.tower_cfg)
            patches = patches_flat.reshape(b, n_cond, *patches_flat.shape[1:])
            vecs = vecs_flat.reshape(b, n_cond, -1)
        x1 = dit_m.pack_latent(x1_lat).to(f32)
        dit_in = video_conditioning(
            modules, [patches[:, i] for i in range(n_cond)],
            [vecs[:, i] for i in range(n_cond)], spec.latent_hw, spec.patch_grid,
            spec.target_time, spec.frame_times, compute_dtype=cd)
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
                modules["dit"], spec.dit_cfg, img=xt.to(cd), img_ids=dit_in["img_ids"],
                txt=dit_in["txt"].to(cd), txt_ids=dit_in["txt_ids"], timesteps=t.to(cd),
                y=dit_in["vec"], guidance=guidance, remat=spec.remat,
                remat_policy=spec.remat_policy)
        # "valid" masks the sliding loader's padded rows
        return masked_loss(spec, pred, flow.velocity_target(x1, x0), batch.get("valid"),
                           dit_in["txt"].shape[1])

    return loss_fn


def make_train_step(spec: VideoTaskSpec, optimizer, mesh=None):
    """(state, batch, generator, draws=None) -> (state, metrics), one
    optimizer step without accumulation."""
    return step_utils.make_train_step(make_loss_fn(spec, mesh), optimizer)


def create_task_state(generator: torch.Generator, spec: VideoTaskSpec, optimizer,
                      device=None) -> TrainState:
    modules = init_modules(spec, generator, device=device)
    state = create_state(modules, trainable_predicate(spec, modules), optimizer)
    mark_whole_grads(state, spec.dit_quant)
    if spec.dit_quant_cache and spec.dit_quant != "none":
        # the forward reads the int8 copies instead of quantizing W each step
        state = with_quant_cache(state)
    return state
