"""Inference engine: reconstruction + embedding over batch buckets.

Port of ``genhancer_tpu/serve/engine.py``.  One reconstruct request runs the
frozen tower (CLIP: 24 layers through the fused K2 attention kernel on
CUDA; SigLIP-384: 27 layers at 729 tokens through the flash kernel K5, then
the MAP head), the two projectors, ``num_steps`` Euler steps of the DiT (every
block's attention through the fused K1 RoPE-attention kernel), the float32
VAE decode, then the clamp and — at the uint8 wire — the rounding to uint8
on the device.  An embed request runs the tower and ``visual_projection``
(CLIP) or returns the MAP-pooled output (SigLIP, 1152-d).

PyTorch runs eagerly, so there is no per-bucket compile; requests are still
padded to the smallest bucket that holds them, which keeps the device's
batch shapes to the configured set and the seeded noise a function of the
bucket only.  Device calls run under ``torch.inference_mode()`` and one lock.

``quant="int8"`` swaps the served tree for int8 layers at load
(``quantize_int8``): each int8 linear quantizes its input per row through
K7 and multiplies on ``torch._int_mm``; each int8 VAE conv quantizes its
input per tensor, with one amax over the whole bucket, so a request's
pixels depend on its bucket mates (in both packages; padding repeats the
last row, which leaves the amax as it was).

Float32 matmuls and convolutions run in full float32: the engine turns
TF32 off for both (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``), so the float32 VAE is not silently
TF32.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import quant as quant_m
from ..models import dit as dit_m
from ..models import vae as vae_m
from ..tasks.conditioning import image_conditioning, normalize, tower_features, tower_stats
from ..train import flow

logger = logging.getLogger(__name__)


def _pad_to(arr: np.ndarray, b: int) -> np.ndarray:
    """Pad the batch dim to ``b`` by repeating the last row."""
    n = arr.shape[0]
    if n == b:
        return arr
    pad = np.repeat(arr[-1:], b - n, axis=0)
    return np.concatenate([arr, pad], axis=0)


def quantize_int8(modules) -> Dict[str, Tuple[str, ...]]:
    """``quant="int8"`` (``engine.py:93-103``), in place: every linear of the
    DiT and of the tower (``clip.model``) whose smaller dimension reaches 64
    becomes an int8 layer, and every conv of the whole VAE, encoder and
    decoder (the mid-block attention's 1x1 q/k/v/proj_out too), whose in-
    and out-channels reach 256.  Inference has no dW to protect, so every
    eligible layer of the served tree is int8.  Returns the swapped module
    paths of each tree."""
    return {"dit": quant_m.quantize_linear_tree(modules["dit"]),
            "tower": quant_m.quantize_linear_tree(modules["clip"]["model"]),
            "vae": quant_m.quantize_conv_tree(modules["vae"])}


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist — the engine
    never falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is available")
    return device


class InferenceEngine:
    """Holds the device-resident modules and runs the serving paths.

    ``modules``: the ``init_modules`` layout ``{dit, vae, clip{model,
    project_clip, project_t5}}`` (an ``nn.ModuleDict``).  Thread-safe: device
    calls are serialised by one lock.

    ``wire_dtype="uint8"``: pixels cross host<->device as uint8 both ways;
    ``/255`` and ``round(clip(x) * 255)`` (half to even) run on the device,
    and ``reconstruct`` returns uint8.  ``embed`` always returns float32.
    """

    def __init__(self, spec, modules, *, device, num_steps: int = 20,
                 guidance: float = 4.0, shift_schedule: bool = True,
                 buckets: Sequence[int] = (1, 4, 8), quant: str = "none",
                 num_devices: int = 1, model_parallel: int = 1,
                 wire_dtype: str = "float32"):
        self.spec = spec
        self.device = resolve_device(device)
        self.num_steps = int(num_steps)
        self.guidance = float(guidance)
        if wire_dtype not in ("float32", "uint8"):
            raise ValueError(f"wire_dtype must be float32|uint8, got {wire_dtype!r}")
        self.wire_dtype = wire_dtype
        if quant not in ("none", "int8"):
            raise ValueError(f"quant must be none|int8, got {quant!r}")
        self.quant = quant
        if int(num_devices) > 1 or int(model_parallel) > 1:
            raise NotImplementedError(
                "multi-device serving (num_devices / model_parallel > 1) is not "
                "ported yet (ROADMAP: multi-device serving)")
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets:
            raise ValueError("at least one batch bucket required")
        self.max_batch = self.buckets[-1]

        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.modules = modules.to(self.device).eval().requires_grad_(False)
        # the module paths swapped for int8 ones, by tree ({} without int8)
        self.int8_layers = quantize_int8(self.modules) if quant == "int8" else {}
        self._lock = threading.Lock()
        # unseeded noise must differ across restarts and replicas
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int.from_bytes(os.urandom(8), "little") >> 1)

        self._lat_h, self._lat_w = spec.latent_hw
        seq_len = (self._lat_h // 2) * (self._lat_w // 2)
        self._timesteps = flow.get_schedule(self.num_steps, seq_len,
                                            shift=shift_schedule)

    # ------------------------------------------------------------ device

    def _dewire(self, image: torch.Tensor) -> torch.Tensor:
        """Wire batch -> float [0, 1] (uint8 / 255 in f32 is exact)."""
        if image.dtype == torch.uint8:
            return image.to(torch.float32) / 255.0
        return image

    def _noise(self, b: int, seed: Optional[int]) -> torch.Tensor:
        """NHWC latent noise [b, lat_h, lat_w, z] in float32."""
        gen = self._gen
        if seed is not None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
        shape = (b, self._lat_h, self._lat_w, self.spec.vae_cfg.z_channels)
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=self.device)

    @torch.inference_mode()
    def _recon(self, image: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Wire batch + NHWC noise -> reconstructed NHWC batch (wire dtype)."""
        spec, m = self.spec, self.modules
        image01 = self._dewire(image)
        cond = image_conditioning(spec.tower_kind, m["clip"], image01,
                                  spec.tower_cfg, spec.latent_hw,
                                  compute_dtype=spec.compute_dtype)
        img = dit_m.pack_latent(noise).to(spec.compute_dtype)

        def model_fn(x, t_vec, g_vec):
            return dit_m.dit_forward(
                m["dit"], spec.dit_cfg, img=x, img_ids=cond["img_ids"],
                txt=cond["txt"].to(x.dtype), txt_ids=cond["txt_ids"],
                timesteps=t_vec, y=cond["vec"].to(x.dtype), guidance=g_vec)

        tokens = flow.denoise_euler(model_fn, img, self._timesteps, self.guidance)
        lat = dit_m.unpack_latent(tokens.to(torch.float32), self._lat_h, self._lat_w)
        out = vae_m.vae_decode(m["vae"], spec.vae_cfg, lat)
        out = torch.clamp(out * 0.5 + 0.5, 0.0, 1.0)
        if self.wire_dtype == "uint8":
            out = torch.round(out * 255.0).to(torch.uint8)
        return out

    @torch.inference_mode()
    def _embed(self, image: torch.Tensor) -> torch.Tensor:
        spec = self.spec
        image01 = self._dewire(image)
        mean, std = tower_stats(spec.tower_kind)
        px = normalize(image01, mean, std).to(spec.compute_dtype)
        cls_tok, _ = tower_features(spec.tower_kind, self.modules["clip"], px,
                                    spec.tower_cfg)
        return cls_tok.to(torch.float32)

    # --------------------------------------------------------------- api

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"batch {n} exceeds max bucket {self.max_batch}")

    def _wire(self, arr: np.ndarray) -> np.ndarray:
        """Host batch -> the engine's wire dtype (float [0,1] or uint8 in)."""
        arr = np.asarray(arr)
        if self.wire_dtype == "uint8":
            if arr.dtype == np.uint8:
                return arr
            return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        if arr.dtype == np.uint8:
            return arr.astype(np.float32) / 255.0
        return np.asarray(arr, np.float32)

    def _place(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr).to(self.device)

    def reconstruct(self, images01: np.ndarray,
                    seed: Optional[int] = None) -> np.ndarray:
        """images01: [n, H, W, 3] float32 in [0,1] or uint8, n <= max bucket.
        Returns [n, H, W, 3]: float32 [0,1] at the float32 wire, uint8 at the
        uint8 wire."""
        n = images01.shape[0]
        b = self.bucket_for(n)
        batch = self._place(_pad_to(self._wire(images01), b))
        with self._lock:
            out = self._recon(batch, self._noise(b, seed)).cpu().numpy()
        return out[:n]

    def embed(self, images01: np.ndarray) -> np.ndarray:
        """images01: [n, H, W, 3] -> [n, D] tower class tokens (float32):
        ``visual_projection(pooler)`` for CLIP, MAP-pooled for SigLIP."""
        n = images01.shape[0]
        b = self.bucket_for(n)
        batch = self._place(_pad_to(self._wire(images01), b))
        with self._lock:
            out = self._embed(batch).cpu().numpy()
        return out[:n]

    def warmup(self, endpoints: Sequence[str] = ("reconstruct", "embed")):
        """Run every (endpoint, bucket) once before serving: the kernels are
        built and the allocator's pools sized before the first request."""
        s = self.spec.img_size
        for b in self.buckets:
            dummy = np.zeros((b, s, s, 3), np.float32)
            if "reconstruct" in endpoints:
                logger.info("warmup reconstruct bucket=%d", b)
                self.reconstruct(dummy, seed=0)
            if "embed" in endpoints:
                logger.info("warmup embed bucket=%d", b)
                self.embed(dummy)

    # ------------------------------------------------------------ loading

    @classmethod
    def from_config(cls, cfg, *, device, load_dir: Optional[str] = None,
                    load_step: Optional[int] = None, **kw) -> "InferenceEngine":
        """Build from a stage-1 training config (dict or path).  Modules are
        random-init from a generator seeded with the config's ``seed``, the
        tower from ``clip_config.model_dir`` where that names an HF
        directory; with ``load_dir``/``load_step`` the stage-1 DiT and
        projector ``.bin`` files are loaded over them."""
        from ..tasks import factory
        from ..tasks.image import init_modules
        from ..train.checkpoint import load_stage1_components
        from ..train.config import load_config

        device = resolve_device(device)
        if isinstance(cfg, str):
            cfg = load_config(cfg)
        cfg.setdefault("task", "image_stage1")
        spec, _, ckpt_kind = factory.build_spec(cfg)
        if ckpt_kind != "image":
            raise NotImplementedError(
                f"the engine serves image stage-1 configs; {cfg['task']!r} is a video "
                "task (its stage-1 artifacts condition on frames, not one image)")
        gen = torch.Generator(device=device)
        gen.manual_seed(int(cfg.get("seed", 0)))
        modules = init_modules(spec, gen, device=device)
        if load_dir is not None:
            if load_step is None:
                raise ValueError("load_step required with load_dir")
            load_stage1_components(modules, load_dir, int(load_step))
        return cls(spec, modules, device=device, **kw)
