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

Several cards (``num_devices`` > 1 or ``model_parallel`` > 1, JAX
``engine.py:57-141``): the engine is one process per card, in the process
group that torchrun's environment describes (``parallel.mesh``), on the
(data, model) mesh of the trainer (``--model_parallel`` alone implies
``num_devices = model_parallel``; any other world size raises).  Rank 0
serves: for each batch it broadcasts the operation, the bucket, the seed
and the wire batch (``_run``), and the other ranks answer in ``follow``
until ``stop``.  Buckets round up to multiples of the data axis's size;
each data rank runs its rows of the bucket, the whole bucket's NHWC noise
drawn from one generator (``mesh.randn_rows``), so the result is one
process's for the same seed; rank 0 gathers the rows.  The DiT is placed
with the trainer's TP layout (``parallel.layout.place``) and its
forward's collectives are the trainer's; the tower and the VAE are
replicated.  Under ``quant="int8"`` every weight is quantized whole and
then sharded like the weight it replaces (a row-parallel weight keeps its
whole rows' scales), and the int32 products are summed over the model axis
before the dequantization (``core.quant``), so the codes are one
process's.  A failure on any rank fails the requests: a rank that dies
leaves rank 0's next collective to the group's timeout, which raises, and
the engine then refuses every later request.
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
from ..parallel import mesh as mesh_m
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
        self.mesh, self.layout, self._failed, self._stopped = None, {}, None, False
        tp = int(model_parallel)
        # --model_parallel alone implies that many devices (dp 1 x tp N)
        n = max(int(num_devices), tp)
        dp = 1
        if n > 1:
            from ..parallel import tp as tp_m
            if not mesh_m.is_distributed() or mesh_m.world_size() != n:
                raise ValueError(
                    f"num_devices={n} (model_parallel={tp}) serves as {n} processes, one "
                    f"card each, in one process group; this process's group has "
                    f"{mesh_m.world_size()}: launch them with torchrun (python -m "
                    f"torch.distributed.run --nproc_per_node {n} -m "
                    f"genhancer_tpu_torch.cli.serve ... --num_devices {n} "
                    f"--model_parallel {tp})")
            tp_m.validate_tp(spec.dit_cfg, tp)
            self.mesh = mesh_m.make_mesh(tp)
            self.device = mesh_m.rank_device(self.device)
            dp = mesh_m.data_size()
        # every data rank holds equal rows: buckets round up to multiples of dp
        self.buckets = tuple(sorted(set(-(-int(b) // dp) * dp for b in buckets)))
        if not self.buckets:
            raise ValueError("at least one batch bucket required")
        self.max_batch = self.buckets[-1]

        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.modules = modules.to(self.device).eval().requires_grad_(False)
        # the module paths swapped for int8 ones, by tree ({} without int8):
        # whole weights first, then sharded like the weights they replace
        self.int8_layers = quantize_int8(self.modules) if quant == "int8" else {}
        if tp > 1:
            from ..parallel.layout import place
            self.layout = place(self.modules, tp, hidden=spec.dit_cfg.hidden_size)
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

    # ------------------------------------------------------------ the mesh

    _OPS = ("stop", "reconstruct", "embed")

    def _compute(self, op: str, batch: torch.Tensor, seed: Optional[int]) -> torch.Tensor:
        """One bucket on this rank: its data index's rows of ``batch`` (the
        whole bucket, on the device), the noise of the whole bucket drawn
        from ``seed`` (a one-process engine: its own generator for None),
        the rows of every data rank gathered back (every rank)."""
        b = batch.shape[0]
        if self.mesh is None:
            if op == "embed":
                return self._embed(batch)
            return self._recon(batch, self._noise(b, seed))
        rows = mesh_m.local_rows(batch)
        if op == "embed":
            out = self._embed(rows)
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
            noise = mesh_m.randn_rows((rows.shape[0], self._lat_h, self._lat_w,
                                       self.spec.vae_cfg.z_channels), gen, device=self.device)
            out = self._recon(rows, noise)
        return mesh_m.all_gather_dim(out, 0, mesh_m.DATA_AXIS)

    def _wire_torch_dtype(self) -> torch.dtype:
        return torch.uint8 if self.wire_dtype == "uint8" else torch.float32

    def _broadcast(self, op: str, batch: Optional[torch.Tensor], seed: int):
        """Rank 0: the operation, the bucket, the seed and the wire batch to
        every rank (a collective)."""
        head = torch.tensor([self._OPS.index(op), 0 if batch is None else batch.shape[0],
                             seed], dtype=torch.int64, device=self.device)
        mesh_m.broadcast_from(head, 0, "world")
        if batch is not None:
            mesh_m.broadcast_from(batch.contiguous(), 0, "world")

    def _run(self, op: str, wire: np.ndarray, seed: Optional[int]) -> np.ndarray:
        """One bucket through the engine (the lock held): on a mesh rank 0
        sends it to every rank first; a failure marks the engine failed."""
        if self._failed is not None:
            raise RuntimeError(f"the serving group failed earlier ({self._failed}); "
                               "restart every rank")
        batch = self._place(wire)
        try:
            if self.mesh is not None:
                if seed is None:     # rank 0's draw, the same on every rank
                    seed = int(torch.randint(0, 2 ** 62, (1,), generator=self._gen,
                                             device=self.device))
                self._broadcast(op, batch, int(seed))
                self._stopped = False
            return self._compute(op, batch, seed).cpu().numpy()
        except Exception as e:
            if self.mesh is not None:
                self._failed = repr(e)[:200]
            raise

    @torch.inference_mode()
    def follow(self) -> None:
        """A rank other than 0: answer rank 0's broadcasts until ``stop``."""
        if self.mesh is None or mesh_m.rank() == 0:
            raise RuntimeError("follow() runs on the ranks other than 0 of a mesh engine")
        s = self.spec.img_size
        while True:
            head = torch.empty(3, dtype=torch.int64, device=self.device)
            mesh_m.broadcast_from(head, 0, "world")
            op, b, seed = (int(v) for v in head.tolist())
            if self._OPS[op] == "stop":
                return
            batch = torch.empty((b, s, s, 3), dtype=self._wire_torch_dtype(), device=self.device)
            mesh_m.broadcast_from(batch, 0, "world")
            self._compute(self._OPS[op], batch, seed)

    def stop(self) -> None:
        """Rank 0 of a mesh engine: release the followers from ``follow``
        (a collective; again only after another request).  Nothing to do
        on one process."""
        if self.mesh is None or mesh_m.rank() != 0:
            return
        with self._lock:
            if self._failed is None and not self._stopped:
                self._broadcast("stop", None, 0)
            self._stopped = True

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
        wire = _pad_to(self._wire(images01), self.bucket_for(n))
        with self._lock:
            out = self._run("reconstruct", wire, seed)
        return out[:n]

    def embed(self, images01: np.ndarray) -> np.ndarray:
        """images01: [n, H, W, 3] -> [n, D] tower class tokens (float32):
        ``visual_projection(pooler)`` for CLIP, MAP-pooled for SigLIP."""
        n = images01.shape[0]
        wire = _pad_to(self._wire(images01), self.bucket_for(n))
        with self._lock:
            out = self._run("embed", wire, None)
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
        projector ``.bin`` files are loaded over them.  On a mesh every
        rank loads them, on its own card, before the engine places them."""
        from ..tasks import factory
        from ..tasks.image import init_modules
        from ..train.checkpoint import load_stage1_components
        from ..train.config import load_config

        device = resolve_device(device)
        if mesh_m.is_distributed():
            device = mesh_m.rank_device(device)
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
