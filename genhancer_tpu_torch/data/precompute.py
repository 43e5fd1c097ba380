"""Precomputed caches: the frozen VAE encoder (and, for stage 1, the frozen
tower) run once over a dataset, written as shards the loaders read back.

Port of ``genhancer_tpu/data/precompute.py``; the shard layout is the JAX
package's own, so either package reads the other's cache:

  * image, ``mode="features"`` (stage 1): ``{key}.feat.npz`` with
    ``moments`` [h, w, 2z] float32 (the VAE posterior before sampling) and
    ``cls`` [P] float32 (the tower's projected class token), beside the
    sample's ``{key}.txt``;
  * image, ``mode="latents"`` (the stage-2 cache, legal in every stage):
    ``moments`` and ``pixels`` [S, S, 3] float16 in [0, 1], the transformed
    crop the moments came from — the tower trains live on it;
  * with ``augment="train"`` and ``variants`` K > 1 each array is stacked
    [K, ...]: K i.i.d. draws of the training crop from the per-image
    generator ``np.random.default_rng((seed, crc32(key)))``, so the port's
    crops are JAX's crops; the loader picks one per visit;
  * video (stage 1): ``{video}/{frame}.feat.npz`` with ``moments``,
    ``patches`` [L_p, D] float16 (bfloat16 values) and ``cls``, one video per
    shard group (``ShardWriter``: a group never splits across shards).

The posterior is sampled per step from the cached moments on the device,
so the training distribution is the inline path's.  The frozen functions
(``make_frozen_fn``, ``make_frozen_latent_fn``) run the port's modules
under ``torch.no_grad`` on the modules' device; ``_batched`` pads the last
batch to the batch size.
"""

from __future__ import annotations

import io
import os
import tarfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..models import vae as vae_m
from ..tasks.conditioning import VAE_MEAN, VAE_STD, normalize, tower_features, tower_stats
from .transforms import eval_image_transform, train_image_transform, video_frame_transform
from .wds import ShardStream

FrozenFn = Callable[[np.ndarray], Dict[str, np.ndarray]]


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def load_feat(blob: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(blob)) as z:
        return {k: z[k] for k in z.files}


class ShardWriter:
    """Rotating tar writer: ``{prefix}-%06d.tar`` every ``samples_per_shard``
    logical samples.  ``add_group`` writes all members of one sample (an
    image's ``feat.npz`` and ``txt``, or a whole video's frames) into the
    same shard: shards split only between groups (a video split across
    shards would come back as two truncated videos)."""

    def __init__(self, out_dir: str, samples_per_shard: int = 1000, prefix: str = "pre"):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.per_shard = samples_per_shard
        self.prefix = prefix
        self.groups = 0
        self.shard_idx = 0
        self.tf: Optional[tarfile.TarFile] = None

    def _roll(self):
        if self.tf is not None:
            self.tf.close()
        path = os.path.join(self.out_dir, f"{self.prefix}-{self.shard_idx:06d}.tar")
        self.tf = tarfile.open(path, "w")
        self.shard_idx += 1

    def add_group(self, members):
        """members: iterable of (name, bytes) — one logical sample."""
        if self.tf is None or (self.groups and self.groups % self.per_shard == 0):
            self._roll()
        for name, data in members:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            self.tf.addfile(info, io.BytesIO(data))
        self.groups += 1

    def close(self):
        if self.tf is not None:
            self.tf.close()
            self.tf = None


def _device_of(module: torch.nn.Module) -> torch.device:
    return next(iter(module.state_dict().values())).device


def make_frozen_fn(tower_kind: str, tower, tower_cfg, vae, vae_cfg, *,
                   vae_dtype=torch.float32, compute_dtype=torch.bfloat16,
                   with_patches: bool) -> FrozenFn:
    """pixels [B, H, W, 3] in [0, 1] (numpy) -> the frozen features as numpy
    arrays: ``moments`` float32 and ``cls`` (the projected class token)
    float32, with ``patches`` (bfloat16 values) where ``with_patches`` (the
    video conditioning takes them)."""
    dev = _device_of(vae)
    mean, std = tower_stats(tower_kind)

    @torch.no_grad()
    def fn(px01: np.ndarray) -> Dict[str, np.ndarray]:
        px = torch.from_numpy(px01).to(dev)
        vae_in = normalize(px, VAE_MEAN, VAE_STD).to(vae_dtype)
        moments = vae_m.encoder_forward(vae.encoder, vae_cfg, vae_in).to(torch.float32)
        cls_tok, patches = tower_features(tower_kind, {"model": tower},
                                          normalize(px, mean, std).to(compute_dtype), tower_cfg)
        out = {"moments": moments, "cls": cls_tok.to(torch.float32)}
        if with_patches:
            out["patches"] = patches.to(torch.bfloat16).to(torch.float32)
        return {k: v.cpu().numpy() for k, v in out.items()}

    return fn


def make_frozen_latent_fn(vae, vae_cfg, *, vae_dtype=torch.float32) -> FrozenFn:
    """pixels [B, H, W, 3] in [0, 1] (numpy) -> ``{"moments"}`` float32: the
    stage-2 latent cache (no tower: stage 2 trains it live)."""
    dev = _device_of(vae)

    @torch.no_grad()
    def fn(px01: np.ndarray) -> Dict[str, np.ndarray]:
        vae_in = normalize(torch.from_numpy(px01).to(dev), VAE_MEAN, VAE_STD).to(vae_dtype)
        moments = vae_m.encoder_forward(vae.encoder, vae_cfg, vae_in).to(torch.float32)
        return {"moments": moments.cpu().numpy()}

    return fn


def _batched(fn: FrozenFn, arrs: np.ndarray, batch: int) -> Dict[str, np.ndarray]:
    """``fn`` over ``arrs`` in batches of ``batch`` (the last one padded with
    zeros, as JAX pads it for one jit shape); stacked host arrays of the
    true length."""
    n = arrs.shape[0]
    outs = []
    for s in range(0, n, batch):
        chunk = arrs[s:s + batch]
        pad = batch - chunk.shape[0]
        if pad:
            chunk = np.concatenate([chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
        out = fn(chunk)
        outs.append({k: v[:batch - pad] for k, v in out.items()})
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


def precompute_video_dir(video_dir, out_dir: str, frozen_fn: FrozenFn, img_size: int,
                         batch: int = 16, samples_per_shard: int = 2000,
                         num_workers: int = 4) -> int:
    """Cache every frame of every video (``make_frozen_fn`` with patches);
    returns the frames written.  Frames keep their ``video/frame`` keys, so
    the video loaders assemble examples from the cache as from pixels."""
    stream = ShardStream(video_dir, shuffle_buffer=0, repeat=False, group_videos=True)
    writer = ShardWriter(out_dir, samples_per_shard)
    written = 0
    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        for video in stream:
            frames = video["frames"]
            try:
                arr = np.stack(list(pool.map(
                    lambda f: video_frame_transform(f[1], img_size), frames)))
            except Exception:   # an undecodable frame skips the video, as JAX does
                continue
            feats = _batched(frozen_fn, arr, batch)
            # one video = one group: shards never split a video
            writer.add_group(
                (f"{fkey}.feat.npz",
                 _npz_bytes(moments=feats["moments"][i],
                            patches=feats["patches"][i].astype(np.float16),
                            cls=feats["cls"][i]))
                for i, (fkey, _) in enumerate(frames))
            written += len(frames)
    writer.close()
    return written


def precompute_image_dir(img_dir, out_dir: str, frozen_fn: FrozenFn, img_size: int,
                         batch: int = 32, samples_per_shard: int = 2000,
                         num_workers: int = 4, augment: str = "center",
                         variants: int = 1, seed: int = 0, mode: str = "features") -> int:
    """Cache CC3M-style image shards; returns the samples written.

    ``mode="latents"``: ``frozen_fn`` is ``make_frozen_latent_fn`` and each
    variant's crop is stored beside its moments as float16 ``pixels``.
    ``augment="center"``: one deterministic center crop per image;
    ``augment="train"``: ``variants`` i.i.d. draws of the training crop
    (RandomResizedCrop scale 0.9-1.0, bicubic) from the per-image generator
    ``default_rng((seed, crc32(key)))``, stacked [K, ...] where K > 1."""
    if augment not in ("center", "train"):
        raise ValueError(f"augment must be center|train, got {augment!r}")
    if augment == "center" and variants != 1:
        raise ValueError("variants > 1 requires augment='train'")
    if mode not in ("features", "latents"):
        raise ValueError(f"mode must be features|latents, got {mode!r}")
    k_var = variants if augment == "train" else 1

    stream = ShardStream(img_dir, shuffle_buffer=0, repeat=False)
    writer = ShardWriter(out_dir, samples_per_shard)
    written = 0
    keys, imgs, txts = [], [], []

    def flush():
        nonlocal written
        if not imgs:
            return
        # one flat batch of every image's k_var crops
        flat = np.stack([crop for per_img in imgs for crop in per_img])
        feats = _batched(frozen_fn, flat, batch)
        if mode == "latents":
            # the crops the moments came from: the tower trains on them
            feats["pixels"] = flat.astype(np.float16)
        for i, k in enumerate(keys):
            lo = i * k_var
            arrays = {name: (arr[lo] if k_var == 1 else arr[lo:lo + k_var])
                      for name, arr in feats.items()}
            writer.add_group([(f"{k}.feat.npz", _npz_bytes(**arrays)),
                              (f"{k}.txt", txts[i])])
            written += 1
        keys.clear(), imgs.clear(), txts.clear()

    def decode(sample):
        jpg = sample.get("jpg") or sample.get("jpeg") or sample.get("png")
        if jpg is None:
            return None
        try:
            if augment == "train":
                rng = np.random.default_rng((seed, zlib.crc32(sample["__key__"].encode())))
                return [train_image_transform(jpg, img_size, rng) for _ in range(k_var)]
            return [eval_image_transform(jpg, img_size)]
        except Exception:   # an undecodable sample is skipped, as JAX does
            return None

    def take(pending, flush_full: bool):
        for s, fut in pending:
            img = fut.result()
            if img is None:
                continue
            imgs.append(img)
            keys.append(s["__key__"])
            txts.append(s.get("txt", b""))
            if flush_full and len(imgs) >= batch:
                flush()

    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        pending = []
        for sample in stream:
            pending.append((sample, pool.submit(decode, sample)))
            if len(pending) >= batch * 2:
                take(pending, True)
                pending = []
        take(pending, False)     # the tail in one flush, as JAX batches it
    flush()
    writer.close()
    return written
