"""The port's precomputed caches (``data/precompute.py``,
``cli/precompute.py``, the loaders' ``precomputed`` paths) against the JAX
package's, the counterpart of ``tests/test_precompute.py``.

Both packages cache the same synthetic shards with the same weights (a JAX
init carried into the port by ``weights/convert.py``): the shard files hold
the same keys in the same groups, the float16 crops and the variant crops
are equal bit for bit (the per-image generator ``(seed, crc32(key))`` is
shared), and the moments, class tokens and patches agree within 1e-5 of
each array's largest entry (float32 convolutions and matmuls summed in
another order).  The latent-cache loss is held to the inline loss with the
tolerance of JAX's ``TestLatentCache::test_stage2_loss_matches_inline``
(2e-3 relative: the crop's float16 round trip).
"""

import dataclasses
import os
import tarfile
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genhancer_tpu.data import precompute as jpre
from genhancer_tpu.data import video as jvideo
from genhancer_tpu.tasks import image as jimage
from genhancer_tpu.tasks.factory import build_spec as jax_build_spec
from genhancer_tpu.train.config import load_config as jax_load_config
from genhancer_tpu_torch.cli import precompute as precompute_cli
from genhancer_tpu_torch.data import cc3m, precompute as pre, testing, video
from genhancer_tpu_torch.data.transforms import eval_image_transform, train_image_transform
from genhancer_tpu_torch.data.wds import ShardStream
from genhancer_tpu_torch.tasks import factory
from genhancer_tpu_torch.tasks import image as timage
from genhancer_tpu_torch.train.config import load_config
from genhancer_tpu_torch.train.trainer import Trainer
from genhancer_tpu_torch.weights.convert import load_jax_params

from test_torch_parity import jax_spec, port_spec, t
from test_torch_stage2 import _jax_draws
from test_torch_train_e2e import tiny_models, write_cfg  # noqa: F401 (fixture)

torch.set_num_threads(1)

IMG = 32
REL = 1e-5
CONFIGS = {"stage2_all": "configs/tpu_fast_stage2_all.yaml",
           "stage2_only": "configs/tpu_fast_stage2_only.yaml",
           "video_stage2_all": "configs/tpu_fast_video_stage2_all.yaml"}


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def weights():
    """One float32 JAX stage-1 init of the tiny image spec and its port
    modules; the video spec's adapter takes the tower's width."""
    js = dataclasses.replace(jax_spec(compute_dtype=jnp.float32, dit_param_dtype=jnp.float32),
                             vae_dtype=jnp.float32)
    modules = jax.device_get(jimage.init_modules(jax.random.key(0), js))
    ps = dataclasses.replace(port_spec(js), vae_dtype=torch.float32)
    mods = timage.build_modules(ps)
    load_jax_params(mods, modules)
    return js, ps, modules, mods


def _jax_fn(weights, mode, with_patches=False):
    js, _, modules, _ = weights
    if mode == "latents":
        return jpre.make_frozen_latent_fn(modules["vae"], js.vae_cfg, vae_dtype=jnp.float32)
    return jpre.make_frozen_fn("clip", modules["clip"]["model"], js.tower_cfg, modules["vae"],
                               js.vae_cfg, vae_dtype=jnp.float32, compute_dtype=jnp.float32,
                               with_patches=with_patches)


def _port_fn(weights, mode, with_patches=False):
    _, ps, _, mods = weights
    if mode == "latents":
        return pre.make_frozen_latent_fn(mods["vae"], ps.vae_cfg, vae_dtype=torch.float32)
    return pre.make_frozen_fn("clip", mods["clip"]["model"], ps.tower_cfg, mods["vae"],
                              ps.vae_cfg, vae_dtype=torch.float32, compute_dtype=torch.float32,
                              with_patches=with_patches)


def _read_shards(out):
    """{shard name: [(member name, bytes)]} of a cache directory."""
    shards = {}
    for name in sorted(os.listdir(out)):
        with tarfile.open(os.path.join(out, name)) as tf:
            shards[name] = [(m.name, tf.extractfile(m).read()) for m in tf.getmembers()]
    return shards


def _same_cache(ours, ref):
    """The shards hold the same members in the same groups; the feature
    arrays agree: float16 crops exactly, the rest within ``REL``."""
    a, b = _read_shards(ours), _read_shards(ref)
    assert list(a) == list(b)
    for shard in a:
        assert [n for n, _ in a[shard]] == [n for n, _ in b[shard]], shard
        for (name, x), (_, y) in zip(a[shard], b[shard]):
            if not name.endswith(".feat.npz"):
                assert x == y, name
                continue
            fx, fy = pre.load_feat(x), pre.load_feat(y)
            assert sorted(fx) == sorted(fy), name
            for k in fx:
                assert fx[k].dtype == fy[k].dtype and fx[k].shape == fy[k].shape, (name, k)
                if k == "pixels":
                    np.testing.assert_array_equal(fx[k], fy[k], err_msg=name)
                else:
                    assert _rel(fx[k], fy[k]) <= REL, (name, k, _rel(fx[k], fy[k]))


@pytest.mark.parametrize("mode, augment, variants", [
    ("latents", "train", 2), ("latents", "center", 1), ("features", "train", 1)])
def test_image_cache_matches_jax(weights, tmp_path, mode, augment, variants):
    src = tmp_path / "img"
    testing.make_image_shard(str(src / "i-000000.tar"), num_samples=7, img_size=40)
    kw = dict(batch=4, samples_per_shard=3, augment=augment, variants=variants, seed=3,
              mode=mode, num_workers=2)
    n = pre.precompute_image_dir(str(src), str(tmp_path / "ours"), _port_fn(weights, mode),
                                 IMG, **kw)
    m = jpre.precompute_image_dir(str(src), str(tmp_path / "ref"), _jax_fn(weights, mode),
                                  IMG, **kw)
    assert n == m == 7
    _same_cache(str(tmp_path / "ours"), str(tmp_path / "ref"))


def test_video_cache_and_loaders_match_jax(weights, tmp_path):
    """The video features cache, and the four loaders of both packages on
    the JAX-written cache: the same examples."""
    src = tmp_path / "vid"
    testing.make_video_shard(str(src / "v-000000.tar"), num_videos=3, frames_per_video=6,
                             img_size=IMG)
    n = pre.precompute_video_dir(str(src), str(tmp_path / "ours"),
                                 _port_fn(weights, "features", True), IMG, batch=4,
                                 samples_per_shard=2)
    m = jpre.precompute_video_dir(str(src), str(tmp_path / "ref"),
                                  _jax_fn(weights, "features", True), IMG, batch=4,
                                  samples_per_shard=2)
    assert n == m == 18
    _same_cache(str(tmp_path / "ours"), str(tmp_path / "ref"))
    kw = dict(train_batch_size=2, num_workers=1, img_size=IMG, shuffle_buffer=0,
              repeat=False, seed=0, precomputed=True, video_dir=str(tmp_path / "ref"))
    for mode in ("triplet", "next", "next2", "sliding"):
        extra = dict(window_cond=3, max_windows_per_video=2) if mode == "sliding" else {}
        ours = list(video.loader(mode=mode, **kw, **extra))
        ref = list(jvideo.loader(mode=mode, **kw, **extra))
        assert len(ours) == len(ref) == 1, mode
        assert sorted(ours[0]) == sorted(ref[0]), mode
        for k, v in ref[0].items():
            np.testing.assert_array_equal(ours[0][k], v, err_msg=f"{mode} {k}")
        assert ours[0]["cond_patches"].dtype == np.float16


def test_latent_cache_loss_matches_inline(weights, tmp_path):
    """``{moments, image}`` from the latent cache against the inline
    ``{image}`` step on the same center crops, with the same draws: the
    stage-2 loss within JAX's own 2e-3 (the crop's float16 round trip)."""
    js, _, modules, mods = weights
    src = tmp_path / "img"
    testing.make_image_shard(str(src / "i-000000.tar"), num_samples=6, img_size=IMG)
    pre.precompute_image_dir(str(src), str(tmp_path / "pre"), _port_fn(weights, "latents"), IMG,
                             batch=4, mode="latents")
    batch = next(iter(cc3m.loader(img_dir=str(tmp_path / "pre"), precomputed="latents",
                                  train_batch_size=3, num_workers=1, img_size=IMG,
                                  shuffle_buffer=0, repeat=False)))
    assert sorted(batch) == ["image", "moments", "text"] and batch["image"].dtype == np.float32
    inline = np.stack([eval_image_transform(s["jpg"], IMG)
                       for s, _ in zip(ShardStream(str(src), shuffle_buffer=0, repeat=False),
                                       range(3))])
    jss = dataclasses.replace(js, stage="stage2_only", lora_r=2, lora_alpha=2.0,
                              lora_dropout=0.1)
    ps = dataclasses.replace(port_spec(jss), stage="stage2_only", lora_r=2, lora_alpha=2.0,
                             lora_dropout=0.1, vae_dtype=torch.float32)
    m2 = timage.init_modules(ps, torch.Generator().manual_seed(0))
    for k in ("dit", "vae"):
        m2[k].load_state_dict(mods[k].state_dict())
    for k in ("project_clip", "project_t5"):
        m2["clip"][k].load_state_dict(mods["clip"][k].state_dict())
    loss_fn = timage.make_loss_fn(ps)
    draws = _jax_draws(jss, jax.random.key(4), 3)
    with torch.no_grad():
        l_inline = loss_fn(m2, {"image": t(inline)}, None, draws).item()
        l_pre = loss_fn(m2, {"image": t(batch["image"]), "moments": t(batch["moments"])},
                        None, draws).item()
    assert l_pre == pytest.approx(l_inline, rel=2e-3), (l_pre, l_inline)
    # the moments are the inline encode's: without the crop's round trip the
    # two losses are equal
    with torch.no_grad():
        l_exact = loss_fn(m2, {"image": t(inline), "moments": t(batch["moments"])},
                          None, draws).item()
    assert l_exact == pytest.approx(l_inline, rel=1e-5)


def test_features_cache_loss_matches_jax(weights, tmp_path):
    """``{moments, cls}`` (the stage-1 features cache) in the port's loss
    against JAX's, and against the port's own inline loss on the crops."""
    js, ps, modules, mods = weights
    src = tmp_path / "img"
    testing.make_image_shard(str(src / "i-000000.tar"), num_samples=4, img_size=IMG)
    pre.precompute_image_dir(str(src), str(tmp_path / "pre"), _port_fn(weights, "features"),
                             IMG, batch=4, augment="center")
    batch = next(iter(cc3m.loader(img_dir=str(tmp_path / "pre"), precomputed=True,
                                  train_batch_size=4, num_workers=1, img_size=IMG,
                                  shuffle_buffer=0, repeat=False)))
    assert sorted(batch) == ["cls", "moments", "text"]
    key = jax.random.key(9)
    draws = _jax_draws(dataclasses.replace(js, lora_dropout=0.0), key, 4)
    draws.pop("lora_masks")
    with torch.no_grad():
        ours = timage.make_loss_fn(ps)(mods, {k: t(batch[k]) for k in ("moments", "cls")},
                                       None, draws).item()
    from genhancer_tpu.train.state import flatten_params
    flat = flatten_params({k: modules[k] for k in ("dit", "vae", "clip")})
    ref = float(jimage.make_loss_fn(js)({}, flat, {k: jnp.asarray(batch[k])
                                                   for k in ("moments", "cls")}, key))
    assert ours == pytest.approx(ref, rel=1e-5)


def test_loader_mode_mismatch_and_empty_cache_raise(weights, tmp_path):
    src = tmp_path / "img"
    testing.make_image_shard(str(src / "i-000000.tar"), num_samples=4, img_size=IMG)
    pre.precompute_image_dir(str(src), str(tmp_path / "feat"), _port_fn(weights, "features"),
                             IMG, batch=4)
    pre.precompute_image_dir(str(src), str(tmp_path / "lat"), _port_fn(weights, "latents"),
                             IMG, batch=4, mode="latents")
    kw = dict(train_batch_size=2, num_workers=1, img_size=IMG, shuffle_buffer=0)
    with pytest.raises(RuntimeError, match="no pixels member"):
        next(iter(cc3m.loader(img_dir=str(tmp_path / "feat"), precomputed="latents", **kw)))
    with pytest.raises(RuntimeError, match="latents cache"):
        next(iter(cc3m.loader(img_dir=str(tmp_path / "lat"), precomputed=True, **kw)))
    with pytest.raises(RuntimeError, match="no .feat.npz"):     # pixel shards, repeating
        next(iter(cc3m.loader(img_dir=str(src), precomputed="latents", **kw)))
    vid = tmp_path / "vid"
    testing.make_video_shard(str(vid / "v-000000.tar"), num_videos=2, frames_per_video=4,
                             img_size=IMG)
    with pytest.raises(RuntimeError, match="produced 0 examples"):
        next(iter(video.loader(mode="triplet", video_dir=str(vid), precomputed=True, **kw)))


@pytest.mark.parametrize("task", ["image_stage2_all", "image_stage2_only",
                                  "video_middle_stage2_all"])
def test_factory_refuses_a_features_cache_in_stage2(task):
    """JAX's ``_check_precomputed``: the same refusal and message; the
    latent cache is taken in stage 2, a features cache in stage 1."""
    override = {"task": task, "data_config": {"precomputed": True}}
    cfg = load_config(CONFIGS["stage2_all"]).merged_with(override)
    with pytest.raises(ValueError, match="stage-1 only") as ours:
        factory.build_spec(cfg)
    with pytest.raises(ValueError, match="stage-1 only") as ref:
        jax_build_spec(jax_load_config(CONFIGS["stage2_all"]).merged_with(override))
    assert str(ours.value) == str(ref.value)
    latents = cfg.merged_with({"data_config": {"precomputed": "latents"}})
    assert factory.build_spec(latents)[0].stage == "stage2_" + task.rsplit("_", 1)[-1]
    stage1 = cfg.merged_with({"task": task.split("_stage")[0] + "_stage1"})
    assert factory.build_spec(stage1)[0].stage == "stage1"


def test_cli_builds_the_trainers_vae_and_the_cache_equals_its_encode(tiny_models, tmp_path):
    """``genhancer-precompute-torch --mode latents`` on a stage-2 config (on
    the CPU): its VAE is the trainer's (the same seed and draws), and each
    cached sample's moments are that VAE's encode of the cached crop."""
    src = tmp_path / "img"
    testing.make_image_shard(str(src / "i-000000.tar"), num_samples=5, img_size=40)
    cfg = write_cfg(tmp_path, str(src), task="image_stage2_only", mixed_precision="no",
                    vae_dtype="fp32", tower_quant="int8", dit_quant="int8")
    out = tmp_path / "cache"
    res = precompute_cli.main(["--config", str(tmp_path / "cfg.yaml"), "--output_dir",
                               str(out), "--mode", "latents", "--variants", "2", "--batch", "4",
                               "--device", "cpu"])
    assert res["written"] == 5 and res["bytes"] > 0
    trainer = Trainer(cfg, device="cpu")
    spec, modules = precompute_cli.build_frozen_modules(cfg, "cpu")
    vae = trainer.state.modules["vae"]
    for k, v in modules["vae"].state_dict().items():
        assert torch.equal(v, vae.state_dict()[k]), k
    members = dict(_read_shards(str(out))["pre-000000.tar"])
    # the first batch: images 0 and 1, two training crops each, from the
    # per-image generator
    crops = np.stack([train_image_transform(s["jpg"], IMG, rng)
                      for s, _ in zip(ShardStream(str(src), shuffle_buffer=0, repeat=False),
                                      range(2))
                      for rng in [np.random.default_rng((0, zlib.crc32(s["__key__"].encode())))]
                      for _ in range(2)])
    moments = pre.make_frozen_latent_fn(vae, spec.vae_cfg, vae_dtype=torch.float32)(
        crops)["moments"]
    for i, key in enumerate(("00000000", "00000001")):
        feats = pre.load_feat(members[f"{key}.feat.npz"])
        assert feats["pixels"].shape == (2, IMG, IMG, 3) and feats["moments"].ndim == 4
        np.testing.assert_array_equal(feats["pixels"], crops[2 * i:2 * i + 2].astype(np.float16))
        np.testing.assert_array_equal(feats["moments"], moments[2 * i:2 * i + 2])
