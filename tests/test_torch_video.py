"""The port's video stage-1 path against the JAX package
(genhancer_tpu/tasks/video.py, tasks/conditioning.py, data/video.py,
tasks/factory.py, train/checkpoint.py) at tiny widths.

The JAX package's own random draws are injected on the port side
(``k_vae, k_t, k_noise, _ = split(key, 4)``, video.py:186).  Bounds: the
adapter and the conditioning within 1e-5; the float32 loss within 1e-5
relative; the grads of one accumulation-2 step within 1e-4 of each leaf's
largest gradient (float32 summation order and XLA's fusions), except the
layers fed by the sinusoidal timestep and guidance embeddings, 1e-3 (their
inputs are float32 sin/cos at up to 4000 rad, where XLA and torch differ by
1.2e-4 relative).  The sliding mode runs at a joint length of 637 tokens, so
JAX takes its flash kernel (Pallas, interpret mode) and the port the plain
K5; the other modes stay below 600 (K1 on both sides).  The loaders must
give the same windows, masks and pixels as the JAX loaders (both decode with
PIL; JAX's native decoder is patched off).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from genhancer_tpu.core import attention as jattention
from genhancer_tpu.core.pallas import flash_attention as jflash
from genhancer_tpu.data import native_decode as jnative
from genhancer_tpu.data import video as jvideo_data
from genhancer_tpu.data.testing import make_video_shard as jax_make_video_shard
from genhancer_tpu.models.towers import projectors as jproj
from genhancer_tpu.tasks import conditioning as jcond
from genhancer_tpu.tasks import factory as jfactory
from genhancer_tpu.tasks import video as jvideo
from genhancer_tpu.train import checkpoint as jckpt
from genhancer_tpu.train import config as jconfig
from genhancer_tpu.train import flow as jflow
from genhancer_tpu.train import optim as joptim
from genhancer_tpu.train import state as jstate
from genhancer_tpu.train.state import TrainState as JaxTrainState
from genhancer_tpu_torch import registry
from genhancer_tpu_torch.core.kernels import flash_attention as F
from genhancer_tpu_torch.data import testing
from genhancer_tpu_torch.data import video as video_data
from genhancer_tpu_torch.models import dit as tdit
from genhancer_tpu_torch.models.towers.projectors import VisualPromptAdapter, visual_adapter
from genhancer_tpu_torch.tasks import conditioning as tcond
from genhancer_tpu_torch.tasks import factory
from genhancer_tpu_torch.tasks import video as tvideo
from genhancer_tpu_torch.train import checkpoint as ckpt
from genhancer_tpu_torch.train import optim
from genhancer_tpu_torch.train.config import load_config
from genhancer_tpu_torch.train.step_utils import make_accum_train_step, merge_extras
from genhancer_tpu_torch.train.trainer import Trainer
from genhancer_tpu_torch.weights.convert import load_jax_params

from test_torch_parity import TINY_DIT, TINY_TOWER, TINY_VAE, f32, port_cfg, t
from test_torch_train_step import _port_name

torch.set_num_threads(1)

LR = 1e-3
HYPER = dict(learning_rate=LR, lr_scheduler="constant", max_train_steps=10)
# joint length: n_cond * (32/16)^2 tower patches + (img/4)^2 packed latents
IMG = {"middle": 32, "next": 32, "next2": 32, "sliding": 100}
CONFIGS = {"middle": "configs/OpenAICLIP_336_video_stage1.yaml",
           "next": "configs/OpenAICLIP_nextpredic_stage1.yaml",
           "next2": "configs/OpenAICLIP_use2frames_stage1.yaml",
           "sliding": "configs/OpenAICLIP_224_sliding_stage1.yaml"}


def jax_spec(mode):
    return jvideo.VideoTaskSpec(
        mode=mode, stage="stage1", tower_kind="clip", img_size=IMG[mode],
        clip_image_size=32, dit_cfg=TINY_DIT, vae_cfg=TINY_VAE, tower_cfg=TINY_TOWER,
        clip_dim=24, t5_dim=32, adapter_in_dim=16, compute_dtype=jnp.float32,
        dit_param_dtype=jnp.float32, vae_dtype=jnp.float32)


def port_spec(js) -> tvideo.VideoTaskSpec:
    return tvideo.VideoTaskSpec(
        mode=js.mode, stage=js.stage, tower_kind=js.tower_kind, img_size=js.img_size,
        clip_image_size=js.clip_image_size, dit_cfg=port_cfg(js.dit_cfg),
        vae_cfg=port_cfg(js.vae_cfg), tower_cfg=port_cfg(js.tower_cfg),
        clip_dim=js.clip_dim, t5_dim=js.t5_dim, adapter_in_dim=js.adapter_in_dim,
        compute_dtype=torch.float32, dit_param_dtype=torch.float32,
        vae_dtype=torch.float32)


@pytest.fixture(scope="module")
def jax_init():
    """One JAX init per mode's image size (the first eager JAX calls compile)."""
    out = {}
    for size in sorted(set(IMG.values())):
        mode = "sliding" if size == 100 else "middle"
        modules = jvideo.init_modules(jax.random.key(0), jax_spec(mode))
        out[size] = (modules, jax.device_get(modules))
    return out


def _batch(mode, n, b=2, seed=3):
    rng = np.random.default_rng(seed)
    size, n_cond = IMG[mode], tvideo.VIDEO_MODES[mode]["n_cond"]
    # the tower sees 32-px frames; the VAE encodes the target at IMG[mode]
    out = {"cond": rng.random((n, b, n_cond, 32, 32, 3), dtype=np.float32),
           "target": rng.random((n, b, size, size, 3), dtype=np.float32)}
    if mode == "sliding":     # a padded row, as the sliding loader emits
        out["valid"] = np.array([[True, False], [True, True]])[:n]
    return out


def _jax_draws(js, key, b):
    k_vae, k_t, k_noise, _ = jax.random.split(key, 4)
    h, w = js.latent_hw
    z = js.vae_cfg.z_channels
    return {"t": t(np.asarray(jflow.sample_timesteps(k_t, b, js.scale_factor))),
            "x0": t(np.asarray(jax.random.normal(k_noise, (b, (h // 2) * (w // 2), 4 * z)))),
            "vae_noise": t(np.asarray(jax.random.normal(k_vae, (b, h, w, z))))}


class _Recorder:
    """Delegates to an optimizer and keeps the grads it was given."""

    def __init__(self, inner):
        self.inner, self.grads = inner, None

    def init(self, params):
        return self.inner.init(params)

    def apply(self, params, grads, state):
        self.grads = {k: g.detach().clone() for k, g in grads.items()}
        return self.inner.apply(params, grads, state)


# ---------------------------------------------------------------- modules

def test_adapter_and_conditioning_match_jax(jax_init):
    js = jax_spec("sliding")
    modules, params = jax_init[100]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, 16), dtype=np.float32)
    ad = VisualPromptAdapter(16, 32).requires_grad_(False)
    ad.load_state_dict({k: t(v) for k, v in
                        load_flat(params["visual_adapter"]).items()}, strict=True)
    np.testing.assert_allclose(
        visual_adapter(ad, t(x)).numpy(),
        np.asarray(jproj.visual_adapter(modules["visual_adapter"], jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)
    patches = [rng.standard_normal((2, 4, 16), dtype=np.float32) for _ in range(3)]
    vecs = [rng.standard_normal((2, 24), dtype=np.float32) for _ in range(3)]
    ref = jcond.video_conditioning(modules, [jnp.asarray(p) for p in patches],
                                   [jnp.asarray(v) for v in vecs], js.latent_hw,
                                   js.patch_grid, js.target_time, js.frame_times,
                                   compute_dtype=jnp.float32)
    ours = tcond.video_conditioning({"visual_adapter": ad}, [t(p) for p in patches],
                                    [t(v) for v in vecs], js.latent_hw, js.patch_grid,
                                    js.target_time, js.frame_times,
                                    compute_dtype=torch.float32)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert tuple(ours[k].shape) == tuple(ref[k].shape), k
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def load_flat(tree, prefix=""):
    from genhancer_tpu_torch.weights.convert import flatten_tree
    return flatten_tree(tree, prefix)


def test_modules_and_trainable_set_match_jax(jax_init):
    js = jax_spec("sliding")
    modules, params = jax_init[100]
    mods = tvideo.build_modules(port_spec(js))
    load_jax_params(mods, params)                       # strict on every component
    jtrain, _ = jstate.partition(modules, jvideo.trainable_predicate(js, modules))
    state = tvideo.create_state(mods, tvideo.trainable_predicate(port_spec(js)),
                                optim.make_optimizer(dict(HYPER)))
    assert {_port_name(k) for k in jtrain} == set(state.trainable)
    assert not any(k.startswith("clip.") for k in state.trainable)   # project_clip frozen
    assert any(k.startswith("visual_adapter.") for k in state.trainable)


# ---------------------------------------------------------------- the loss

@pytest.mark.parametrize("mode", ["middle", "next", "next2", "sliding"])
def test_accumulated_loss_and_grads_match_jax(jax_init, monkeypatch, mode):
    """The loss and grads of one accumulation-2 step (float32 accumulators)
    against jax.value_and_grad of the JAX loss with the same draws."""
    flash_calls = {"jax": 0, "port": 0}
    if mode == "sliding":     # JAX's Pallas flash kernel (interpret mode) at L=637
        monkeypatch.setattr(jattention, "_USE_PALLAS", "1")
        monkeypatch.setattr(jattention, "_fused_short_ok", lambda q: False)
        real_jax, real_port = jflash.flash_attention, F.flash_attention_fwd_ref

        def jax_spy(*a):
            flash_calls["jax"] += 1
            return real_jax(*a)

        def port_spy(*a):
            flash_calls["port"] += 1
            return real_port(*a)
        monkeypatch.setattr(jflash, "flash_attention", jax_spy)
        monkeypatch.setattr(F, "flash_attention_fwd_ref", port_spy)
    js = jax_spec(mode)
    ps = port_spec(js)
    n_tok = (js.latent_hw[0] // 2) ** 2 + js.n_cond * js.patch_grid ** 2
    assert (n_tok >= 600) == (mode == "sliding")
    modules, params = jax_init[IMG[mode]]
    jopt = joptim.make_optimizer(dict(HYPER))
    jst = jstate.create_state(modules, jvideo.trainable_predicate(js, modules), jopt)
    jloss = jvideo.make_loss_fn(js)
    batch = _batch(mode, 2)
    keys = jax.random.split(jax.random.key(11), 2)
    jgrads, jl = None, 0.0
    for i in range(2):
        micro = {k: jnp.asarray(v[i]) for k, v in batch.items()}
        l, g = jax.value_and_grad(
            lambda tp: jloss(tp, jst.frozen, micro, keys[i]) * 0.5)(jst.trainable)
        jgrads = g if jgrads is None else jax.tree_util.tree_map(jnp.add, jgrads, g)
        jl += float(l)

    rec = _Recorder(optim.make_optimizer(dict(HYPER)))
    mods = tvideo.build_modules(ps)
    load_jax_params(mods, params)
    state = tvideo.create_state(mods, tvideo.trainable_predicate(ps), rec)
    step = make_accum_train_step(tvideo.make_loss_fn(ps), rec, 2)
    draws = [_jax_draws(js, keys[i], 2) for i in range(2)]
    before = dict(F.LAUNCHES)
    state, m = step(state, {k: t(v) for k, v in batch.items()}, None, draws)
    assert F.LAUNCHES == before                      # CPU: plain versions only
    blocks = js.dit_cfg.depth + js.dit_cfg.depth_single_blocks
    want = 2 * blocks if mode == "sliding" else 0    # one call per block and micro-batch
    assert flash_calls == {"jax": want, "port": want}
    np.testing.assert_allclose(m["loss"].item(), jl, rtol=1e-5)
    for k, g in jgrads.items():
        ours, ref = f32(rec.grads[_port_name(k)]), np.asarray(g, np.float32)
        rel = 1e-3 if k in ("dit.time_in.in_layer.weight", "dit.guidance_in.in_layer.weight") \
            else 1e-4
        assert np.abs(ours - ref).max() <= rel * max(np.abs(ref).max(), 1e-30), k


def test_remat_recomputes_the_same_grads(jax_init):
    """remat (checkpointed DiT blocks) changes nothing but memory."""
    js = jax_spec("next2")
    batch = {k: t(v[0]) for k, v in _batch("next2", 1).items()}
    draws = _jax_draws(js, jax.random.key(2), 2)
    grads = []
    for remat in (False, True):
        ps = dataclasses.replace(port_spec(js), remat=remat)
        mods = tvideo.build_modules(ps)
        load_jax_params(mods, jax_init[32][1])
        state = tvideo.create_state(mods, tvideo.trainable_predicate(ps),
                                    optim.make_optimizer(dict(HYPER)))
        tvideo.make_loss_fn(ps)(state.modules, batch, None, draws).backward()
        grads.append({k: p.grad.clone() for k, p in state.trainable.items()})
    for k, g in grads[0].items():
        torch.testing.assert_close(grads[1][k], g, rtol=1e-6, atol=1e-7)


def test_unported_options_raise(jax_init):
    """The int8 knobs and the features-cache batches run (ported in the fast
    stage-2 slice: a ``{moments, cond_patches, cond_vecs}`` batch gives
    JAX's loss within 1e-5); SigLIP in video mode and a remat policy the
    port lacks still raise."""
    js = jax_spec("middle")
    ps = port_spec(js)
    for knob in ("tower_quant", "vae_quant", "dit_quant"):
        tvideo.make_loss_fn(dataclasses.replace(ps, **{knob: "int8"}))
    with pytest.raises(NotImplementedError, match="SigLIP"):
        tvideo.make_loss_fn(dataclasses.replace(ps, tower_kind="siglip"))
    rng = np.random.default_rng(6)
    h, w = js.latent_hw
    lp = (32 // 16) ** 2
    batch = {"moments": rng.standard_normal((2, h, w, 8)).astype(np.float32),
             "cond_patches": rng.standard_normal((2, 2, lp, 16)).astype(np.float16),
             "cond_vecs": rng.standard_normal((2, 2, 24)).astype(np.float32)}
    modules, host = jax_init[32]
    key = jax.random.key(2)
    flat = jstate.flatten_params(modules)
    ref = float(jvideo.make_loss_fn(js)({}, flat, {k: jnp.asarray(v) for k, v in batch.items()},
                                        key))
    mods = tvideo.build_modules(ps)
    load_jax_params(mods, host)
    with torch.no_grad():
        ours = tvideo.make_loss_fn(ps)(mods, {k: t(v) for k, v in batch.items()}, None,
                                       _jax_draws(js, key, 2)).item()
    assert ours == pytest.approx(ref, rel=1e-5)
    dit = tdit.DiT(ps.dit_cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdit.dit_forward(dit, ps.dit_cfg, img=torch.zeros(1, 4, 16), img_ids=None,
                         txt=torch.zeros(1, 1, 32), txt_ids=None, timesteps=None, y=None,
                         remat=True, remat_policy="save_attn")


@pytest.mark.parametrize("override, refused", [
    # a features cache in stage 2 is refused as JAX refuses it
    pytest.param({"task": "video_sliding_stage2_all", "data_config": {"precomputed": True}},
                 ValueError, id="override0-slice 5"),
    pytest.param({"tower": "siglip"}, NotImplementedError, id="override1-SigLIP"),
    # the int8 knobs and the stage-1 features cache are ported
    pytest.param({"tower_quant": "int8"}, None, id="override2-slice 3"),
    pytest.param({"vae_quant": "int8"}, None, id="override3-slice 3"),
    pytest.param({"dit_quant": "int8"}, None, id="override4-slice 3"),
    pytest.param({"data_config": {"precomputed": True}}, None, id="override5-slice 5"),
])
def test_unported_config_options_raise(override, refused):
    """Each option on the published sliding config: refused where JAX or
    the port refuses it, else the spec JAX's ``build_spec`` gives."""
    cfg = load_config(CONFIGS["sliding"]).merged_with(override)
    if refused is not None:
        with pytest.raises(refused):
            factory.build_spec(cfg)
        return
    ours = factory.build_spec(cfg)[0]
    ref = jfactory.build_spec(jconfig.load_config(CONFIGS["sliding"]).merged_with(override))[0]
    for f in ("tower_quant", "vae_quant", "vae_quant_min_ch", "dit_quant", "dit_quant_cache",
              "stage", "remat"):
        assert getattr(ours, f) == getattr(ref, f), f


def test_engine_refuses_a_video_config():
    from genhancer_tpu_torch.serve.engine import InferenceEngine
    with pytest.raises(NotImplementedError, match="video task"):
        InferenceEngine.from_config(CONFIGS["sliding"], device="cpu")


# ---------------------------------------------------------------- factory

@pytest.mark.parametrize("mode", sorted(CONFIGS))
def test_build_spec_and_remat_gate_match_jax(mode):
    """The published stage-1 video configs map to the JAX specs, remat gate
    included, for one device and one process: only middle@336 (B=32,
    L=1593) turns remat on."""
    ours, kind, ck = factory.build_spec(load_config(CONFIGS[mode]))
    jcfg = jconfig.load_config(CONFIGS[mode])
    jcfg["num_devices"] = 1
    ref, rkind, rck = jfactory.build_spec(jcfg)
    assert (kind, ck) == (rkind, rck) == ("clip", "video")
    for f in ("mode", "stage", "img_size", "clip_image_size", "clip_dim", "t5_dim",
              "adapter_in_dim", "n_cond", "frame_times", "target_time", "latent_hw",
              "patch_grid", "remat", "remat_policy"):
        assert getattr(ours, f) == getattr(ref, f), f
    for f in ("dit_cfg", "vae_cfg", "tower_cfg"):
        assert dataclasses.asdict(getattr(ours, f)) == dataclasses.asdict(getattr(ref, f))
    assert ours.remat == (mode == "middle")


def test_trainer_compat_has_the_jax_video_rows():
    assert {k: v for k, v in jfactory.TRAINER_COMPAT.items() if "OpenAICLIP" in k} == \
        {k: v for k, v in factory.TRAINER_COMPAT.items() if "OpenAICLIP" in k}


# ---------------------------------------------------------------- data

@pytest.mark.parametrize("mode, kw", [
    ("triplet", {}), ("next", {}), ("next2", {}),
    ("sliding", {"max_windows_per_video": 3, "max_frames_per_video": 7}),
])
def test_loaders_match_jax(tmp_path, monkeypatch, mode, kw):
    monkeypatch.setattr(jnative, "available", lambda: False)
    path = str(tmp_path / "v.tar")
    jax_make_video_shard(path, num_videos=5, frames_per_video=9, img_size=40, seed=4)
    ours_path = str(tmp_path / "ours.tar")
    testing.make_video_shard(ours_path, num_videos=5, frames_per_video=9, img_size=40,
                             seed=4)
    with open(path, "rb") as a, open(ours_path, "rb") as b:
        assert a.read() == b.read()
    common = dict(video_dir=path, train_batch_size=2, num_workers=2, img_size=24, seed=7,
                  shuffle_buffer=3, **kw)
    ref = iter(jvideo_data.loader(mode=mode, **common))
    ours_loader = video_data.loader(mode=mode, **common)
    ours = iter(ours_loader)
    for _ in range(3):
        r, o = next(ref), next(ours)
        assert sorted(r) == sorted(o)
        for k in r:
            np.testing.assert_array_equal(np.asarray(o[k]), np.asarray(r[k]), err_msg=k)
    ours_loader.close()


def test_sliding_pads_short_videos(tmp_path):
    path = testing.make_video_shard(str(tmp_path / "v.tar"), num_videos=2,
                                    frames_per_video=[12, 6], img_size=32)
    loader = video_data.loader(mode="sliding", video_dir=path, train_batch_size=2,
                               num_workers=1, img_size=16, shuffle_buffer=0,
                               max_windows_per_video=8)
    batch = next(iter(loader))
    loader.close()
    assert batch["cond"].shape == (16, 3, 16, 16, 3) and batch["target"].shape == (16, 16, 16, 3)
    assert batch["valid"].tolist() == [True] * 11 + [False] * 5      # 8 + 3 windows
    assert not batch["cond"][11:].any() and not batch["target"][11:].any()
    assert batch["bs_eff"] == 11 and batch["avg_windows_per_video"] == 5.5
    assert merge_extras([{"bs_eff": 11, "x": "a"}, {"bs_eff": 12, "x": "b"}]) == \
        {"bs_eff": 11.5, "x": "b"}


# ---------------------------------------------------------------- trainer, checkpoints

@pytest.fixture
def tiny_models(monkeypatch):
    monkeypatch.setattr(registry, "build_dit_config", lambda name: port_cfg(TINY_DIT))
    monkeypatch.setattr(registry, "build_vae_config", lambda name, ae_path=None: port_cfg(TINY_VAE))
    monkeypatch.setattr(registry, "tower_family_and_config",
                        lambda tower, size, clip_type=None: ("clip", port_cfg(TINY_TOWER)))


def _write_cfg(tmp_path, shard, **overrides):
    cfg = {"data_config": {"train_batch_size": 2, "num_workers": 1, "img_size": 32,
                           "video_dir": shard, "seed": 0, "return_mode": "full_frames",
                           "max_frames_per_video": 200},
           "clip_config": {"clip_image_size": 32, "clip_dim": 24, "t5_dim": 32},
           "window_cond": 3, "window_stride": 1, "max_windows_per_video": 2,
           "output_dir": str(tmp_path / "out"), "max_train_steps": 3,
           "checkpointing_steps": 2, "learning_rate": 1e-3,
           "gradient_accumulation_steps": 2, "mixed_precision": "bf16",
           "report_to": "none", "log_interval": 1, "resume_from_checkpoint": "latest"}
    cfg.update(overrides)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


VIDEO_FILES = ("checkpoint-dit", "checkpoint-project-clip", "checkpoint-visual-adapter",
               "optimizer-state")


def test_sliding_cli_trains_checkpoints_and_resumes(tiny_models, tmp_path):
    from genhancer_tpu_torch.cli.train import main
    shard = testing.make_video_shard(str(tmp_path / "v.tar"), 4, [6, 3, 5, 6], 32)
    path = _write_cfg(tmp_path, shard)
    metrics = main(["--config", path, "--device", "cpu", "--trainer",
                    "train_OpenAICLIP_sliding_windows_nextpredic_stage1"])
    assert metrics["step"] == 3 and np.isfinite(metrics["loss"])
    assert metrics["bs_eff"] == 4 and metrics["avg_windows_per_video"] == 2.0
    out = str(tmp_path / "out")
    assert ckpt.all_steps(out) == [2, 3]
    for s in (2, 3):
        for name in VIDEO_FILES:
            assert os.path.exists(os.path.join(out, f"{name}-{s}.bin")), (name, s)
    assert not os.path.exists(os.path.join(out, "checkpoint-project-t5-3.bin"))

    cfg = load_config(path)
    cfg.update(task="video_sliding_stage1", tower="openai_clip", max_train_steps=4)
    resumed = Trainer(cfg, device="cpu")
    assert resumed.state.step == 3 and resumed.state.opt_state["count"] == 3
    assert resumed.train()["step"] == 4


def _video_sds(modules):
    return {"dit": modules["dit"].state_dict(),
            "project_clip": modules["clip"]["project_clip"].state_dict(),
            "visual_adapter": modules["visual_adapter"].state_dict()}


def _jax_name(port_key, prefix):
    from genhancer_tpu.weights import hf_convert
    if prefix == "dit":
        return "dit." + hf_convert._dit_rename_from_torch(port_key)
    return f"{prefix}.{port_key}"


PREFIX = {"dit": "dit", "project_clip": "clip.project_clip", "visual_adapter": "visual_adapter"}


def test_video_bins_cross_load_both_ways(tmp_path, jax_init):
    ps = port_spec(jax_spec("middle"))
    src = tvideo.init_modules(ps, torch.Generator().manual_seed(3))
    state = tvideo.create_state(src, tvideo.trainable_predicate(ps),
                                optim.make_optimizer(dict(HYPER)))
    ckpt.save_stage1(state, str(tmp_path / "ours"), 5, "video")
    sds = _video_sds(src)
    flat = {_jax_name(k, PREFIX[n]): jnp.zeros(tuple(v.shape), jnp.float32)
            for n, sd in sds.items() for k, v in sd.items()}
    jst = JaxTrainState(trainable=flat, frozen={}, opt_state=(), step=jnp.zeros((), jnp.int32))
    jst = jckpt.load_stage1_components(jst, str(tmp_path / "ours"), 5, "video")
    for n, sd in sds.items():
        for k, v in sd.items():
            np.testing.assert_array_equal(np.asarray(jst.trainable[_jax_name(k, PREFIX[n])]),
                                          v.numpy(), err_msg=k)

    # the JAX writer's files load strictly into the port
    trainable = {_jax_name(k, PREFIX[n]): jnp.asarray(v.numpy() + 1.0)
                 for n, sd in sds.items() for k, v in sd.items()}
    jckpt.save_stage1(JaxTrainState(trainable=trainable, frozen={}, opt_state=(),
                                    step=jnp.asarray(6, jnp.int32)),
                      str(tmp_path / "ref"), 6, kind="video")
    dst = tvideo.init_modules(ps, torch.Generator().manual_seed(4))
    ckpt.load_stage1_components(dst, str(tmp_path / "ref"), 6, "video")
    for n, sd in _video_sds(dst).items():
        for k, v in sd.items():
            assert torch.equal(v, sds[n][k] + 1.0), k
