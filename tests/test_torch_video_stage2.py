"""Video stage 2 of the port (``video_*_stage2_all``: LoRA on the whole CLIP
tower under the video modes) against the JAX package
(genhancer_tpu/tasks/{video,factory}.py, models/towers/encoder.py) at tiny
widths.

The JAX tree is the JAX ``init_modules`` of a tiny stage-2 spec with a
nonzero ``lora_B`` planted in every wrapped linear, carried into the port
by ``weights/convert.py``.  The port's loss takes the JAX step's own draws:
t, the noise, the VAE sample and the LoRA dropout masks (``fold_in(k_drop,
call)`` + ``bernoulli``, call order q, k, v, out_proj, fc1, fc2 per layer
then visual_projection, over the b x n_cond conditioning frames).  Bounds
as image stage 2 (tests/test_torch_stage2.py): float32 loss 1e-5 relative,
each leaf's gradient within 1e-4 of its largest entry (1e-3 for the two
layers fed by the sinusoidal embeddings), params after one step (next)
within 2*lr*(1 + 1e-3).  middle runs with ``tower_remat`` on in both packages,
sliding at a joint length of 637 (JAX's Pallas flash kernel in interpret
mode, the port's plain K5).  The port's gradients with ``tower_remat`` on
and off are equal, with injected masks and with masks drawn from the
generator (the recompute replays them).

JAX's ``tower_remat`` draws its dropout masks at trace time inside
``jax.checkpoint``, whose trace cache is keyed on the layer function and its
static arguments, not on the dropout context: every later call of the
layer (the next layer, the next micro-batch) replays the first trace's
masks.  The tiny tower has one layer, and the JAX side runs each
micro-batch as one call of a fresh jitted function with the key as an
input, so both packages draw one mask per call.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genhancer_tpu.core import attention as jattention
from genhancer_tpu.tasks import factory as jfactory
from genhancer_tpu.tasks import video as jvideo
from genhancer_tpu.train import config as jconfig
from genhancer_tpu.train import flow as jflow
from genhancer_tpu.train import lora as jlora
from genhancer_tpu.train import optim as joptim
from genhancer_tpu.train import state as jstate
from genhancer_tpu.train import step_utils as jstep
from genhancer_tpu.train.trainer import hf_export_name as jax_export_name
from genhancer_tpu_torch import registry
from genhancer_tpu_torch.core import nn as tnn
from genhancer_tpu_torch.data import testing
from genhancer_tpu_torch.tasks import factory
from genhancer_tpu_torch.tasks import video as tvideo
from genhancer_tpu_torch.train import lora
from genhancer_tpu_torch.train import optim
from genhancer_tpu_torch.train.config import load_config
from genhancer_tpu_torch.train.step_utils import make_accum_train_step
from genhancer_tpu_torch.train.trainer import Trainer, hf_export_name
from genhancer_tpu_torch.weights.convert import load_jax_params

from test_torch_parity import TINY_DIT, TINY_TOWER, TINY_VAE, f32, port_cfg, t
from test_torch_train_step import _port_name
from test_torch_video import _write_cfg, tiny_models  # noqa: F401 (fixture)

torch.set_num_threads(1)

LR = 1e-3
HYPER = dict(learning_rate=LR, lr_scheduler="constant", max_train_steps=10)
LORA = dict(lora_r=3, lora_alpha=16.0, lora_dropout=0.1)      # scale 16/3
MODES = ("middle", "next", "next2", "sliding")
IMG = {"middle": 32, "next": 32, "next2": 32, "sliding": 100}
CONFIGS = {"middle": "configs/OpenAICLIP_336_video_stage2_all.yaml",
           "next": "configs/OpenAICLIP_nextpredic_stage2_all.yaml",
           "next2": "configs/OpenAICLIP_use2frames_stage2_all.yaml",
           "sliding": "configs/OpenAICLIP_224_sliding_stage2_all.yaml"}


def jax_spec(mode, tower_remat=None):
    return jvideo.VideoTaskSpec(
        mode=mode, stage="stage2_all", tower_kind="clip", img_size=IMG[mode],
        clip_image_size=32, dit_cfg=TINY_DIT, vae_cfg=TINY_VAE, tower_cfg=TINY_TOWER,
        clip_dim=24, t5_dim=32, adapter_in_dim=16, compute_dtype=jnp.float32,
        dit_param_dtype=jnp.float32, vae_dtype=jnp.float32,
        tower_remat=mode == "middle" if tower_remat is None else tower_remat, **LORA)


def port_spec(js) -> tvideo.VideoTaskSpec:
    return tvideo.VideoTaskSpec(
        mode=js.mode, stage=js.stage, tower_kind=js.tower_kind, img_size=js.img_size,
        clip_image_size=js.clip_image_size, dit_cfg=port_cfg(js.dit_cfg),
        vae_cfg=port_cfg(js.vae_cfg), tower_cfg=port_cfg(js.tower_cfg),
        clip_dim=js.clip_dim, t5_dim=js.t5_dim, adapter_in_dim=js.adapter_in_dim,
        compute_dtype=torch.float32, dit_param_dtype=torch.float32,
        vae_dtype=torch.float32, tower_remat=js.tower_remat, **LORA)


def _node(tree, path):
    for part in path.split("."):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


@pytest.fixture(scope="module")
def jax_init():
    """One float32 JAX stage-2 init per image size, a nonzero B planted in
    every wrapped linear."""
    out = {}
    for size in sorted(set(IMG.values())):
        mode = "sliding" if size == 100 else "middle"
        modules = jax.device_get(jvideo.init_modules(jax.random.key(0), jax_spec(mode)))
        rng = np.random.default_rng(4)
        tower = modules["clip"]["model"]
        for p in jlora.lora_trainable_paths(tower):
            if p.endswith(".lora_B"):
                node = _node(tower, p[: -len(".lora_B")])
                node["lora_B"] = 0.1 * rng.standard_normal(node["lora_B"].shape).astype(
                    np.float32)
        out[size] = modules
    return out


def _port_state(params, ps, optimizer):
    mods = tvideo.init_modules(ps, torch.Generator().manual_seed(0))
    load_jax_params(mods, params)
    return tvideo.create_state(mods, tvideo.trainable_predicate(ps, mods), optimizer)


def _jax_state(params, js, optimizer):
    modules = jax.tree_util.tree_map(jnp.asarray, params)
    return jstate.create_state(modules, jvideo.trainable_predicate(js, modules), optimizer)


def _mask_shapes(cfg, frames):
    """The input shape of each LoRA-wrapped call of the vision forward over
    ``frames`` conditioning frames, in call order."""
    v = cfg.vision
    l = v.grid ** 2 + 1
    return ([(frames, l, v.hidden_size)] * 5 + [(frames, l, v.intermediate_size)]) \
        * v.num_layers + [(frames, v.hidden_size)]


def _jax_draws(js, key, b):
    k_vae, k_t, k_noise, k_drop = jax.random.split(key, 4)
    h, w = js.latent_hw
    z = js.vae_cfg.z_channels
    keep = 1.0 - js.lora_dropout
    return {"t": t(np.asarray(jflow.sample_timesteps(k_t, b, js.scale_factor))),
            "x0": t(np.asarray(jax.random.normal(k_noise, (b, (h // 2) * (w // 2), 4 * z)))),
            "vae_noise": t(np.asarray(jax.random.normal(k_vae, (b, h, w, z)))),
            "lora_masks": [t(np.asarray(jax.random.bernoulli(jax.random.fold_in(k_drop, i + 1),
                                                             keep, s)))
                           for i, s in enumerate(_mask_shapes(js.tower_cfg, b * js.n_cond))]}


def _batch(mode, n, b=2, seed=3):
    rng = np.random.default_rng(seed)
    n_cond = tvideo.VIDEO_MODES[mode]["n_cond"]
    out = {"cond": rng.random((n, b, n_cond, 32, 32, 3), dtype=np.float32),
           "target": rng.random((n, b, IMG[mode], IMG[mode], 3), dtype=np.float32)}
    if mode == "sliding":     # a padded row, as the sliding loader emits
        out["valid"] = np.array([[True, False], [True, True]])[:n]
    return out


class _Recorder:
    """Delegates to an optimizer and keeps the grads it was given."""

    def __init__(self, inner):
        self.inner, self.grads = inner, None

    def init(self, params):
        return self.inner.init(params)

    def apply(self, params, grads, state):
        self.grads = {k: g.detach().clone() for k, g in grads.items()}
        return self.inner.apply(params, grads, state)


# ---------------------------------------------------------------- the step

def test_modules_and_trainable_set_match_jax(jax_init):
    """The whole CLIPModel, LoRA on its 14 linears (7 per side), and the
    trainable set: the DiT, the visual adapter and the LoRA paths (factors
    and wrapped biases), not project_clip."""
    js = jax_spec("middle")
    ps = port_spec(js)
    jst = _jax_state(jax_init[32], js, joptim.make_optimizer(dict(HYPER)))
    state = _port_state(jax_init[32], ps, optim.make_optimizer(dict(HYPER)))
    assert isinstance(state.modules["clip"]["model"], tvideo.clip_m.CLIPModel)
    assert {_port_name(k) for k in jst.trainable} == set(state.trainable)
    tower_train = {k for k in state.trainable if k.startswith("clip.model.")}
    assert len(tower_train) == 2 * 14 + 12      # 14 wrapped linears, 12 with a bias
    assert not any(k.startswith("clip.project_clip.") for k in state.trainable)
    grad_on = {k for k, p in state.modules.named_parameters() if p.requires_grad}
    assert grad_on == set(state.trainable)


@pytest.mark.parametrize("mode", MODES)
def test_accumulated_step_matches_jax(jax_init, monkeypatch, mode):
    """Loss and grads of one accumulation-2 ``stage2_all`` step, then the
    params after the chain's update; the text side's LoRA leaves take a zero
    gradient in both packages."""
    if mode == "sliding":     # JAX's Pallas flash kernel (interpret mode) at L=637
        monkeypatch.setattr(jattention, "_USE_PALLAS", "1")
        monkeypatch.setattr(jattention, "_fused_short_ok", lambda q: False)
    js = jax_spec(mode)
    ps = port_spec(js)
    params = jax_init[IMG[mode]]
    jopt = joptim.make_optimizer(dict(HYPER))
    jst = _jax_state(params, js, jopt)
    jloss = jvideo.make_loss_fn(js)
    batch = _batch(mode, 2)
    key = jax.random.key(11)
    keys = jax.random.split(key, 2)
    # make_accum_train_step's micro_grads, one jitted call per micro-batch:
    # the key is an input, so under tower_remat each micro-batch's masks are
    # its own (jax.checkpoint caches each traced layer with its dropout keys,
    # hence a fresh trace, and one layer)
    if js.tower_remat:
        jax.clear_caches()
    vg = jax.jit(jax.value_and_grad(
        lambda tp, micro, k: jloss(tp, jst.frozen, micro, k) * 0.5))
    jgrads, jl = None, 0.0
    for i in range(2):
        l, g = vg(jst.trainable, {k: jnp.asarray(v[i]) for k, v in batch.items()}, keys[i])
        jgrads = g if jgrads is None else jax.tree_util.tree_map(jnp.add, jgrads, g)
        jl += float(l)

    rec = _Recorder(optim.make_optimizer(dict(HYPER)))
    state = _port_state(params, ps, rec)
    step = make_accum_train_step(tvideo.make_loss_fn(ps), rec, 2)
    state, m = step(state, {k: t(v) for k, v in batch.items()}, None,
                    [_jax_draws(js, keys[i], 2) for i in range(2)])

    np.testing.assert_allclose(m["loss"].item(), jl, rtol=1e-5)
    text = [k for k in jgrads if k.startswith(("clip.model.text_model.",
                                               "clip.model.text_projection."))]
    assert len(text) == 2 * 7 + 6
    tower_max = max(np.abs(np.asarray(g)).max() for k, g in jgrads.items()
                    if k.startswith("clip.model."))
    for k, g in jgrads.items():
        ours, ref = f32(rec.grads[_port_name(k)]), np.asarray(g, np.float32)
        if k in text:
            assert not ref.any() and not ours.any(), k
            continue
        if k.endswith("self_attn.k_proj.bias"):    # 0 but for roundoff (image stage 2)
            assert max(np.abs(ours).max(), np.abs(ref).max()) <= 1e-4 * tower_max, k
            continue
        assert np.abs(ref).max() > 0, k
        rel = 1e-3 if k in ("dit.time_in.in_layer.weight", "dit.guidance_in.in_layer.weight") \
            else 1e-4
        assert np.abs(ours - ref).max() <= rel * np.abs(ref).max(), k
    if mode != "next":
        # the update itself once (it is the image stage-2 chain's); JAX's
        # jitted step traces both micro-batches at once, so under tower_remat
        # the second would replay the first's cached masks (ROADMAP §3)
        return
    new_jst, jm = jstep.make_accum_train_step(jloss, jopt, 2)(
        jst, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
    bound = 2 * LR * (1 + 1e-3)
    for k, v in new_jst.trainable.items():
        assert np.abs(f32(state.trainable[_port_name(k)]) - np.asarray(v, np.float32)).max() \
            <= bound, k


@pytest.mark.parametrize("masks", ["injected", "generator"])
def test_tower_remat_gives_the_same_grads(jax_init, monkeypatch, masks):
    """``tower_remat`` changes nothing but memory: the recompute in the
    backward draws the first pass's dropout masks (the injected list from
    the same index, or the generator from the same state)."""
    js = jax_spec("middle")
    batch = {k: t(v[0]) for k, v in _batch("middle", 1).items()}
    draws = _jax_draws(js, jax.random.key(2), 2)
    if masks == "generator":
        draws.pop("lora_masks")

    def grads(remat):
        ps = dataclasses.replace(port_spec(js), tower_remat=remat)
        state = _port_state(jax_init[32], ps, optim.make_optimizer(dict(HYPER)))
        gen = torch.Generator().manual_seed(7)
        tvideo.make_loss_fn(ps)(state.modules, batch, gen, draws).backward()
        return {k: p.grad.clone() for k, p in state.trainable.items() if p.grad is not None}

    off, on = grads(False), grads(True)
    assert sorted(on) == sorted(off)
    for k, g in off.items():
        assert torch.equal(on[k], g), k
    # the control: without the replay the recompute runs after the loss has
    # closed the dropout context, without dropout, and the checkpoint refuses
    # a recompute that saves other tensors than the forward did
    with monkeypatch.context() as mp:
        mp.setattr(tnn, "lora_dropout_replay", lambda fn: fn)
        with pytest.raises(torch.utils.checkpoint.CheckpointError):
            grads(True)


# ---------------------------------------------------------------- factory

@pytest.mark.parametrize("mode", MODES)
def test_build_spec_and_gates_match_jax(mode):
    """The published stage-2 video configs map to the JAX specs for one
    device and one process, the gates included: DiT remat on for middle@336
    only (joint L=1593), tower_remat on for next2 (8224 tower tokens) and
    middle@336 (18,464), off for sliding (1542) and next (4112)."""
    ours, kind, ck = factory.build_spec(load_config(CONFIGS[mode]))
    jcfg = jconfig.load_config(CONFIGS[mode])
    jcfg["num_devices"] = 1
    ref, rkind, rck = jfactory.build_spec(jcfg)
    assert (kind, ck) == (rkind, rck) == ("clip", "video")
    for f in ("mode", "stage", "img_size", "clip_image_size", "adapter_in_dim", "n_cond",
              "latent_hw", "patch_grid", "remat", "remat_policy", "tower_remat", "lora_r",
              "lora_alpha", "lora_targets", "lora_dropout"):
        assert getattr(ours, f) == getattr(ref, f), f
    assert dataclasses.asdict(ours.tower_cfg) == dataclasses.asdict(ref.tower_cfg)
    assert (ours.stage, ours.lora_dropout) == ("stage2_all", 0.1)
    assert ours.remat == (mode == "middle")
    assert ours.tower_remat == (mode in ("middle", "next2"))
    tokens = {"sliding": 1542, "next": 4112, "next2": 8224, "middle": 18464}[mode]
    n_cond, g = ours.n_cond, ours.patch_grid
    bs = int(load_config(CONFIGS[mode]).get_path("data_config.train_batch_size"))
    assert bs * n_cond * (g * g + 1) == tokens
    # a config's own value wins over the gate
    forced = factory.build_spec(load_config(CONFIGS[mode]).merged_with(
        {"tower_remat": False, "remat": False}))[0]
    assert not forced.tower_remat and not forced.remat


# ---------------------------------------------------------------- trainer

def test_trainer_from_stage1_through_export_and_resume(tiny_models, tmp_path):
    """The video stage-1 trainer writes step 2; the stage-2 trainer loads its
    DiT, project_clip and visual-adapter files through load_dir, trains 2
    steps with the gates' tower_remat on, writes the stage-1 files and the
    HF export at each checkpoint; a resume restarts the LoRA factors."""
    shard = testing.make_video_shard(str(tmp_path / "v.tar"), 6, 4, 32)
    s1 = Trainer(load_config(_write_cfg(tmp_path, shard, task="video_middle_stage1",
                                        max_train_steps=2)), device="cpu")
    s1.train()
    adapter = {k: v.clone() for k, v in s1.state.modules["visual_adapter"].state_dict().items()}
    stage1_out = s1.cfg["output_dir"]

    def cfg2(**kw):
        return load_config(_write_cfg(
            tmp_path, shard, task="video_middle_stage2_all", load_dir=stage1_out,
            load_step=2, output_dir=str(tmp_path / "out2"), checkpointing_steps=1,
            tower_remat=True, lora_config={"r": 4, "lora_alpha": 16, "lora_dropout": 0.1},
            **kw))

    cfg = cfg2(max_train_steps=2)
    trainer = Trainer(cfg, device="cpu")
    assert trainer.spec.stage == "stage2_all" and trainer.spec.tower_remat
    for k, v in trainer.state.modules["visual_adapter"].state_dict().items():
        assert torch.equal(v, adapter[k]), k                # loaded from load_dir
    init = {k: v.detach().clone() for k, v in trainer.state.trainable.items()}
    assert trainer.train()["step"] == 2
    out = cfg["output_dir"]
    for s in (1, 2):
        for name in ("checkpoint-dit", "checkpoint-project-clip",
                     "checkpoint-visual-adapter", "optimizer-state"):
            assert os.path.exists(os.path.join(out, f"{name}-{s}.bin"))
        assert hf_export_name(cfg, s) == jax_export_name(cfg, s) \
            == f"clip-vit-large-patch14-336-{s}"           # 32 px, not 224
        export = os.path.join(out, hf_export_name(cfg, s))
        assert sorted(os.listdir(export)) == ["config.json", "pytorch_model.bin"]
    lora_keys = [k for k in init if ".lora_" in k]
    assert any(not torch.equal(trainer.state.trainable[k].detach(), init[k])
               for k in lora_keys)
    tower, _ = registry.load_tower("clip", trainer.spec.tower_cfg, export)
    merged = lora.merge(trainer.state.modules["clip"]["model"])
    for k, v in merged.state_dict().items():
        assert torch.equal(tower.state_dict()[k], v), k

    resumed = Trainer(cfg2(max_train_steps=3), device="cpu")
    assert resumed.state.step == 2
    for k in lora_keys:
        assert torch.equal(resumed.state.trainable[k].detach(), init[k]), k
    assert resumed.train()["step"] == 3
    assert os.path.isdir(os.path.join(out, hf_export_name(cfg, 3)))
