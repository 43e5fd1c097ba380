"""The SigLIP tower in video mode (``tower: siglip`` with a video task) of
the port against the JAX package (genhancer_tpu/tasks/video.py:118,
210-228) at tiny widths, on the CPU.

Each frame's post-LN tokens (all of them: SigLIP has no CLS) go through the
visual adapter, and the frames' MAP-pooled vectors, averaged, are the DiT's
``y``, so the tower's width must be the DiT's ``vec_in_dim``: the tiny
tower is 24 wide, as TINY_DIT's ``vec_in_dim``.  The JAX tree (its
``init_modules``; in ``stage2_all`` a nonzero ``lora_B`` planted in every
wrapped linear) is carried into the port by ``weights/convert.py``, and
the port's loss takes JAX's draws.  ``stage2_all`` runs without LoRA
dropout, so no masks need carrying over (the masks' parity is
``tests/test_torch_video_stage2.py``'s).

Bounds (``tests/test_torch_video.py``'s): one accumulation-2 step's loss
within 1e-5 relative, every gradient leaf within 1e-4 of its largest
element (1e-3 for the two layers fed by the 1000·t sinusoids; the key
projections' biases, whose gradient is 0 but for roundoff, within 1e-4 of
the tower's largest gradient, as in image stage 2).  A tower
wider than ``vec_in_dim`` fails JAX's loss on that product and the port's
spec check.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genhancer_tpu.tasks import video as jvideo
from genhancer_tpu.train import lora as jlora
from genhancer_tpu.train import optim as joptim
from genhancer_tpu.train import state as jstate
from genhancer_tpu_torch.tasks import video as tvideo
from genhancer_tpu_torch.train import optim
from genhancer_tpu_torch.train.step_utils import make_accum_train_step
from genhancer_tpu_torch.weights.convert import load_jax_params

from test_torch_parity import TINY_DIT, TINY_VAE, f32, port_cfg, t
from test_torch_siglip import tiny_siglip
from test_torch_stage2 import _Recorder
from test_torch_train_step import _port_name
from test_torch_video import _jax_draws

torch.set_num_threads(1)

LR = 1e-3
HYPER = dict(learning_rate=LR, lr_scheduler="constant", max_train_steps=10)
SIGLIP = tiny_siglip(12)          # 24 wide = TINY_DIT.vec_in_dim; 64 tokens a frame
LORA = dict(lora_r=3, lora_alpha=16.0, lora_dropout=0.0)
SINCOS = ("dit.time_in.in_layer.weight", "dit.guidance_in.in_layer.weight")


def jax_spec(mode, stage, tower_cfg=SIGLIP):
    return jvideo.VideoTaskSpec(
        mode=mode, stage=stage, tower_kind="siglip", img_size=32, clip_image_size=32,
        dit_cfg=TINY_DIT, vae_cfg=TINY_VAE, tower_cfg=tower_cfg, clip_dim=24, t5_dim=32,
        adapter_in_dim=tower_cfg.vision.hidden_size, compute_dtype=jnp.float32,
        dit_param_dtype=jnp.float32, vae_dtype=jnp.float32, **LORA)


def port_spec(js) -> tvideo.VideoTaskSpec:
    return tvideo.VideoTaskSpec(
        mode=js.mode, stage=js.stage, tower_kind=js.tower_kind, img_size=js.img_size,
        clip_image_size=js.clip_image_size, dit_cfg=port_cfg(js.dit_cfg),
        vae_cfg=port_cfg(js.vae_cfg), tower_cfg=port_cfg(js.tower_cfg),
        clip_dim=js.clip_dim, t5_dim=js.t5_dim, adapter_in_dim=js.adapter_in_dim,
        compute_dtype=torch.float32, dit_param_dtype=torch.float32,
        vae_dtype=torch.float32, **LORA)


def _jax_modules(js):
    modules = jax.device_get(jvideo.init_modules(jax.random.key(0), js))
    if js.stage == "stage2_all":
        rng = np.random.default_rng(4)
        tower = modules["clip"]["model"]
        for p in jlora.lora_trainable_paths(tower):
            if p.endswith(".lora_B"):
                node = tower
                for part in p[: -len(".lora_B")].split("."):
                    node = node[int(part)] if isinstance(node, list) else node[part]
                node["lora_B"] = 0.1 * rng.standard_normal(node["lora_B"].shape).astype(
                    np.float32)
    return modules


@pytest.mark.parametrize("mode, stage", [("next", "stage1"), ("next", "stage2_all")])
def test_accumulated_loss_and_grads_match_jax(mode, stage):
    js = jax_spec(mode, stage)
    ps = port_spec(js)
    assert ps.patch_grid == js.patch_grid == 8
    modules = _jax_modules(js)
    jst = jstate.create_state(jax.tree_util.tree_map(jnp.asarray, modules),
                              jvideo.trainable_predicate(js, modules),
                              joptim.make_optimizer(dict(HYPER)))
    jloss = jvideo.make_loss_fn(js)
    rng = np.random.default_rng(3)
    n_cond = tvideo.VIDEO_MODES[mode]["n_cond"]
    batch = {"cond": rng.random((2, 2, n_cond, 32, 32, 3), dtype=np.float32),
             "target": rng.random((2, 2, 32, 32, 3), dtype=np.float32)}
    keys = jax.random.split(jax.random.key(11), 2)
    jgrads, jl = None, 0.0
    for i in range(2):
        micro = {k: jnp.asarray(v[i]) for k, v in batch.items()}
        l, g = jax.value_and_grad(
            lambda tp: jloss(tp, jst.frozen, micro, keys[i]) * 0.5)(jst.trainable)
        jgrads = g if jgrads is None else jax.tree_util.tree_map(jnp.add, jgrads, g)
        jl += float(l)

    rec = _Recorder(optim.make_optimizer(dict(HYPER)))
    mods = tvideo.init_modules(ps, torch.Generator().manual_seed(0))
    load_jax_params(mods, modules)
    state = tvideo.create_state(mods, tvideo.trainable_predicate(ps, mods), rec)
    assert set(state.trainable) == {_port_name(k) for k in jst.trainable}
    step = make_accum_train_step(tvideo.make_loss_fn(ps), rec, 2)
    draws = [_jax_draws(js, keys[i], 2) for i in range(2)]
    state, m = step(state, {k: t(v) for k, v in batch.items()}, None, draws)
    np.testing.assert_allclose(m["loss"].item(), jl, rtol=1e-5)
    tower_max = max([np.abs(np.asarray(g)).max() for k, g in jgrads.items()
                     if k.startswith("clip.model.")] or [0.0])
    for k, g in jgrads.items():
        ours, ref = f32(rec.grads[_port_name(k)]), np.asarray(g, np.float32)
        if k.endswith("self_attn.k_proj.bias"):     # 0 but for roundoff (image stage 2)
            assert max(np.abs(ours).max(), np.abs(ref).max()) <= 1e-4 * tower_max, k
            continue
        bound = 1e-3 if _port_name(k) in SINCOS else 1e-4
        assert np.abs(ours - ref).max() <= bound * max(np.abs(ref).max(), 1e-30), k
    if stage == "stage2_all":
        assert any(".lora_A" in k for k in jgrads)


def test_a_tower_wider_than_vec_in_dim_fails_in_both():
    wide = tiny_siglip(16)            # 32 wide against vec_in_dim 24
    js = jax_spec("next", "stage1", wide)
    modules = jvideo.init_modules(jax.random.key(0), js)
    jst = jstate.create_state(modules, jvideo.trainable_predicate(js, modules),
                              joptim.make_optimizer(dict(HYPER)))
    batch = {"cond": jnp.zeros((2, 1, 32, 32, 3)), "target": jnp.zeros((2, 32, 32, 3))}
    with pytest.raises(TypeError, match="dot_general"):
        jvideo.make_loss_fn(js)(jst.trainable, jst.frozen, batch, jax.random.key(1))
    with pytest.raises(ValueError, match="vec_in_dim=24"):
        tvideo.make_loss_fn(dataclasses.replace(port_spec(js)))
