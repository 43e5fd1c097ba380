"""The port's SigLIP so400m tower family (genhancer_tpu_torch/models/towers/
siglip.py and the paths that run it: conditioning, image stage 1 and 2,
the HF loader and export, the MMVP-VLM eval, the engine) against the JAX
package (genhancer_tpu/models/towers/siglip.py and its callers).

Tiny towers with two heads of D = 8 or D = 72, at 64 tokens (the tower
attention's K2 path) or 625 tokens (350 px, patch 14: the K5 path, L >=
600); the JAX side runs its Pallas kernels as the JAX package's own tests
run them on the CPU (interpret mode, ``core.attention._USE_PALLAS = "1"``),
and the test checks which kernel each package's dispatch chose.  Weights
are carried across by ``weights/convert.py``; inputs are made with NumPy
from a seed.  Bounds: float32 1e-5 on the vision and text forwards, the MAP
head, the logits and the conditioning; the stage-1 and stage-2 steps as in
tests/test_torch_stage2.py (loss 1e-5, each leaf's gradient 1e-4 of its
largest, 1e-3 for the two layers fed by the sinusoidal embeddings, params
within 2*lr*(1 + 1e-3)) on the flux-debug DiT and VAE with JAX's draws:
t, the noise, the VAE sample and the LoRA dropout masks (``fold_in(k_drop,
call)`` + ``bernoulli``, call order q, k, v, out_proj, fc1, fc2 per layer,
then the head's out_proj, fc1, fc2: 165 per vision forward at full depth)
with a planted nonzero ``lora_B``.
"""

import dataclasses
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genhancer_tpu import registry as jregistry
from genhancer_tpu.core import attention as jattention
from genhancer_tpu.eval import mmvp as jmmvp
from genhancer_tpu.models import dit as jdit
from genhancer_tpu.models import vae as jvae
from genhancer_tpu.models.towers import siglip as jsiglip
from genhancer_tpu.tasks import conditioning as jcond
from genhancer_tpu.tasks import image as jimage
from genhancer_tpu.train import flow as jflow
from genhancer_tpu.train import lora as jlora
from genhancer_tpu.train import optim as joptim
from genhancer_tpu.train import state as jstate
from genhancer_tpu.train import step_utils as jstep
from genhancer_tpu.train.trainer import hf_export_name as jax_export_name
from genhancer_tpu.weights import hf_convert
from genhancer_tpu.weights.torch_io import save_torch_state_dict
from genhancer_tpu_torch import registry
from genhancer_tpu_torch.cli import evaluate as cli_evaluate
from genhancer_tpu_torch.core import nn as tnn_port
from genhancer_tpu_torch.core.kernels import flash_attention as tflash
from genhancer_tpu_torch.core.kernels import short_attention as tshort
from genhancer_tpu_torch.eval import mmvp
from genhancer_tpu_torch.models.towers import siglip as tsiglip
from genhancer_tpu_torch.serve.engine import InferenceEngine
from genhancer_tpu_torch.tasks import conditioning as tcond
from genhancer_tpu_torch.tasks import image as timage
from genhancer_tpu_torch.train import checkpoint as ckpt
from genhancer_tpu_torch.train import lora
from genhancer_tpu_torch.train import optim
from genhancer_tpu_torch.train.step_utils import make_accum_train_step
from genhancer_tpu_torch.train.trainer import Trainer, hf_export_name
from genhancer_tpu_torch.weights.convert import load_jax_params, tower_state_dict

from test_torch_eval import assert_same_results, fake_tokenize, write_benchmark
from test_torch_parity import TINY_DIT, TINY_VAE, f32, port_cfg, port_spec, t
from test_torch_stage2 import _node, _port_name, _Recorder
from test_torch_train_e2e import shards, write_cfg  # noqa: F401 (fixture)

torch.set_num_threads(1)

LR = 1e-3
HYPER = dict(learning_rate=LR, lr_scheduler="constant", max_train_steps=10)
LORA = dict(lora_r=3, lora_alpha=16.0, lora_dropout=0.1)      # scale 16/3
SEQS = {"L64-K2": (32, 4), "L625-K5": (350, 14)}             # image size, patch


def tiny_siglip(d: int, seq: str = "L64-K2", layers: int = 2) -> jsiglip.SiglipConfig:
    """Two heads of ``d`` on each side; 64 or 625 vision tokens, 12 text
    positions."""
    image, patch = SEQS[seq]
    return jsiglip.SiglipConfig(
        vision=jsiglip.SiglipVisionConfig(hidden_size=2 * d, intermediate_size=48,
                                          num_layers=layers, num_heads=2, image_size=image,
                                          patch_size=patch),
        text=jsiglip.SiglipTextConfig(hidden_size=2 * d, intermediate_size=48,
                                      num_layers=layers, num_heads=2, vocab_size=50,
                                      max_position_embeddings=12, projection_size=2 * d))


def jax_tree(cfg, seed=0):
    """``init_siglip`` as numpy leaves, with a nonzero logit_scale and bias
    (the JAX init's 1.0 and 0.0 would hide a missing bias)."""
    tree = jax.device_get(jsiglip.init_siglip(jax.random.key(seed), cfg))
    tree["logit_scale"], tree["logit_bias"] = np.float32(2.3), np.float32(-1.7)
    return tree


def port_tower(tree, cfg, text_side=True):
    cls = tsiglip.SiglipModel if text_side else tsiglip.SiglipVisionTower
    model = cls(port_cfg(cfg))
    model.load_state_dict(tower_state_dict(tree, text_side=text_side), strict=True)
    return model.eval().requires_grad_(False)


def _close(ours, ref, bound=1e-5, msg=""):
    ours, ref = f32(ours), np.asarray(ref, np.float32)
    assert ours.shape == ref.shape, msg
    assert np.abs(ours - ref).max() <= bound * np.abs(ref).max(), msg


@pytest.fixture
def kernels_seen(monkeypatch):
    """Run the JAX side through its Pallas kernels (interpret mode) and
    record which attention kernel each package's dispatch chose."""
    seen = {"jax": [], "port": []}
    monkeypatch.setattr(jattention, "_USE_PALLAS", "1")
    for attr, name in (("_flash_fn", "flash"), ("_fused_norope_fn", "short")):
        inner = getattr(jattention, attr)()

        def spy(*a, inner=inner, name=name):
            seen["jax"].append(name)
            return inner(*a)
        monkeypatch.setattr(jattention, attr, lambda spy=spy: spy)
    for mod, attr, name in ((tflash, "flash_attention", "flash"),
                            (tshort, "fused_attention", "short")):
        inner = getattr(mod, attr)

        def pspy(*a, inner=inner, name=name):
            seen["port"].append(name)
            return inner(*a)
        monkeypatch.setattr(mod, attr, pspy)
    return seen


# ---------------------------------------------------------------- the tower

@pytest.mark.parametrize("seq", list(SEQS))
@pytest.mark.parametrize("d", [8, 72])
def test_vision_forward_and_map_head_match_jax(kernels_seen, d, seq):
    """last_hidden_state (post-LN, every token) and the MAP-pooled output at
    1e-5; the head alone on equal tokens at 1e-5."""
    cfg = tiny_siglip(d, seq)
    tree = jax_tree(cfg)
    model = port_tower(tree, cfg)
    size = cfg.vision.image_size
    px = np.random.default_rng(1).standard_normal((2, size, size, 3)).astype(np.float32)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    last, pooled = jsiglip.vision_forward(jtree["vision_model"], jnp.asarray(px), cfg.vision)
    with torch.no_grad():
        plast, ppooled = tsiglip.vision_forward(model.vision_model, t(px),
                                                port_cfg(cfg).vision)
    assert last.shape == (2, cfg.vision.grid ** 2, 2 * d)
    _close(plast, last, msg="last")
    _close(ppooled, pooled, msg="pooled")
    kind = "flash" if seq == "L625-K5" else "short"
    assert kernels_seen["jax"] == kernels_seen["port"] == [kind] * cfg.vision.num_layers
    tokens = np.asarray(last)
    jhead = jsiglip._map_head(jtree["vision_model"]["head"], jnp.asarray(tokens), cfg.vision)
    with torch.no_grad():
        phead = tsiglip.map_head(model.vision_model.head, t(tokens), port_cfg(cfg).vision)
    _close(phead, jhead, msg="head")
    # the head's q/k/v are the row thirds of in_proj_weight: swapping two
    # thirds must change the result (the slices are really read)
    w = model.vision_model.head.attention.in_proj_weight
    with torch.no_grad():
        w.copy_(torch.cat([w[2 * d:4 * d], w[:2 * d], w[4 * d:]]))
        moved = tsiglip.map_head(model.vision_model.head, t(tokens), port_cfg(cfg).vision)
    assert np.abs(f32(moved) - np.asarray(jhead)).max() > 1e-3


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("d", [8, 72])
def test_text_forward_and_logits_match_jax(kernels_seen, d, padded):
    """The text side (no causal mask, pooled at the last position; through
    the tower attention without a mask, the einsum path with one), the
    features and ``siglip_logits`` with logit_bias, at 1e-5."""
    cfg = tiny_siglip(d)
    tree = jax_tree(cfg)
    model = port_tower(tree, cfg)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 50, (3, 12)).astype(np.int64)
    am = np.ones((3, 12), np.int64)
    if padded:
        am[1, 7:] = 0
    mask = am if padded else None
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    last, pooled = jsiglip.text_forward(jtree["text_model"], jnp.asarray(ids), cfg.text,
                                        None if mask is None else jnp.asarray(mask))
    px = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    jl = jsiglip.siglip_logits(jtree, jnp.asarray(ids), jnp.asarray(px), cfg,
                               None if mask is None else jnp.asarray(mask))
    kernels_seen["jax"].clear(), kernels_seen["port"].clear()
    with torch.no_grad():
        plast, ppooled = tsiglip.text_forward(model.text_model, t(ids), port_cfg(cfg).text,
                                              None if mask is None else t(mask))
        pl = tsiglip.siglip_logits(model, t(ids), t(px), port_cfg(cfg),
                                   None if mask is None else t(mask))
    calls = list(kernels_seen["port"])
    _close(plast, last, msg="last")
    _close(ppooled, pooled, msg="pooled")
    for ours, ref in zip(pl, jl):
        _close(ours, ref, msg="logits")
    with torch.no_grad():                                   # the bias is in
        model.logit_bias.zero_()
        unbiased = tsiglip.siglip_logits(model, t(ids), t(px), port_cfg(cfg),
                                         None if mask is None else t(mask))[0]
    np.testing.assert_allclose(f32(pl[0] - unbiased), -1.7, rtol=1e-6)
    layers = cfg.text.num_layers
    # text (twice) and vision sides take the tower attention's K2 path; a
    # masked text side the einsum path
    assert calls == ["short"] * (layers * (1 if padded else 3))
    p_feat = f32(tsiglip.get_text_features(model, t(ids), port_cfg(cfg)))
    _close(p_feat, jsiglip.get_text_features(jtree, jnp.asarray(ids), cfg), msg="features")


def test_configs_match_jax():
    """The variants, ``to_hf``/``from_hf`` and the registry's selection."""
    for name, jcfg in jsiglip.SIGLIP_VARIANTS.items():
        ours = tsiglip.SIGLIP_VARIANTS[name]
        assert dataclasses.asdict(ours) == dataclasses.asdict(jcfg), name
        assert ours.to_hf() == jcfg.to_hf()
        assert tsiglip.SiglipConfig.from_hf(ours.to_hf()) == ours
    for size in (224, 384):
        kind, cfg = registry.tower_family_and_config("siglip", size)
        jkind, jcfg = jregistry.tower_family_and_config("siglip", size)
        assert (kind, dataclasses.asdict(cfg)) == (jkind, dataclasses.asdict(jcfg))
    v = tsiglip.SIGLIP_VARIANTS["siglip-so400m-patch14-384"].vision
    assert (v.grid, v.hidden_size // v.num_heads, v.layer_norm_eps) == (27, 72, 1e-6)
    hf = {"vision_config": {k: v for k, v in jcfg.to_hf()["vision_config"].items()
                            if k not in ("layer_norm_eps", "hidden_act")},
          "text_config": {k: v for k, v in jcfg.to_hf()["text_config"].items()
                          if k not in ("max_position_embeddings", "projection_size")}}
    assert dataclasses.asdict(tsiglip.SiglipConfig.from_hf(hf)) == \
        dataclasses.asdict(jsiglip.SiglipConfig.from_hf(hf))
    meta = tsiglip.SiglipModel(tsiglip.SIGLIP_VARIANTS["siglip-so400m-patch14-384"],
                               device="meta")
    n_vision = sum(p.numel() for k, p in meta.named_parameters() if k.startswith("vision_model."))
    assert (sum(p.numel() for p in meta.parameters()), n_vision) == (877_960_498, 428_225_600)


def test_image_conditioning_matches_jax():
    """``image_conditioning("siglip")``: SigLIP's (0.5, 0.5) statistics, the
    MAP-pooled class token through both projectors, at 1e-5."""
    cfg = tiny_siglip(72, layers=1)
    js = jimage.TaskSpec(stage="stage1", tower_kind="siglip", img_size=32, clip_image_size=32,
                         dit_cfg=TINY_DIT, vae_cfg=TINY_VAE, tower_cfg=cfg, clip_dim=24,
                         t5_dim=32, compute_dtype=jnp.float32)
    assert js.tower_hidden == port_spec(js).tower_hidden == 144
    params = jax.device_get(jimage.init_modules(jax.random.key(0), js))
    mods = timage.build_modules(port_spec(js))
    load_jax_params(mods, params)
    assert isinstance(mods["clip"]["model"], tsiglip.SiglipVisionTower)
    assert tuple(mods["clip"]["project_t5"].state_dict()["1.weight"].shape) == (32, 144)
    px = np.random.default_rng(12).random((2, 32, 32, 3), dtype=np.float32)
    ref = jcond.image_conditioning("siglip", params["clip"], jnp.asarray(px), cfg,
                                   js.latent_hw, compute_dtype=jnp.float32)
    with torch.no_grad():
        got = tcond.image_conditioning("siglip", mods["clip"], t(px), port_cfg(cfg),
                                       js.latent_hw, compute_dtype=torch.float32)
    assert sorted(got) == sorted(ref)
    for k in ref:
        _close(got[k], ref[k], msg=k)
    assert tcond.tower_stats("siglip") == jcond.tower_stats("siglip") == ((0.5,) * 3,) * 2
    with torch.no_grad():
        pooled, tokens = tcond.tower_features("siglip", mods["clip"], t(px * 2 - 1),
                                              port_cfg(cfg))
    jp, jt = jcond.tower_features("siglip", params["clip"], jnp.asarray(px * 2 - 1), cfg)
    _close(pooled, jp), _close(tokens, jt)
    assert tuple(tokens.shape) == (2, 64, 144)             # every token, no CLS


# ---------------------------------------------------------------- training

STEP_TOWER = tiny_siglip(8, layers=1)
STAGES = ("stage1", "stage2_all", "stage2_only")


def _specs(stage):
    js = jimage.TaskSpec(stage=stage, tower_kind="siglip", img_size=32, clip_image_size=32,
                         dit_cfg=jdit.DIT_CONFIGS["flux-debug"],
                         vae_cfg=jvae.VAE_CONFIGS["flux-debug"], tower_cfg=STEP_TOWER,
                         clip_dim=768, t5_dim=4096, compute_dtype=jnp.float32,
                         dit_param_dtype=jnp.float32, vae_dtype=jnp.float32,
                         lora_targets=jlora.SIGLIP_TARGETS, **LORA)
    ps = dataclasses.replace(port_spec(js), stage=stage, vae_dtype=torch.float32,
                             lora_targets=lora.SIGLIP_TARGETS, **LORA)
    return js, ps


@pytest.fixture(scope="module")
def jax_init():
    """JAX ``init_modules`` of the stage-1 and the stage-2 spec (the same
    key: equal DiT, VAE, projectors and tower), a nonzero B planted in
    every wrapped linear of the stage-2 tower."""
    out = {}
    for stage in ("stage1", "stage2_all"):
        js, _ = _specs(stage)
        out[stage] = jax.device_get(jimage.init_modules(jax.random.key(0), js))
    tower = out["stage2_all"]["clip"]["model"]
    rng = np.random.default_rng(4)
    for p in jlora.lora_trainable_paths(tower):
        if p.endswith(".lora_B"):
            node = _node(tower, p[: -len(".lora_B")])
            node["lora_B"] = 0.1 * rng.standard_normal(node["lora_B"].shape).astype(np.float32)
    out["stage2_only"] = out["stage2_all"]
    return out


def _jax_state(jax_init, stage, optimizer):
    js, _ = _specs(stage)
    modules = jax.tree_util.tree_map(jnp.asarray, jax_init[stage])
    return jstate.create_state(modules, jimage.trainable_predicate(js, modules), optimizer)


def _port_state(jax_init, stage, optimizer):
    _, ps = _specs(stage)
    mods = timage.init_modules(ps, torch.Generator().manual_seed(0))
    load_jax_params(mods, {k: jax_init[stage][k] for k in ("dit", "vae", "clip")})
    return timage.create_state(mods, timage.trainable_predicate(ps, mods), optimizer)


def _mask_shapes(cfg, b):
    """The input shape of each LoRA-wrapped call of the vision forward, in
    call order: six per layer, then the head's out_proj, fc1 and fc2 on the
    probe's one row (its q, k, v are not wrapped)."""
    v = cfg.vision
    l, h, i = v.grid ** 2, v.hidden_size, v.intermediate_size
    return ([(b, l, h)] * 5 + [(b, l, i)]) * v.num_layers + [(b, 1, h), (b, 1, h), (b, 1, i)]


def _jax_draws(js, key, b):
    """The draws JAX's loss makes from ``key``, as torch tensors."""
    k_vae, k_t, k_noise, k_drop = jax.random.split(key, 4)
    h, w = js.latent_hw
    z = js.vae_cfg.z_channels
    draws = {"t": t(np.asarray(jflow.sample_timesteps(k_t, b, js.scale_factor))),
             "x0": t(np.asarray(jax.random.normal(k_noise, (b, (h // 2) * (w // 2), 4 * z)))),
             "vae_noise": t(np.asarray(jax.random.normal(k_vae, (b, h, w, z))))}
    if js.stage != "stage1":
        keep = 1.0 - js.lora_dropout
        draws["lora_masks"] = [
            t(np.asarray(jax.random.bernoulli(jax.random.fold_in(k_drop, i + 1), keep, s)))
            for i, s in enumerate(_mask_shapes(js.tower_cfg, b))]
    return draws


def test_dropout_call_order_at_full_depth():
    """165 masks per so400m vision forward: 27 x 6, then the head's three."""
    cfg = jsiglip.SIGLIP_VARIANTS["siglip-so400m-patch14-384"]
    shapes = _mask_shapes(cfg, 16)
    assert len(shapes) == 165 and shapes[-3:] == [(16, 1, 1152), (16, 1, 1152),
                                                  (16, 1, 4304)]
    assert shapes[0] == (16, 729, 1152)


@pytest.mark.parametrize("stage", STAGES)
def test_trainable_set_matches_jax(jax_init, stage):
    js, _ = _specs(stage)
    jst = _jax_state(jax_init, stage, joptim.make_optimizer(dict(HYPER)))
    state = _port_state(jax_init, stage, optim.make_optimizer(dict(HYPER)))
    assert {_port_name(k) for k in jst.trainable} == set(state.trainable)
    tower = {k for k in state.trainable if k.startswith("clip.model.")}
    # 6 linears per layer on each side and the head's three, all with a bias
    assert len(tower) == (0 if stage == "stage1" else 3 * (6 + 3 + 6))
    assert not any(".head.attention.in_proj" in k or k.startswith("clip.model.text_model.head")
                   for k in state.trainable)


@pytest.mark.parametrize("stage", STAGES)
def test_accumulation_step_matches_jax(jax_init, stage):
    """Loss, grads (the stage-2 text side's zero) of one accumulation-2 step
    on the flux-debug DiT, then the params after the chain's update."""
    js, ps = _specs(stage)
    jopt = joptim.make_optimizer(dict(HYPER))
    jst = _jax_state(jax_init, stage, jopt)
    jloss = jimage.make_loss_fn(js)
    imgs = np.random.default_rng(3).random((2, 2, 32, 32, 3), dtype=np.float32)
    key = jax.random.key(11)
    keys = jax.random.split(key, 2)
    jgrads = None
    for i in range(2):             # make_accum_train_step's micro_grads, eagerly
        _, g = jax.value_and_grad(
            lambda tp: jloss(tp, jst.frozen, {"image": jnp.asarray(imgs[i])}, keys[i]) * 0.5
        )(jst.trainable)
        jgrads = g if jgrads is None else jax.tree_util.tree_map(jnp.add, jgrads, g)
    new_jst, jm = jstep.make_accum_train_step(jloss, jopt, 2)(
        jst, {"image": jnp.asarray(imgs)}, key)

    rec = _Recorder(optim.make_optimizer(dict(HYPER)))
    state = _port_state(jax_init, stage, rec)
    step = make_accum_train_step(timage.make_loss_fn(ps), rec, 2)
    state, m = step(state, {"image": t(imgs)}, None, [_jax_draws(js, keys[i], 2)
                                                        for i in range(2)])
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
    text = [k for k in jgrads if k.startswith("clip.model.text_model.")]
    assert len(text) == (0 if stage == "stage1" else 3 * 6)
    tower_max = max([np.abs(np.asarray(g)).max() for k, g in jgrads.items()
                     if k.startswith("clip.model.")] or [0.0])
    for k, g in jgrads.items():
        ours, ref = f32(rec.grads[_port_name(k)]), np.asarray(g, np.float32)
        if k in text:
            assert not ref.any() and not ours.any(), k
            continue
        if k.endswith("self_attn.k_proj.bias"):     # 0 but for roundoff
            assert max(np.abs(ours).max(), np.abs(ref).max()) <= 1e-4 * tower_max, k
            continue
        assert np.abs(ref).max() > 0, k
        rel = 1e-3 if k in ("dit.time_in.in_layer.weight", "dit.guidance_in.in_layer.weight") \
            else 1e-4
        assert np.abs(ours - ref).max() <= rel * np.abs(ref).max(), k
    bound = 2 * LR * (1 + 1e-3)
    for k, v in new_jst.trainable.items():
        assert np.abs(f32(state.trainable[_port_name(k)]) - np.asarray(v, np.float32)).max() \
            <= bound, k
    assert state.step == 1


def test_int8_siglip_tower_raises():
    """No longer raises: the int8 SigLIP tower is ported (its parity:
    tests/test_torch_siglip_int8.py); the head's packed q/k/v stays float."""
    from genhancer_tpu_torch.core import quant as tquant
    _, ps = _specs("stage1")
    timage.init_modules(dataclasses.replace(ps, tower_quant="int8"), torch.Generator())
    mods = timage.init_modules(ps, torch.Generator())
    tquant.quantize_linear_tree(mods["clip"]["model"], min_features=1)
    head = mods["clip"]["model"].vision_model.head
    assert isinstance(head.attention.out_proj, tnn_port.Int8Layer)
    assert head.attention.in_proj_weight.dtype == torch.float32


# ---------------------------------------------------------------- HF files

def _write_hf_dir(path, tree, cfg, scalar_shape=()):
    """What the JAX package writes for a SigLIP tower: ``tower_to_torch`` +
    ``to_hf``; ``scalar_shape`` (1,) gives logit_scale/bias HF's shape."""
    sd = hf_convert.tower_to_torch(tree)
    for k in ("logit_scale", "logit_bias"):
        sd[k] = np.asarray(sd[k]).reshape(scalar_shape)
    save_torch_state_dict(sd, os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg.to_hf(), f)
    return sd


@pytest.mark.parametrize("scalar_shape", [(), (1,)])
def test_a_jax_written_directory_loads_in_both_packages(tmp_path, scalar_shape):
    """Equal tensors (the port's logit_scale/bias 0-d either way), equal
    image and text features (1e-5 against JAX's loader, the vision-only
    tower bit for bit against the whole)."""
    cfg = tiny_siglip(72)
    tree = jax_tree(cfg)
    sd = _write_hf_dir(str(tmp_path), tree, cfg, scalar_shape)
    ours, pcfg = registry.load_tower("siglip", None, str(tmp_path))
    vision, _ = registry.load_tower("siglip", None, str(tmp_path), text_side=False)
    jtree, jcfg = jregistry.load_tower("siglip", None, str(tmp_path))
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert isinstance(ours, tsiglip.SiglipModel) and isinstance(vision,
                                                                tsiglip.SiglipVisionTower)
    got = ours.state_dict()
    assert set(got) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(f32(got[k]), np.asarray(v, np.float32).reshape(
            got[k].shape), err_msg=k)
    assert got["logit_bias"].shape == () and got["logit_bias"].item() == np.float32(-1.7)
    rng = np.random.default_rng(5)
    px = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(0, 50, (2, 12)).astype(np.int64)
    with torch.no_grad():
        img = tsiglip.get_image_features(ours, t(px), pcfg)
        txt = tsiglip.get_text_features(ours, t(ids), pcfg)
        img_v = tsiglip.get_image_features(vision, t(px), pcfg)
    jt = jax.tree_util.tree_map(jnp.asarray, jtree)
    _close(img, jsiglip.get_image_features(jt, jnp.asarray(px), jcfg))
    _close(txt, jsiglip.get_text_features(jt, jnp.asarray(ids), jcfg))
    assert torch.equal(img, img_v)


def test_export_matches_jax(jax_init, tmp_path):
    """``export_hf_tower`` of a stage-2 state against ``tower_to_torch`` of
    the JAX ``merge``: the same keys, values at 1e-6, ``config.json`` =
    ``SiglipConfig.to_hf``."""
    js, ps = _specs("stage2_all")
    state = _port_state(jax_init, "stage2_all", optim.make_optimizer(dict(HYPER)))
    out = ckpt.export_hf_tower(state, str(tmp_path / "export"),
                               base_config=ps.tower_cfg.to_hf())
    got = torch.load(os.path.join(out, "pytorch_model.bin"), weights_only=True)
    ref = hf_convert.tower_to_torch(jlora.merge(jax_init["stage2_all"]["clip"]["model"]))
    assert set(got) == set(ref)
    for k, v in ref.items():
        v = np.asarray(v, np.float32)
        assert tuple(got[k].shape) == v.shape, k
        np.testing.assert_allclose(f32(got[k]), v, rtol=1e-6,
                                   atol=1e-6 * max(np.abs(v).max(), 1e-30), err_msg=k)
    with open(os.path.join(out, "config.json")) as f:
        assert json.load(f) == js.tower_cfg.to_hf() == ps.tower_cfg.to_hf()


@pytest.fixture
def tiny_siglip_models(monkeypatch):
    monkeypatch.setattr(registry, "build_dit_config", lambda name: port_cfg(TINY_DIT))
    monkeypatch.setattr(registry, "build_vae_config",
                        lambda name, ae_path=None: port_cfg(TINY_VAE))
    monkeypatch.setattr(registry, "tower_family_and_config",
                        lambda tower, size, clip_type=None: ("siglip", port_cfg(STEP_TOWER)))


def test_trainer_from_stage1_through_the_siglip_export(tiny_siglip_models, tmp_path, shards):
    """``tower: siglip``: stage 1 writes step 2; ``stage2_all`` loads it,
    trains 2 steps and writes ``siglip-so400m-patch14-{size}-{step}/`` at
    each; the port's ``load_tower`` reads it back to the merged tower's
    pooled features bit for bit, JAX's to them at 1e-5; an engine serves
    the stage-1 files (embed: the MAP-pooled [n, hidden])."""
    s1 = Trainer(write_cfg(tmp_path, shards, tower="siglip", max_train_steps=2), device="cpu")
    s1.train()
    assert isinstance(s1.state.modules["clip"]["model"], tsiglip.SiglipVisionTower)
    cfg = write_cfg(tmp_path, shards, tower="siglip", task="image_stage2_all",
                    load_dir=s1.cfg["output_dir"], load_step=2, checkpointing_steps=1,
                    output_dir=str(tmp_path / "out2"), max_train_steps=2,
                    lora_config={"r": 4, "lora_alpha": 16, "lora_dropout": 0.1})
    trainer = Trainer(cfg, device="cpu")
    assert trainer.spec.lora_targets == lora.SIGLIP_TARGETS
    assert len(lora.wrapped_paths(trainer.state.modules["clip"]["model"])) == 6 + 3 + 6
    assert trainer.train()["step"] == 2
    for s in (1, 2):
        assert hf_export_name(cfg, s) == jax_export_name(cfg, s) == \
            f"siglip-so400m-patch14-32-{s}"
    export = os.path.join(cfg["output_dir"], hf_export_name(cfg, 2))
    assert sorted(os.listdir(export)) == ["config.json", "pytorch_model.bin"]
    spec = trainer.spec
    loaded, lcfg = registry.load_tower("siglip", spec.tower_cfg, export)
    assert lcfg == spec.tower_cfg
    merged = lora.merge(trainer.state.modules["clip"]["model"])
    px = np.random.default_rng(8).random((2, 32, 32, 3), dtype=np.float32)
    with torch.no_grad():
        a = tcond.tower_features("siglip", {"model": loaded}, t(px), spec.tower_cfg)[0]
        b = tcond.tower_features("siglip", {"model": merged}, t(px), spec.tower_cfg)[0]
    assert torch.equal(a, b)
    jtree, jcfg = jregistry.load_tower("siglip", None, export)
    jp = jcond.tower_features("siglip", {"model": jtree}, jnp.asarray(px), jcfg)[0]
    _close(a, jp)

    engine = InferenceEngine.from_config(write_cfg(tmp_path, shards, tower="siglip"),
                                         device="cpu", load_dir=s1.cfg["output_dir"],
                                         load_step=2, buckets=(2,), num_steps=2)
    emb = engine.embed(px)
    with torch.no_grad():
        px_n = tcond.normalize(t(px), *tcond.tower_stats("siglip"))
        want = tcond.tower_features("siglip", engine.modules["clip"],
                                    px_n.to(engine.spec.compute_dtype),
                                    engine.spec.tower_cfg)[0].to(torch.float32)
    assert emb.shape == (2, STEP_TOWER.vision.hidden_size)
    np.testing.assert_array_equal(emb, f32(want))
    rec = engine.reconstruct(px, seed=0)
    assert rec.shape == px.shape and np.isfinite(rec).all()


# ---------------------------------------------------------------- the eval

def test_evaluate_model_dir_matches_jax(tmp_path, monkeypatch):
    """Both packages' ``evaluate_model_dir`` on one JAX-written SigLIP
    directory, one synthetic benchmark and the same token ids: the same
    results and CSV rows (scores 1e-5); the preprocessing (a straight
    bicubic resize, mean/std 0.5) bit for bit; the CLI prints the same."""
    cfg = tiny_siglip(8)
    _write_hf_dir(str(tmp_path / "tower"), jax_tree(cfg), cfg)
    bench = write_benchmark(str(tmp_path / "mmvp"), size=40)
    tok = lambda texts: fake_tokenize(texts, length=12)           # noqa: E731
    monkeypatch.setattr(mmvp, "default_tokenizer", lambda d, k: tok)
    monkeypatch.setattr(jmmvp, "default_tokenizer", lambda d, k: tok)
    ours = mmvp.evaluate_model_dir(str(tmp_path / "tower"), bench, tower="siglip",
                                   clip_image_size=384, results_csv=str(tmp_path / "o.csv"),
                                   device="cpu")
    ref = jmmvp.evaluate_model_dir(str(tmp_path / "tower"), bench, tower="siglip",
                                   clip_image_size=384, results_csv=str(tmp_path / "r.csv"))
    assert sorted(ours) == sorted(mmvp.CATEGORIES + ["average_score"])
    assert_same_results(ours, ref, str(tmp_path / "o.csv"), str(tmp_path / "r.csv"))
    pair = mmvp.load_pairs(bench)[0]
    got = mmvp.preprocess_image(pair.img1, "siglip", 32)
    np.testing.assert_array_equal(got, jmmvp.preprocess_image(pair.img1, "siglip", 32))
    assert got.shape == (32, 32, 3) and got.min() >= -1.0 and got.max() <= 1.0
    printed = cli_evaluate.main(["--benchmark_dir", bench, "--model_dir",
                                 str(tmp_path / "tower"), "--tower", "siglip",
                                 "--clip_image_size", "384", "--device", "cpu",
                                 "--results_csv", str(tmp_path / "cli.csv")])
    assert printed == ours


def test_default_tokenizer_pads_siglip_to_64_without_a_mask(monkeypatch):
    """Through a stand-in ``transformers.AutoTokenizer`` (nothing is
    downloaded): SigLIP pads to 64 tokens, CLIP to 77; no mask either way."""
    calls = []

    class FakeTokenizer:
        def __call__(self, texts, **kw):
            calls.append(kw)
            return {"input_ids": np.zeros((len(texts), kw["max_length"]), np.int64),
                    "attention_mask": np.ones((len(texts), kw["max_length"]), np.int64)}

    fake = types.ModuleType("transformers")
    fake.AutoTokenizer = types.SimpleNamespace(from_pretrained=lambda d: FakeTokenizer())
    monkeypatch.setitem(sys.modules, "transformers", fake)
    for kind, length in (("siglip", 64), ("clip", 77)):
        ids, mask = mmvp.default_tokenizer("/nowhere", kind)(["a photo of x", "y"])
        assert ids.shape == (2, length) and mask is None
        assert calls[-1] == dict(padding="max_length", truncation=True, max_length=length,
                                 return_tensors="np")
