"""The stage-1 training step of the port against the JAX package
(genhancer_tpu/tasks/image.py, genhancer_tpu/train/step_utils.py) on a tiny
spec, with the JAX package's own random draws injected on the port side
(``k_vae, k_t, k_noise, _ = split(key, 4)``, image.py:210).

Bounds: the float32 loss within 1e-5 relative; the bfloat16 loss within
2e-2 relative (bf16 VAE convs, DiT matmuls and attention round at places
that differ between XLA and torch); the grads of one accumulation-2 step
within 1e-4 of the leaf's largest gradient (float32: summation order and
XLA's fusions), except the two layers fed by the sinusoidal timestep and
guidance embeddings (``time_in``/``guidance_in.in_layer.weight``): their
inputs are float32 sin/cos at arguments up to 4000 rad, where XLA's and
torch's implementations differ by 1.2e-4 relative, so 1e-3 there; the
params after one step within 2*lr*(1 + 1e-3) absolute
— AdamW's first update is about lr*sign(g) per element, so a near-zero
gradient whose sign differs between the two packages moves a parameter by
up to 2*lr.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genhancer_tpu.tasks import image as jimage
from genhancer_tpu.train import flow as jflow
from genhancer_tpu.train import optim as joptim
from genhancer_tpu.train import state as jstate
from genhancer_tpu.train import step_utils as jstep
from genhancer_tpu_torch.tasks import image as timage
from genhancer_tpu_torch.train import optim
from genhancer_tpu_torch.train.step_utils import make_accum_train_step
from genhancer_tpu_torch.weights.convert import _dit_name, load_jax_params

from test_torch_parity import f32, jax_spec, port_spec, t

torch.set_num_threads(1)

LR = 1e-3
HYPER = dict(learning_rate=LR, lr_scheduler="constant", max_train_steps=10)


def _specs(dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    js = dataclasses.replace(jax_spec(compute_dtype=jdt, dit_param_dtype=jdt), vae_dtype=jdt)
    ps = dataclasses.replace(port_spec(js),
                             vae_dtype=torch.float32 if dtype == "float32" else torch.bfloat16)
    return js, ps


def _port_name(path: str) -> str:
    return "dit." + _dit_name(path[4:]) if path.startswith("dit.") else path


@pytest.fixture(scope="module")
def jax_init():
    """One float32 JAX init for the file (the first eager JAX calls compile)."""
    js, _ = _specs("float32")
    modules = jimage.init_modules(jax.random.key(0), js)
    return modules, jax.device_get({k: modules[k] for k in ("dit", "vae", "clip")})


def _jax_state(jax_init, dtype, optimizer):
    """The stage-1 JAX state of the shared init; bf16 casts the DiT, as
    init_modules does for dit_param_dtype=bf16."""
    js, _ = _specs(dtype)
    modules, _ = jax_init
    if dtype == "bfloat16":
        modules = dict(modules, dit=jax.tree_util.tree_map(
            lambda x: x.astype(jnp.bfloat16), modules["dit"]))
    return jstate.create_state(modules, jimage.trainable_predicate(js, modules), optimizer)


def _port_state(jax_init, dtype, optimizer):
    _, ps = _specs(dtype)
    mods = timage.build_modules(ps)
    load_jax_params(mods, jax_init[1])
    return timage.create_state(mods, timage.trainable_predicate(ps), optimizer)


def _jax_draws(js, key, b):
    """The draws JAX's loss makes from ``key``, as torch tensors."""
    k_vae, k_t, k_noise, _ = jax.random.split(key, 4)
    h, w = js.latent_hw
    z = js.vae_cfg.z_channels
    return {"t": t(np.asarray(jflow.sample_timesteps(k_t, b, js.scale_factor))),
            "x0": t(np.asarray(jax.random.normal(k_noise, (b, (h // 2) * (w // 2), 4 * z)))),
            "vae_noise": t(np.asarray(jax.random.normal(k_vae, (b, h, w, z))))}


def _images(n, b=2):
    return np.random.default_rng(3).random((n, b, 32, 32, 3), dtype=np.float32)


def test_trainable_predicate_selects_the_jax_set(jax_init):
    js, _ = _specs("float32")
    modules, _ = jax_init
    jtrain, _ = jstate.partition(modules, jimage.trainable_predicate(js, modules))
    state = _port_state(jax_init, "float32", optim.make_optimizer(dict(HYPER)))
    assert {_port_name(k) for k in jtrain} == set(state.trainable)
    assert all(p.requires_grad for p in state.trainable.values())
    assert not any(p.requires_grad for p in state.frozen.values())
    assert any(k.startswith("clip.model.") for k in state.frozen)
    assert any(k.startswith("vae.") for k in state.frozen)


@pytest.mark.parametrize("dtype, rtol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_loss_matches_jax(jax_init, dtype, rtol):
    js, ps = _specs(dtype)
    jst = _jax_state(jax_init, dtype, joptim.make_optimizer(dict(HYPER)))
    key = jax.random.key(7)
    imgs = _images(1)[0]
    ref = float(jimage.make_loss_fn(js)(jst.trainable, jst.frozen,
                                        {"image": jnp.asarray(imgs)}, key))
    state = _port_state(jax_init, dtype, optim.make_optimizer(dict(HYPER)))
    ours = timage.make_loss_fn(ps)(state.modules, {"image": t(imgs)}, None,
                                   _jax_draws(js, key, 2)).item()
    assert abs(ours - ref) <= rtol * abs(ref), (ours, ref)


class _Recorder:
    """Delegates to an optimizer and keeps the grads it was given."""

    def __init__(self, inner):
        self.inner, self.grads = inner, None

    def init(self, params):
        return self.inner.init(params)

    def apply(self, params, grads, state):
        self.grads = {k: g.detach().clone() for k, g in grads.items()}
        return self.inner.apply(params, grads, state)


@pytest.mark.parametrize("fused", [None, "pallas"])
def test_accumulation_step_matches_jax(jax_init, fused):
    """Grads of one accumulation-2 step (f32 accumulators), then the params
    after the chain's or K3's (plain version's) update."""
    js, ps = _specs("float32")
    cfg = dict(HYPER, fused_optimizer=fused)
    jopt = joptim.make_optimizer(cfg)
    jst = _jax_state(jax_init, "float32", jopt)
    jloss = jimage.make_loss_fn(js)
    imgs = _images(2)
    key = jax.random.key(11)
    keys = jax.random.split(key, 2)
    jgrads = None
    for i in range(2):             # make_accum_train_step's micro_grads, eagerly
        _, g = jax.value_and_grad(
            lambda tp: jloss(tp, jst.frozen, {"image": jnp.asarray(imgs[i])}, keys[i]) * 0.5
        )(jst.trainable)
        jgrads = g if jgrads is None else jax.tree_util.tree_map(jnp.add, jgrads, g)
    before = {k: np.asarray(v) for k, v in jst.trainable.items()}
    new_jst, jm = jstep.make_accum_train_step(jloss, jopt, 2)(
        jst, {"image": jnp.asarray(imgs)}, key)

    rec = _Recorder(optim.make_optimizer(cfg))
    state = _port_state(jax_init, "float32", rec)
    step = make_accum_train_step(timage.make_loss_fn(ps), rec, 2)
    draws = [_jax_draws(js, keys[i], 2) for i in range(2)]
    state, m = step(state, {"image": t(imgs)}, None, draws)

    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
    assert state.step == 1 and state.opt_state["count"] == 1
    for k, g in jgrads.items():
        ours, ref = f32(rec.grads[_port_name(k)]), np.asarray(g, np.float32)
        rel = 1e-3 if k in ("dit.time_in.in_layer.weight", "dit.guidance_in.in_layer.weight") \
            else 1e-4
        assert np.abs(ours - ref).max() <= rel * max(np.abs(ref).max(), 1e-30), k
    bound = 2 * LR * (1 + 1e-3)
    moved = 0.0
    for k, v in new_jst.trainable.items():
        ours = f32(state.trainable[_port_name(k)])
        assert np.abs(ours - np.asarray(v, np.float32)).max() <= bound, k
        moved = max(moved, np.abs(np.asarray(v, np.float32) - before[k]).max())
    assert moved > 0.5 * LR          # the step did move the params


def test_unported_options_raise():
    js, ps = _specs("float32")
    # remat is ported (tests/test_torch_remat_policy.py)
    timage.make_loss_fn(dataclasses.replace(ps, remat=True, remat_policy="dots"))
    # the int8 stack is ported (tests/test_torch_int8_step.py); only an
    # unknown dit_quant is refused
    with pytest.raises(ValueError, match="dit_quant"):
        timage.make_loss_fn(dataclasses.replace(ps, dit_quant="int4"))
    # stage 2 and QLoRA are ported (tests/test_torch_stage2.py,
    # tests/test_torch_qlora.py)
    timage.make_loss_fn(dataclasses.replace(ps, stage="stage2_all", tower_quant="int8"))
    # and the features cache: {moments, cls} made from the frozen VAE and
    # tower gives the inline loss under the same draws
    from genhancer_tpu_torch.models import vae as tvae
    from genhancer_tpu_torch.tasks.conditioning import (VAE_MEAN, VAE_STD, normalize,
                                                        tower_features, tower_stats)
    mods = timage.init_modules(ps, torch.Generator().manual_seed(2))
    imgs = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(3))
    key = jax.random.key(5)
    draws = _jax_draws(js, key, 2)
    loss_fn = timage.make_loss_fn(ps)
    with torch.no_grad():
        moments = tvae.encoder_forward(mods["vae"].encoder, ps.vae_cfg,
                                       normalize(imgs, VAE_MEAN, VAE_STD).to(ps.vae_dtype))
        cls, _ = tower_features("clip", mods["clip"], normalize(imgs, *tower_stats("clip")),
                                ps.tower_cfg)
        inline = loss_fn(mods, {"image": imgs}, None, draws).item()
        cached = loss_fn(mods, {"moments": moments.float(), "cls": cls.float()}, None,
                         draws).item()
    assert cached == pytest.approx(inline, rel=1e-6)
