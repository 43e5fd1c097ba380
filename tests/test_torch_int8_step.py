"""The int8 stage-1 step of ``configs/tpu_fast_stage1.yaml`` in the port
against the JAX package, on a tiny spec, and the port's trainer on that
config end to end on the CPU.

The spec is cut to a DiT of hidden 512 (its large linears reach the
SwitchBack threshold of 512), a tower of hidden 64 (its linears reach the
tower's 64) and the tiny VAE with ``vae_quant_min_ch`` lowered to 8, as the
JAX tests do, all in float32.  Weights come from a JAX init (int8 trees
included) through ``weights/convert.py``; the JAX package's own draws are
injected.  The JAX step runs eagerly, its Pallas kernels (K4, K6, K8) in
interpret mode.

Bounds, each with its reason:
  * loss within 1e-4 relative;
  * every SwitchBack call of the composed step, on the inputs it was given
    there, against the JAX function the JAX step runs for that layer
    (``switchback_linear_full_cached`` or ``switchback_linear_cached_dw``):
    output, dx and dW within 1e-5 of max|JAX| (exact codes and int32 sums;
    float32 dequantization and dW sums in another order).  The calls cover
    exactly the cached layers, each read the cache buffer the optimizer
    writes, holding the codes of the JAX cache, with the config's dW kind.
    This is what holds the composition (dispatch, cache read, dW kind):
    controls on the same inputs — the float32 dW of ``dit_quant: int8`` and
    an unquantized forward — must miss the 1e-5 bound;
  * the gradients of one step within 5e-2 of each leaf's largest gradient
    and 5e-2 norm-wise: the int8 forward is chaotic between two
    implementations.  A float32 rounding difference upstream flips one code
    (1 of 65536 in the DiT's first SwitchBack input here), the flip moves
    every output of its row by a fraction of a code step, and the next
    layer's quantization flips more: by the single block 10% of the codes
    differ, by up to 4 steps.  Once the codes have decorrelated the two
    packages differ by the int8 quantization noise itself — measured 3.1%
    at the worst leaf (max) and 3.1% (norm), 1-2% typical;
  * params after the step within 2*lr*(1 + 1e-3): AdamW's first update is
    about lr*sign(g), and a near-zero gradient's sign may differ;
  * the emitted int8 weight cache: codes within one at a rate below 1e-3
    and scales within 2*lr/127 absolute (a parameter up to 2*lr away may
    cross a code boundary, and a row's amax move by 2*lr).  lr is 1e-6,
    below a code step of these weights (about 6e-4), so that a gradient
    sign that differs flips a code only at a boundary.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from genhancer_tpu.core import quant as jq
from genhancer_tpu.core.pallas import adamw as jadamw
from genhancer_tpu.core.pallas import int8_dw as jdw
from genhancer_tpu.models import dit as jdit
from genhancer_tpu.tasks import image as jimage
from genhancer_tpu.train import optim as joptim
from genhancer_tpu.train import state as jstate
from genhancer_tpu_torch import registry
from genhancer_tpu_torch.core import nn as tnn_port
from genhancer_tpu_torch.core import quant as tq
from genhancer_tpu_torch.core.kernels import adamw as KA
from genhancer_tpu_torch.data import testing
from genhancer_tpu_torch.tasks import image as timage
from genhancer_tpu_torch.train import checkpoint as ckpt
from genhancer_tpu_torch.train import optim
from genhancer_tpu_torch.train.config import load_config
from genhancer_tpu_torch.train.state import with_quant_cache
from genhancer_tpu_torch.train.trainer import Trainer
from genhancer_tpu_torch.weights.convert import load_jax_params

from test_torch_parity import TINY_TOWER, TINY_VAE, f32, port_cfg, port_spec, t
from test_torch_train_step import _jax_draws, _port_name

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-6
INT8_DIT = jdit.DiTConfig(in_channels=16, vec_in_dim=24, context_in_dim=32, hidden_size=512,
                          num_heads=4, depth=1, depth_single_blocks=1, axes_dim=(32, 48, 48))
INT8_TOWER = dataclasses.replace(
    TINY_TOWER, vision=dataclasses.replace(TINY_TOWER.vision, hidden_size=64,
                                           intermediate_size=128),
    projection_dim=64)
# (dit_quant, optimizer_moment_bits): the config as published, and the
# variant that reaches K8 and K6
VARIANTS = [("int8_full", 16), ("int8_dw", 8)]
# the port's dW kind and the JAX function of a cached SwitchBack layer
SWITCHBACK = {"int8_full": ("cols", jq.switchback_linear_full_cached),
              "int8_dw": ("int8_dw", jq.switchback_linear_cached_dw)}
LAYER_REL = 1e-5


def _specs(dit_quant):
    quant = dict(tower_quant="int8", vae_quant="int8", vae_quant_min_ch=8,
                 dit_quant=dit_quant, dit_quant_cache=True)
    js = jimage.TaskSpec(stage="stage1", tower_kind="clip", img_size=32, clip_image_size=32,
                         dit_cfg=INT8_DIT, vae_cfg=TINY_VAE, tower_cfg=INT8_TOWER,
                         clip_dim=24, t5_dim=32, compute_dtype=jnp.float32,
                         dit_param_dtype=jnp.float32, vae_dtype=jnp.float32, **quant)
    ps = dataclasses.replace(port_spec(js), vae_dtype=torch.float32, **quant)
    return js, ps


def _cfg(bits):
    return dict(learning_rate=LR, lr_scheduler="constant", max_train_steps=10,
                fused_optimizer="pallas", optimizer_moment_bits=bits)


@pytest.fixture(scope="module")
def jax_inits():
    """One JAX init per variant (int8 tower and VAE trees, DiT in float32)."""
    return {q: jimage.init_modules(jax.random.key(0), _specs(q)[0]) for q, _ in VARIANTS}


class _Recorder:
    """Delegates to an optimizer (its ``emit_quant`` included) and keeps the
    grads it was given."""

    def __init__(self, inner):
        self.inner, self.grads = inner, None
        self.emit_quant = inner.emit_quant

    def init(self, params):
        return self.inner.init(params)

    def apply(self, params, grads, state, **kw):
        self.grads = {k: g.detach().clone() for k, g in grads.items()}
        return self.inner.apply(params, grads, state, **kw)


class _Tap(torch.autograd.Function):
    """Identity whose backward keeps the gradient that reaches it."""

    @staticmethod
    def forward(ctx, a, rec, key):
        ctx.rec, ctx.key = rec, key
        return a.clone()

    @staticmethod
    def backward(ctx, g):
        ctx.rec[ctx.key] = g.detach().clone()
        return g, None, None


def _spy_switchback(monkeypatch, names):
    """Record every SwitchBack call of the composed model: the weight's flat
    path (``names``: data pointer -> path), the inputs, the cache it read
    (its codes and its buffer's address), the dW kind and the output; the
    backward adds the gradient g that reached the output and the dx and dW
    the call returned."""
    calls, orig = [], tq.switchback

    def spy(x, w, wq=None, ws=None, dw="bf16"):
        rec = dict(path=names.get(w.data_ptr()), x=x.detach().clone(), w=w.detach().clone(),
                   dw_kind=dw, wq_ptr=None if wq is None else wq.data_ptr(),
                   wq=None if wq is None else wq.clone(), ws=None if ws is None else ws.clone())
        y = orig(_Tap.apply(x, rec, "dx"), _Tap.apply(w, rec, "dW"), wq, ws, dw)
        rec["y"] = y.detach().clone()
        calls.append(rec)
        return _Tap.apply(y, rec, "g")

    monkeypatch.setattr(tq, "switchback", spy)
    return calls


def _rel(ours, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(f32(ours) - ref).max() / max(np.abs(ref).max(), 1e-30))


def _hold_switchback_layers(calls, state, jquant, dit_quant):
    """Each SwitchBack call of the port's composed step against the JAX
    function of its layer on the same inputs (``LAYER_REL``), and the
    controls that must miss that bound."""
    kind, jfn = SWITCHBACK[dit_quant]
    jquant = {_port_name(k): v for k, v in jquant.items()}
    assert sorted(c["path"] for c in calls) == sorted(state.quant) == sorted(jquant)
    for c in calls:
        path = c["path"]
        jwq, jws = (np.asarray(a) for a in jquant[path])
        assert c["dw_kind"] == kind and c["wq_ptr"] == state.quant[path][0].data_ptr(), path
        np.testing.assert_array_equal(c["wq"].numpy(), jwq)
        np.testing.assert_array_equal(c["ws"].numpy(), jws)
        x, w, g = (jnp.asarray(c[k].numpy()) for k in ("x", "w", "g"))
        y, vjp = jax.vjp(lambda a, b: jfn(a, b, jwq, jws), x, w)
        jdx, jdw_ = vjp(g)
        assert _rel(c["y"], y) <= LAYER_REL, (path, _rel(c["y"], y))
        assert _rel(c["dW"], jdw_) <= LAYER_REL, (path, _rel(c["dW"], jdw_))
        if "dx" in c:
            assert _rel(c["dx"], jdx) <= LAYER_REL, (path, _rel(c["dx"], jdx))
        # controls: the forward unquantized, and dit_quant int8's float32 dW
        # where the config's dW is int8 (int8_dw takes the float32 dW too
        # where K8 does not apply: the modulation's B rows, T < 8)
        assert _rel(c["y"], x @ w.T) > 10 * LAYER_REL, path
        if kind == "cols" or jdw.dw_supported(x.size // x.shape[-1], *w.shape):
            _, vjp_f = jax.vjp(lambda b: jq.switchback_linear_cached(x, b, jwq, jws), w)
            assert _rel(c["dW"], vjp_f(g)[0]) > 10 * LAYER_REL, path


@pytest.mark.parametrize("dit_quant,bits", VARIANTS)
def test_int8_step_matches_jax(jax_inits, monkeypatch, dit_quant, bits):
    for mod in (jadamw, jdw):
        monkeypatch.setattr(mod, "_INTERPRET", True)
    monkeypatch.setenv("GENHANCER_PALLAS_INTERPRET", "1")
    js, ps = _specs(dit_quant)
    modules = jax_inits[dit_quant]
    jopt = joptim.make_optimizer(_cfg(bits), emit_quant=True)
    jst = jstate.with_quant_cache(jstate.create_state(
        modules, jimage.trainable_predicate(js, modules), jopt))
    imgs = np.random.default_rng(3).random((2, 32, 32, 3), dtype=np.float32)
    key = jax.random.key(11)
    jloss = jimage.make_loss_fn(js)
    loss, jgrads = jax.value_and_grad(
        lambda tp: jloss(tp, jst.frozen, {"image": jnp.asarray(imgs)}, key, jst.quant)
    )(jst.trainable)
    before = {k: np.asarray(v) for k, v in jst.trainable.items()}
    new_jst = jstate.apply_gradients(jst, jgrads, jopt)

    rec = _Recorder(optim.make_optimizer(_cfg(bits), emit_quant=True))
    mods = timage.build_modules(ps)
    load_jax_params(mods, jax.device_get({k: modules[k] for k in ("dit", "vae", "clip")}))
    state = with_quant_cache(timage.create_state(mods, timage.trainable_predicate(ps), rec))
    tower, vae = mods["clip"]["model"], mods["vae"].encoder
    assert isinstance(tower.vision_model.encoder.layers[0].mlp.fc1, tnn_port.Int8Layer)
    assert isinstance(vae.mid.block_1.conv1, tnn_port.Int8Layer)
    assert set(state.quant) == {_port_name(k) for k in jst.quant}
    for k, (wq, ws) in jst.quant.items():     # the first step's cache: quantize_weight
        assert torch.equal(state.quant[_port_name(k)][0], t(np.asarray(wq)))
        assert torch.equal(state.quant[_port_name(k)][1], t(np.asarray(ws)))
    if bits == 8:
        assert any(isinstance(m, KA.Moment8) for m in state.opt_state["mu"].values())
    calls = _spy_switchback(monkeypatch, {p.data_ptr(): k for k, p in state.trainable.items()})
    state, m = timage.make_train_step(ps, rec)(state, {"image": t(imgs)}, None,
                                                _jax_draws(js, key, 2))
    _hold_switchback_layers(calls, state, jst.quant, dit_quant)

    assert abs(m["loss"].item() - float(loss)) <= 1e-4 * abs(float(loss))
    for k, g in jgrads.items():
        ours, ref = f32(rec.grads[_port_name(k)]), np.asarray(g, np.float32)
        assert np.abs(ours - ref).max() <= 5e-2 * max(np.abs(ref).max(), 1e-30), k
        assert np.linalg.norm(ours - ref) <= 5e-2 * max(np.linalg.norm(ref), 1e-30), k
    bound = 2 * LR * (1 + 1e-3)
    moved = 0.0
    for k, v in new_jst.trainable.items():
        ours = f32(state.trainable[_port_name(k)])
        assert np.abs(ours - np.asarray(v, np.float32)).max() <= bound, k
        moved = max(moved, np.abs(np.asarray(v, np.float32) - before[k]).max())
    assert moved > 0.5 * LR
    flips, n = 0, 0
    for k, (wq, ws) in new_jst.quant.items():
        owq, ows = state.quant[_port_name(k)]
        d = np.abs(owq.numpy().astype(np.int32) - np.asarray(wq, np.int32))
        flips, n = flips + int((d > 0).sum()), n + d.size
        np.testing.assert_allclose(ows.numpy(), np.asarray(ws), rtol=0, atol=2 * LR / 127)
    assert flips / n < 1e-3, flips / n


@pytest.fixture
def int8_models(monkeypatch):
    monkeypatch.setattr(registry, "build_dit_config", lambda name: port_cfg(INT8_DIT))
    monkeypatch.setattr(registry, "build_vae_config",
                        lambda name, ae_path=None: port_cfg(TINY_VAE))
    monkeypatch.setattr(registry, "tower_family_and_config",
                        lambda tower, size, clip_type=None: ("clip", port_cfg(INT8_TOWER)))


@pytest.mark.parametrize("dit_quant,bits", VARIANTS)
def test_trainer_on_tpu_fast_config_resumes_with_the_same_cache(int8_models, tmp_path,
                                                               dit_quant, bits):
    """``configs/tpu_fast_stage1.yaml`` alone drives the int8 path: the
    trainer builds the int8 tower and VAE, the SwitchBack DiT and the fused
    optimizer that emits the cache; the ``.bin`` files hold float masters
    only, and a resume rebuilds exactly the cache the optimizer emitted."""
    shards = tmp_path / "shards"
    for i in range(2):
        testing.make_image_shard(str(shards / f"s{i}.tar"), 8, 48, seed=i)
    raw = yaml.safe_load(open(os.path.join(ROOT, "configs", "tpu_fast_stage1.yaml")))
    raw.update(output_dir=str(tmp_path / "out"), max_train_steps=2, checkpointing_steps=2,
               train_batch_size=2, report_to="none", log_interval=1, vae_quant_min_ch=8,
               dit_quant=dit_quant, optimizer_moment_bits=bits, mixed_precision="no",
               resume_from_checkpoint="latest")
    raw["data_config"].update(img_dir=str(shards), train_batch_size=2, img_size=32,
                              num_workers=1)
    raw["clip_config"].update(clip_image_size=32, clip_dim=24, t5_dim=32)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(raw))
    cfg = load_config(str(path))

    trainer = Trainer(cfg, device="cpu")
    assert trainer.optimizer.emit_quant and trainer.optimizer.moment_bits == bits
    assert trainer.state.quant and isinstance(
        trainer.state.modules["clip"]["model"].visual_projection, tnn_port.Int8Layer)
    metrics = trainer.train()
    assert metrics["step"] == 2 and np.isfinite(metrics["loss"])
    emitted = {k: (q.clone(), s.clone()) for k, (q, s) in trainer.state.quant.items()}
    out = cfg["output_dir"]
    dit_sd = torch.load(os.path.join(out, "checkpoint-dit-2.bin"), weights_only=True)
    assert not any("weight_q" in k or "weight_sb" in k or "w_scale" in k for k in dit_sd)

    cfg2 = load_config(str(path))
    cfg2["max_train_steps"] = 3
    resumed = Trainer(cfg2, device="cpu")
    assert resumed.state.step == 2
    if bits == 8:
        assert any(isinstance(m, KA.Moment8) for m in resumed.state.opt_state["nu"].values())
    for k, (q, s) in emitted.items():
        assert torch.equal(resumed.state.quant[k][0], q), k
        assert torch.equal(resumed.state.quant[k][1], s), k
    assert resumed.train()["step"] == 3
    assert ckpt.latest_step(out) == 3
