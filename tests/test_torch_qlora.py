"""QLoRA (LoRA on an int8 tower base) and the static int8 DiT of stage 2
against the JAX package: ``core.quant.quantize_lora_base`` /
``refresh_static_quant_flat``, ``core.nn.linear`` on a node carrying
``weight_q`` and LoRA factors, one accumulation-2 step of each published
``tpu_fast`` stage-2 config per int8 layer, the export, and the trainer's
refresh of the static factors after a load.

The tiny spec: a tower of width 64 (text side too), so that every linear
reaches QLoRA's threshold of 64; a DiT of width 512, so that its large
linears reach SwitchBack's 512 (``stage2_all``, ``dit_quant: int8_full``
with the cache the fused optimizer keeps) and most of them the static
base's 64 (``stage2_only``); float32 throughout.  Weights come from a JAX
init (LoRA injected, then quantized, in JAX's order) with a nonzero
``lora_B`` planted, carried into the port as float masters whose int8
factors the port re-derives: they must equal JAX's bit for bit.

The composed step is held per int8 layer, as ``tests/test_torch_int8_step.py``
holds stage 1: the int8 network is chaotic between two implementations (a
flipped code cascades), so each call of an int8 base (``linear_int8_base``)
and of SwitchBack, on the inputs and gradient it met in the port's step, is
held against the JAX function of that layer at 1e-5 of max|JAX|, with
controls that must miss the bound: the QLoRA node run on its float weight,
and SwitchBack's unquantized forward.  The loss is held at 1e-4 relative
and each gradient at twice the int8 noise measured here (``GRAD_REL``).
"""

import collections
import contextlib
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from genhancer_tpu.core import nn as jnn
from genhancer_tpu.core import quant as jq
from genhancer_tpu.models.towers import clip as jclip
from genhancer_tpu.tasks import image as jimage
from genhancer_tpu.tasks.factory import build_spec as jax_build_spec
from genhancer_tpu.train import lora as jlora
from genhancer_tpu.train import state as jstate
from genhancer_tpu.train.config import load_config as jax_load_config
from genhancer_tpu_torch import registry
from genhancer_tpu_torch.core import nn as tnn
from genhancer_tpu_torch.core import quant as tq
from genhancer_tpu_torch.data import testing
from genhancer_tpu_torch.tasks import factory
from genhancer_tpu_torch.tasks import image as timage
from genhancer_tpu_torch.train import checkpoint as ckpt
from genhancer_tpu_torch.train import lora, optim
from genhancer_tpu_torch.train.config import load_config
from genhancer_tpu_torch.train.state import with_quant_cache
from genhancer_tpu_torch.train.step_utils import make_accum_train_step
from genhancer_tpu_torch.train.trainer import Trainer, hf_export_name
from genhancer_tpu_torch.weights.convert import load_jax_params

from test_torch_int8_step import INT8_DIT, _Tap
from test_torch_parity import TINY_VAE, f32, port_cfg, port_spec, t
from test_torch_stage2 import _jax_draws, _node, _port_name

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYER_REL = 1e-5
# the composed step's gradients against JAX's: the int8 quantization noise
# itself once a flipped code has cascaded (measured 5.1% at the worst leaf,
# the tower's out_proj.lora_A in stage2_all, 1-3% typical), twice over
GRAD_REL = 1e-1
LORA = dict(lora_r=3, lora_alpha=16.0, lora_dropout=0.1)
QL_TOWER = jclip.CLIPConfig(
    vision=jclip.CLIPVisionConfig(hidden_size=64, intermediate_size=128, num_layers=1,
                                  num_heads=2, image_size=32, patch_size=16),
    text=jclip.CLIPTextConfig(hidden_size=64, intermediate_size=128, num_layers=1,
                              num_heads=2, vocab_size=50, max_position_embeddings=8),
    projection_dim=64)
# the int8 knobs of the three published configs, cut to the tiny spec
CONFIGS = {"stage2_all": dict(tower_quant="int8", dit_quant="int8_full", dit_quant_cache=True),
           "stage2_only": dict(tower_quant="int8", dit_quant="int8", vae_quant="int8",
                               vae_quant_min_ch=8)}
YAML = {"stage2_all": "tpu_fast_stage2_all.yaml", "stage2_only": "tpu_fast_stage2_only.yaml",
        "video": "tpu_fast_video_stage2_all.yaml"}
TEXT = ("clip.model.text_model.", "clip.model.text_projection")


def _specs(stage):
    js = jimage.TaskSpec(stage=stage, tower_kind="clip", img_size=32, clip_image_size=32,
                         dit_cfg=INT8_DIT, vae_cfg=TINY_VAE, tower_cfg=QL_TOWER, clip_dim=24,
                         t5_dim=32, compute_dtype=jnp.float32, dit_param_dtype=jnp.float32,
                         vae_dtype=jnp.float32, **LORA, **CONFIGS[stage])
    ps = dataclasses.replace(port_spec(js), stage=stage, vae_dtype=torch.float32, **LORA,
                             **CONFIGS[stage])
    return js, ps


def _floats(tree):
    """The JAX tree without QLoRA's derived int8 factors, those beside a kept
    ``weight`` (the masters the port loads and quantizes itself); the int8
    VAE convs, which have no float weight, stay."""
    if isinstance(tree, dict):
        kept = "weight" in tree
        return {k: _floats(v) for k, v in tree.items()
                if not (kept and k in ("weight_q", "w_scale"))}
    if isinstance(tree, list):
        return [_floats(v) for v in tree]
    return tree


def _port_mod(path):
    """A JAX node path -> the port module path."""
    return _port_name(path + ".weight")[: -len(".weight")]


def _jax_static(tree):
    """{port module path: (weight_q, w_scale)} of every node of a JAX tree
    carrying QLoRA's factors beside its kept weight."""
    flat = jstate.flatten_params(tree)
    return {_port_mod(k[: -len(".weight_q")]): (np.asarray(v), np.asarray(
        flat[k[: -len(".weight_q")] + ".w_scale"]))
        for k, v in flat.items() if k.endswith(".weight_q") and k[: -len("_q")] in flat}


def _port_static(modules):
    """The same of the port's modules."""
    return {p: (m.weight_q, m.w_scale) for p, m in modules.named_modules()
            if "weight_q" in m._buffers and "weight" in m._parameters}


@pytest.fixture(scope="module")
def jax_inits():
    """The JAX init of each stage (QLoRA tower; the static DiT in
    stage2_only), a nonzero B planted in every wrapped linear."""
    out = {}
    rng = np.random.default_rng(4)
    for stage in CONFIGS:
        js, _ = _specs(stage)
        modules = jax.device_get(jimage.init_modules(jax.random.key(0), js))
        tower = modules["clip"]["model"]
        for p in jlora.lora_trainable_paths(tower):
            if p.endswith(".lora_B"):
                node = _node(tower, p[: -len(".lora_B")])
                node["lora_B"] = 0.1 * rng.standard_normal(node["lora_B"].shape
                                                           ).astype(np.float32)
        out[stage] = modules
    return out


def _port_modules(jax_inits, stage):
    _, ps = _specs(stage)
    mods = timage.init_modules(ps, torch.Generator().manual_seed(0))
    load_jax_params(mods, _floats({k: jax_inits[stage][k] for k in ("dit", "vae", "clip")}))
    tq.refresh_static_quant_flat(tq.static_quant_flat(mods))
    return mods


@pytest.mark.parametrize("stage", sorted(CONFIGS))
def test_static_factors_match_jax(jax_inits, stage):
    """The quantized path set and every code and scale of
    ``quantize_lora_base`` (the whole LoRA-wrapped CLIPModel; in
    stage2_only the DiT too) and of ``refresh_static_quant_flat`` after the
    masters move, bit for bit with JAX's."""
    mods = _port_modules(jax_inits, stage)
    ours, ref = _port_static(mods), _jax_static(jax_inits[stage])
    assert sorted(ours) == sorted(ref)
    assert any(p.startswith("clip.model.text_model.") for p in ours)
    assert ("dit.time_in.in_layer" in ours) == (stage == "stage2_only")
    wrapped = {"clip.model." + p for p in lora.wrapped_paths(mods["clip"]["model"])}
    assert wrapped <= set(ours)                 # LoRA-wrapped nodes included
    for p, (wq, ws) in ours.items():
        assert wq.dtype == torch.int8 and ws.shape == (wq.shape[0], 1), p
        np.testing.assert_array_equal(wq.numpy(), ref[p][0], err_msg=p)
        np.testing.assert_array_equal(ws.numpy(), ref[p][1], err_msg=p)
    # the masters move (a load): both packages re-derive the same factors
    rng = np.random.default_rng(8)
    jflat = jstate.flatten_params(jax_inits[stage])
    flat = tq.static_quant_flat(mods)
    with torch.no_grad():
        for k in list(jflat):
            w = k[: -len("_q")]
            if k.endswith(".weight_q") and w in jflat:
                jflat[w] = np.asarray(jflat[w]) * (1 + rng.random(jflat[w].shape, np.float32))
                flat[_port_name(w)].copy_(t(jflat[w]))
    refreshed = tq.refresh_static_quant_flat(flat)
    assert sorted(refreshed) == sorted(p + ".weight" for p in ours)
    jnew = jq.refresh_static_quant_flat(jflat)
    for p, (wq, ws) in _port_static(mods).items():
        jp = [k for k in jnew if k.endswith(".weight_q") and _port_mod(k[:-9]) == p][0]
        np.testing.assert_array_equal(wq.numpy(), np.asarray(jnew[jp]), err_msg=p)
        np.testing.assert_array_equal(ws.numpy(), np.asarray(jnew[jp[:-9] + ".w_scale"]),
                                      err_msg=p)
    # derived state: in no state dict of the DiT or the tower
    assert not any(k.endswith(("weight_q", "w_scale"))
                   for name in ("dit", "clip") for k in mods[name].state_dict())


def test_linear_on_an_int8_base_with_lora_matches_jax():
    """``linear`` on a node with ``weight``, ``weight_q``/``w_scale``, LoRA
    factors and a bias: the int8 base, then the branch, then the bias, as
    JAX's; inside the SwitchBack context too (it never reaches SwitchBack)."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((96, 64)).astype(np.float32) * 0.1
    a = rng.standard_normal((4, 64)).astype(np.float32) * 0.1
    b = rng.standard_normal((96, 4)).astype(np.float32) * 0.1
    bias = rng.standard_normal(96).astype(np.float32)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    g = rng.standard_normal((2, 5, 96)).astype(np.float32)
    jwq, jws = jq.quantize_weight(jnp.asarray(w))
    jp = {"weight": jnp.asarray(w), "weight_q": jwq, "w_scale": jws, "lora_A": jnp.asarray(a),
          "lora_B": jnp.asarray(b), "lora_scale": jnp.asarray(2.0, jnp.float32),
          "bias": jnp.asarray(bias)}

    def jf(xx, aa, bb):
        return jnn.linear({**jp, "lora_A": aa, "lora_B": bb}, xx)

    jy, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(a), jnp.asarray(b))
    jdx, jda, jdb = vjp(jnp.asarray(g))

    mod = tnn.Linear(64, 96)
    with torch.no_grad():
        mod.weight.copy_(t(w))
        mod.bias.copy_(t(bias))
    mod.weight.requires_grad_(False)
    mod.lora_A, mod.lora_B = torch.nn.Parameter(t(a)), torch.nn.Parameter(t(b))
    mod.register_buffer("lora_scale", torch.tensor(2.0))
    assert tq.quantize_lora_base(mod) == ("",)
    np.testing.assert_array_equal(mod.weight_q.numpy(), np.asarray(jwq))
    for ctx in (contextlib.nullcontext, lambda: tnn.int8_training_ctx(full=True)):
        xt = t(x).requires_grad_(True)
        with ctx():
            y = tnn.linear(mod, xt)
        y.backward(t(g))
        assert np.abs(f32(y) - np.asarray(jy)).max() <= 1e-6 * np.abs(np.asarray(jy)).max()
        for ours, ref in ((xt.grad, jdx), (mod.lora_A.grad, jda), (mod.lora_B.grad, jdb)):
            assert np.abs(f32(ours) - np.asarray(ref)).max() <= 1e-6 * np.abs(ref).max()
        assert mod.weight.grad is None
        mod.lora_A.grad = mod.lora_B.grad = None
    # control: the node run on its float weight misses the bound
    y_float = x @ w.T + (x @ a.T @ b.T) * 2 + bias
    assert np.abs(y_float - np.asarray(jy)).max() > 10 * 1e-6 * np.abs(np.asarray(jy)).max()


def _spy(monkeypatch, names):
    """Record every int8-base and SwitchBack call: the layer's module path
    (``names``: data pointer of its codes or weight -> path), the inputs,
    the codes and scales, the output; the backward adds g, dx (and dW)."""
    calls = {"base": [], "sb": []}
    base, sb = tq.linear_int8_base, tq.switchback

    def spy_base(p, x):
        rec = dict(path=names[p.weight_q.data_ptr()], x=x.detach().clone(),
                   wq=p.weight_q.clone(), ws=p.w_scale.clone(), w=p.weight.detach().clone())
        y = base(p, _Tap.apply(x, rec, "dx"))
        rec["y"] = y.detach().clone()
        calls["base"].append(rec)
        return _Tap.apply(y, rec, "g")

    def spy_sb(x, w, wq=None, ws=None, dw="bf16"):
        rec = dict(path=names.get(w.data_ptr()), x=x.detach().clone(), w=w.detach().clone(),
                   dw_kind=dw, wq=wq.clone(), ws=ws.clone())
        y = sb(_Tap.apply(x, rec, "dx"), _Tap.apply(w, rec, "dW"), wq, ws, dw)
        rec["y"] = y.detach().clone()
        calls["sb"].append(rec)
        return _Tap.apply(y, rec, "g")

    monkeypatch.setattr(tq, "linear_int8_base", spy_base)
    monkeypatch.setattr(tq, "switchback", spy_sb)
    return calls


def _rel(ours, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(f32(ours) - ref).max() / max(np.abs(ref).max(), 1e-30))


class _Recorder:
    def __init__(self, inner):
        self.inner, self.grads, self.emit_quant = inner, None, inner.emit_quant

    def init(self, params):
        return self.inner.init(params)

    def apply(self, params, grads, state, **kw):
        self.grads = {k: g.detach().clone() for k, g in grads.items()}
        return self.inner.apply(params, grads, state, **kw)


def _hold_layers(calls, state, mods, jax_static, jquant, stage, remat=False):
    """Each int8 call of the port's composed step against the JAX function
    of its layer on the same inputs, and the controls that must miss."""
    expect = {p for p in _port_static(mods) if not p.startswith(TEXT)}
    assert collections.Counter(c["path"] for c in calls["base"]) == {p: 2 for p in expect}
    assert any(p.startswith("dit.") for p in expect) == (stage == "stage2_only")
    for c in calls["base"]:
        jwq, jws = jax_static[c["path"]]
        np.testing.assert_array_equal(c["wq"].numpy(), jwq)
        np.testing.assert_array_equal(c["ws"].numpy(), jws)
        x = jnp.asarray(c["x"].numpy())
        y, vjp = jax.vjp(lambda a: jq.linear_int8_base({"weight_q": jwq, "w_scale": jws}, a), x)
        assert _rel(c["y"], y) <= LAYER_REL, (c["path"], _rel(c["y"], y))
        if "dx" in c:       # the input carries a gradient (not the first layer's)
            assert _rel(c["dx"], vjp(jnp.asarray(c["g"].numpy()))[0]) <= LAYER_REL, c["path"]
        # control: a QLoRA node that ran its float weight
        assert _rel(c["y"], x @ jnp.asarray(c["w"].numpy()).T) > 10 * LAYER_REL, c["path"]
    # with remat each SwitchBack layer runs again in the backward (the
    # recompute, whose graph takes the gradient)
    blocks = ("dit.double_blocks.", "dit.single_blocks.")
    sb_paths = collections.Counter(c["path"] for c in calls["sb"])
    assert sb_paths == ({k[: -len(".weight")]: 2 * (2 if remat and k.startswith(blocks) else 1)
                         for k in state.quant} if stage != "stage2_only" else {})
    assert sum("g" in c for c in calls["sb"]) == 2 * len(state.quant or {})
    for c in calls["sb"]:
        jwq, jws = (np.asarray(a) for a in jquant[c["path"]])
        assert c["dw_kind"] == "cols"
        np.testing.assert_array_equal(c["wq"].numpy(), jwq)
        np.testing.assert_array_equal(c["ws"].numpy(), jws)
        x, w = (jnp.asarray(c[k].numpy()) for k in ("x", "w"))
        y, vjp = jax.vjp(lambda a, b: jq.switchback_linear_full_cached(a, b, jwq, jws), x, w)
        assert _rel(c["y"], y) <= LAYER_REL, c["path"]
        assert _rel(c["y"], x @ w.T) > 10 * LAYER_REL, c["path"]
        if "g" in c:
            jdx, jdw = vjp(jnp.asarray(c["g"].numpy()))
            assert _rel(c["dW"], jdw) <= LAYER_REL, c["path"]
            if "dx" in c:
                assert _rel(c["dx"], jdx) <= LAYER_REL, c["path"]


@pytest.mark.parametrize("stage", sorted(CONFIGS))
def test_accumulation_step_matches_jax_per_int8_layer(jax_inits, monkeypatch, stage):
    """One accumulation-2 step of the ``tpu_fast`` stage-2 config on latent
    cache batches ``{moments, image}``, with JAX's draws and dropout masks."""
    js, ps = _specs(stage)
    modules = jax.tree_util.tree_map(jnp.asarray, jax_inits[stage])
    jst = jstate.create_state(modules, jimage.trainable_predicate(js, modules), optax.sgd(0.0))
    if stage == "stage2_all":
        jst = jstate.with_quant_cache(jst)
    rng = np.random.default_rng(3)
    imgs = rng.random((2, 2, 32, 32, 3), dtype=np.float32)
    h, w = js.latent_hw
    mom = np.concatenate([rng.standard_normal((2, 2, h, w, 4)),
                          -2 + 0.1 * rng.standard_normal((2, 2, h, w, 4))], -1).astype(np.float32)
    key = jax.random.key(11)
    keys = jax.random.split(key, 2)
    jloss = jimage.make_loss_fn(js)
    jgrad = jax.jit(jax.value_and_grad(
        lambda tp, mb, k: jloss(tp, jst.frozen, mb, k, jst.quant) * 0.5))
    jgrads, jl = None, 0.0
    for i in range(2):
        li, g = jgrad(jst.trainable, {"image": jnp.asarray(imgs[i]),
                                      "moments": jnp.asarray(mom[i])}, keys[i])
        jgrads = g if jgrads is None else jax.tree_util.tree_map(jnp.add, jgrads, g)
        jl += float(li)

    mods = _port_modules(jax_inits, stage)
    hyper = dict(learning_rate=1e-6, lr_scheduler="constant", max_train_steps=10,
                 fused_optimizer="pallas")
    rec = _Recorder(optim.make_optimizer(hyper, emit_quant=stage == "stage2_all"))
    state = timage.create_state(mods, timage.trainable_predicate(ps, mods), rec)
    if stage == "stage2_all":
        state = with_quant_cache(state)
    names = {m.weight_q.data_ptr(): p for p, m in mods.named_modules() if "weight_q" in m._buffers}
    names.update({p.data_ptr(): k[: -len(".weight")] for k, p in state.trainable.items()})
    calls = _spy(monkeypatch, names)
    jq_cache = {_port_name(k)[: -len(".weight")]: v for k, v in (jst.quant or {}).items()}
    step = make_accum_train_step(timage.make_loss_fn(ps), rec, 2)
    state, m = step(state, {"image": t(imgs), "moments": t(mom)}, None,
                    [_jax_draws(js, keys[i], 2) for i in range(2)])
    _hold_layers(calls, state, mods, _jax_static(jax_inits[stage]), jq_cache, stage)

    assert abs(m["loss"].item() - jl) <= 1e-4 * abs(jl)
    # a key bias's gradient is 0 but for roundoff (the softmax ignores it):
    # held against the tower's largest gradient instead
    tower_max = max(np.abs(np.asarray(g)).max() for k, g in jgrads.items()
                    if k.startswith("clip.model."))
    for k, g in jgrads.items():
        ours, ref = f32(rec.grads[_port_name(k)]), np.asarray(g, np.float32)
        if not ref.any():
            assert not ours.any(), k        # the text side's LoRA leaves
            continue
        if k.endswith("self_attn.k_proj.bias"):
            assert max(np.abs(ours).max(), np.abs(ref).max()) <= 1e-4 * tower_max, k
            continue
        assert np.abs(ours - ref).max() <= GRAD_REL * np.abs(ref).max(), k
        assert np.linalg.norm(ours - ref) <= GRAD_REL * np.linalg.norm(ref), k


def _video_specs(remat=True):
    """``tpu_fast_video_stage2_all`` cut: middle mode, QLoRA tower, int8_full
    DiT with the cache, DiT remat on, ``tower_remat`` off (the config's
    gates at B=4)."""
    from genhancer_tpu.tasks import video as jvideo
    from genhancer_tpu_torch.tasks import video as tvideo
    knobs = dict(tower_quant="int8", dit_quant="int8_full", dit_quant_cache=True)
    dit = dataclasses.replace(INT8_DIT, vec_in_dim=64)
    js = jvideo.VideoTaskSpec(mode="middle", stage="stage2_all", tower_kind="clip",
                              img_size=32, clip_image_size=32, dit_cfg=dit, vae_cfg=TINY_VAE,
                              tower_cfg=QL_TOWER, clip_dim=64, t5_dim=32, adapter_in_dim=64,
                              compute_dtype=jnp.float32, dit_param_dtype=jnp.float32,
                              vae_dtype=jnp.float32, remat=remat, **LORA, **knobs)
    ps = tvideo.VideoTaskSpec(mode="middle", stage="stage2_all", tower_kind="clip",
                              img_size=32, clip_image_size=32, dit_cfg=port_cfg(dit),
                              vae_cfg=port_cfg(TINY_VAE), tower_cfg=port_cfg(QL_TOWER),
                              clip_dim=64, t5_dim=32, adapter_in_dim=64,
                              compute_dtype=torch.float32, dit_param_dtype=torch.float32,
                              vae_dtype=torch.float32, remat=remat, **LORA, **knobs)
    return js, ps


def test_video_accumulation_step_matches_jax_per_int8_layer(monkeypatch):
    """One accumulation-2 step of ``tpu_fast_video_stage2_all`` (cut), with
    JAX's draws and the dropout masks over the b x n_cond frames: each int8
    call against JAX's layer function; the SwitchBack layers recomputed
    under remat run the int8 path again (``core.nn.int8_ctx_replay``), so
    the port's step with remat equals its step without, bit for bit."""
    from genhancer_tpu.tasks import video as jvideo
    from genhancer_tpu_torch.tasks import video as tvideo
    from test_torch_video_stage2 import _jax_draws as video_draws
    js, ps = _video_specs()
    modules = jax.device_get(jvideo.init_modules(jax.random.key(0), js))
    rng = np.random.default_rng(4)
    tower = modules["clip"]["model"]
    for p in jlora.lora_trainable_paths(tower):
        if p.endswith(".lora_B"):
            node = _node(tower, p[: -len(".lora_B")])
            node["lora_B"] = 0.1 * rng.standard_normal(node["lora_B"].shape).astype(np.float32)
    jmods = jax.tree_util.tree_map(jnp.asarray, modules)
    jst = jstate.with_quant_cache(jstate.create_state(
        jmods, jvideo.trainable_predicate(js, jmods), optax.sgd(0.0)))
    data = np.random.default_rng(3)
    batch = {"cond": data.random((2, 2, 2, 32, 32, 3), dtype=np.float32),
             "target": data.random((2, 2, 32, 32, 3), dtype=np.float32)}
    key = jax.random.key(11)
    keys = jax.random.split(key, 2)
    jloss = jvideo.make_loss_fn(js)
    # one compile for both micro-batches (eager JAX under remat is slow)
    jgrad = jax.jit(jax.value_and_grad(
        lambda tp, mb, k: jloss(tp, jst.frozen, mb, k, jst.quant) * 0.5))
    jgrads, jl = None, 0.0
    for i in range(2):
        li, g = jgrad(jst.trainable, {k: jnp.asarray(v[i]) for k, v in batch.items()}, keys[i])
        jgrads = g if jgrads is None else jax.tree_util.tree_map(jnp.add, jgrads, g)
        jl += float(li)

    hyper = dict(learning_rate=1e-6, lr_scheduler="constant", max_train_steps=10,
                 fused_optimizer="pallas")
    draws = [video_draws(js, keys[i], 2) for i in range(2)]
    results = {}
    for remat in (True, False):
        _, spec = _video_specs(remat)
        mods = tvideo.init_modules(spec, torch.Generator().manual_seed(0))
        load_jax_params(mods, _floats({k: modules[k] for k in
                                       ("dit", "vae", "clip", "visual_adapter")}))
        tq.refresh_static_quant_flat(tq.static_quant_flat(mods))
        rec = _Recorder(optim.make_optimizer(hyper, emit_quant=True))
        state = with_quant_cache(tvideo.create_state(mods, tvideo.trainable_predicate(spec, mods),
                                                     rec))
        names = {m.weight_q.data_ptr(): p for p, m in mods.named_modules()
                 if "weight_q" in m._buffers}
        names.update({p.data_ptr(): k[: -len(".weight")] for k, p in state.trainable.items()})
        with monkeypatch.context() as mp:
            calls = _spy(mp, names)
            state, m = make_accum_train_step(tvideo.make_loss_fn(spec), rec, 2)(
                state, {k: t(v) for k, v in batch.items()}, None, draws)
        if remat:
            jq_cache = {_port_name(k)[: -len(".weight")]: v for k, v in jst.quant.items()}
            _hold_layers(calls, state, mods, _jax_static(modules), jq_cache, "video", remat=True)
        results[remat] = (m["loss"].item(), rec.grads)
    assert abs(results[True][0] - jl) <= 1e-4 * abs(jl)
    assert results[True][0] == results[False][0]
    for k, g in results[False][1].items():
        assert torch.equal(results[True][1][k], g), k
    for k, g in jgrads.items():
        ours, ref = f32(results[True][1][_port_name(k)]), np.asarray(g, np.float32)
        if not ref.any() or k.endswith("self_attn.k_proj.bias"):
            continue
        assert np.linalg.norm(ours - ref) <= GRAD_REL * np.linalg.norm(ref), k


def test_qlora_export_equals_the_unquantized_export(tmp_path):
    """The same factors on a QLoRA tower and on the plain tower: the two HF
    exports are the same bytes, and hold no int8 factor or LoRA key."""
    js, ps = _specs("stage2_all")
    plain = dataclasses.replace(ps, tower_quant="none")
    out = {}
    for name, spec in (("qlora", ps), ("plain", plain)):
        mods = timage.init_modules(spec, torch.Generator().manual_seed(3))
        gen = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for p in lora.wrapped_paths(mods["clip"]["model"]):
                b = mods["clip"]["model"].get_submodule(p).lora_B
                b.copy_(torch.randn(b.shape, generator=gen))
        tower = mods["clip"]["model"]
        assert bool(_port_static(tower)) == (name == "qlora")
        merged = lora.merge(tower).state_dict()
        fast = lora.merged_state_dict(tower)
        assert list(fast) == list(merged) and all(torch.equal(fast[k], merged[k]) for k in fast)
        state = timage.create_state(mods, timage.trainable_predicate(spec, mods),
                                    optim.make_optimizer(dict(learning_rate=1e-3)))
        d = ckpt.export_hf_tower(state, str(tmp_path / name), base_config={"a": 1})
        out[name] = open(os.path.join(d, "pytorch_model.bin"), "rb").read()
        sd = torch.load(os.path.join(d, "pytorch_model.bin"), weights_only=True)
        assert not any(k.endswith(("weight_q", "w_scale", "lora_A", "lora_B", "lora_scale"))
                       for k in sd)
    assert out["qlora"] == out["plain"]


@pytest.fixture
def ql_models(monkeypatch):
    monkeypatch.setattr(registry, "build_dit_config", lambda name: port_cfg(INT8_DIT))
    monkeypatch.setattr(registry, "build_vae_config",
                        lambda name, ae_path=None: port_cfg(TINY_VAE))
    monkeypatch.setattr(registry, "tower_family_and_config",
                        lambda tower, size, clip_type=None: ("clip", port_cfg(QL_TOWER)))


def _cfg(tmp_path, name, file, data, **over):
    """The published config ``name`` cut to the tiny models and batch,
    written to ``file`` and loaded."""
    raw = yaml.safe_load(open(os.path.join(ROOT, "configs", YAML[name])))
    raw.update({"output_dir": str(tmp_path / f"out-{file}"), "max_train_steps": 2,
                "checkpointing_steps": 2, "report_to": "none", "log_interval": 1,
                "mixed_precision": "no", "vae_dtype": "fp32", "vae_quant_min_ch": 8,
                "learning_rate": 1e-3, **over})
    raw["data_config"].update(train_batch_size=2, img_size=32, num_workers=1, **data)
    raw["clip_config"].update(clip_image_size=32, clip_dim=24, t5_dim=32)
    path = tmp_path / f"{file}.yaml"
    path.write_text(yaml.safe_dump(raw))
    return load_config(str(path)), str(path)


@pytest.mark.parametrize("name", ["stage2_all", "stage2_only", "video"])
def test_published_configs_map_to_the_jax_specs(name):
    """The three ``tpu_fast`` stage-2 configs as published: the port's spec
    equals JAX's ``build_spec`` (the int8 knobs, the cache, the gates)."""
    path = os.path.join(ROOT, "configs", YAML[name])
    ours, kind, ck = factory.build_spec(load_config(path))
    ref, rkind, rck = jax_build_spec(jax_load_config(path))
    assert (kind, ck) == (rkind, rck)
    for f in ("stage", "tower_quant", "vae_quant", "vae_quant_min_ch", "dit_quant",
              "dit_quant_cache", "lora_r", "lora_alpha", "lora_dropout", "tower_remat",
              "remat", "img_size", "clip_image_size"):
        assert getattr(ours, f) == getattr(ref, f), f
    if name == "video":
        assert ours.remat and not ours.tower_remat and ours.mode == "middle"


def test_trainer_from_stage1_files_on_a_latent_cache(ql_models, tmp_path):
    """``tpu_fast_stage2_only.yaml`` end to end on the CPU: a latent cache
    made by ``genhancer-precompute-torch``, the stage-1 files of an image
    run; the static factors re-derived after the load equal the quantized
    loaded masters (a control built without the refresh misses), the
    checkpoint files hold no int8 factor, and a resume re-derives them the
    same."""
    from genhancer_tpu_torch.cli import precompute as precompute_cli
    src, cache = str(tmp_path / "img"), str(tmp_path / "cache")
    testing.make_image_shard(os.path.join(src, "s0.tar"), 6, 40)
    s1, _ = _cfg(tmp_path, "stage2_all", "stage1", dict(img_dir=src, precomputed=False),
                 task="image_stage1", checkpointing_steps=1, max_train_steps=1,
                 tower_quant="none", dit_quant="none", fused_optimizer=None, load_dir=None,
                 load_step=None)
    Trainer(s1, device="cpu").train()
    stage2 = dict(load_dir=s1["output_dir"], load_step=1, resume_from_checkpoint="latest")
    _, pre_path = _cfg(tmp_path, "stage2_only", "pre", dict(img_dir=src), **stage2)
    res = precompute_cli.main(["--config", pre_path, "--output_dir", cache, "--mode", "latents",
                               "--variants", "2", "--batch", "4", "--device", "cpu"])
    assert res["written"] == 6
    cfg, _ = _cfg(tmp_path, "stage2_only", "stage2", dict(img_dir=cache), **stage2)
    trainer = Trainer(cfg, device="cpu")
    static = _port_static(trainer.state.modules)
    assert any(p.startswith("dit.") for p in static) and any(p.startswith("clip.") for p in
                                                             static)
    for p, (wq, ws) in static.items():
        q, s = tq.quantize_weight(trainer.state.modules.get_submodule(p).weight)
        assert torch.equal(wq, q) and torch.equal(ws, s), p
    # control: the same modules loaded without the refresh keep the init's
    # factors, which the loaded DiT masters no longer give
    ctrl = timage.init_modules(trainer.spec, torch.Generator().manual_seed(0))
    ckpt.load_stage1_components(ctrl, s1["output_dir"], 1, "image")
    stale = [p for p, (wq, _) in _port_static(ctrl).items() if p.startswith("dit.")
             and not torch.equal(wq, tq.quantize_weight(ctrl.get_submodule(p).weight)[0])]
    assert stale
    metrics = trainer.train()
    assert metrics["step"] == 2 and np.isfinite(metrics["loss"])
    out = cfg["output_dir"]
    for f in ("checkpoint-dit-2.bin", "checkpoint-project-clip-2.bin"):
        sd = torch.load(os.path.join(out, f), weights_only=True)
        assert not any(k.endswith(("weight_q", "w_scale", "weight_sb_q")) for k in sd), f
    assert os.path.isdir(os.path.join(out, hf_export_name(cfg, 2)))
    at_load = {p: (wq.clone(), ws.clone()) for p, (wq, ws) in static.items()}
    resumed = Trainer(cfg.merged_with({"max_train_steps": 3}), device="cpu")
    assert resumed.state.step == 2
    for p, (wq, ws) in _port_static(resumed.state.modules).items():
        if p.startswith("dit."):        # frozen: the same masters, the same factors
            assert torch.equal(wq, at_load[p][0]) and torch.equal(ws, at_load[p][1]), p
