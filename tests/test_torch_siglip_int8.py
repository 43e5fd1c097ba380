"""The SigLIP tower with ``tower_quant: int8`` in the port against the JAX
package (genhancer_tpu/core/quant.py:423-480, tasks/image.py:150) on the
CPU, at a tiny tower whose linears reach the 64-feature threshold.

* Stage 1 (``quantize_linear_tree`` on the frozen vision tower) and stage
  2 (QLoRA's ``quantize_lora_base`` on the LoRA-wrapped ``SiglipModel``,
  text side included): the same set of quantized linears as JAX's — every
  linear with min(out, in) >= 64 whose path names no embedding: each
  layer's q, k, v, out_proj, fc1, fc2 and the MAP head's out_proj and MLP;
  the head's packed ``in_proj_weight`` has no ``weight`` in either tree
  and stays float — and their codes and scales bit for bit.
* Per int8 layer call of the tower's forward (a whole int8 network is
  chaotic between implementations, so it is held call by call, as
  ``tests/test_torch_int8_step.py`` holds SwitchBack): the activation
  codes and scales of the call's input bit for bit against eager JAX's
  ``quantize_activation_rows``, y within 1e-5 of max|JAX| against JAX's
  ``_int8_matmul`` on the same input (exact codes and int32 sums, float32
  dequantization), and in stage 2, where gradients pass through the
  frozen int8 base, its straight-through dx within 1e-5 of ``jax.vjp``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genhancer_tpu.core import quant as jq
from genhancer_tpu.models.towers import siglip as jsiglip
from genhancer_tpu.train import lora as jlora
from genhancer_tpu_torch.core import nn as tnn_port
from genhancer_tpu_torch.core import quant as tq
from genhancer_tpu_torch.models.towers import siglip as tsiglip
from genhancer_tpu_torch.train import lora

from test_torch_int8_step import _Tap
from test_torch_parity import f32, port_cfg, t
from test_torch_siglip import port_tower

torch.set_num_threads(1)

CFG = jsiglip.SiglipConfig(
    vision=jsiglip.SiglipVisionConfig(hidden_size=64, intermediate_size=128, num_layers=2,
                                      num_heads=2, image_size=32, patch_size=4),
    text=jsiglip.SiglipTextConfig(hidden_size=64, intermediate_size=128, num_layers=1,
                                  num_heads=2, vocab_size=50, max_position_embeddings=12,
                                  projection_size=64))
LAYER_REL = 1e-5


@pytest.fixture(scope="module")
def tree():
    return jax.device_get(jsiglip.init_siglip(jax.random.key(0), CFG))


def _jax_quantized(node, path=""):
    """{path: (weight_q, w_scale)} of a JAX tree's int8 linears."""
    out = {}
    if isinstance(node, dict):
        if "weight_q" in node:
            out[path] = (np.asarray(node["weight_q"]), np.asarray(node["w_scale"]))
        for k, v in node.items():
            out.update(_jax_quantized(v, f"{path}.{k}" if path else k))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            out.update(_jax_quantized(v, f"{path}.{i}" if path else str(i)))
    return out


def _port_quantized(model):
    return {path: (m.weight_q, m.w_scale) for path, m in model.named_modules()
            if getattr(m, "weight_q", None) is not None}


def _spy(monkeypatch):
    """Record each int8 base call: its input, codes, scales and output, and
    (through identity taps) the g that reaches it and its dx."""
    calls, orig = [], tq.linear_int8_base

    def spy(p, x):
        rec = dict(x=x.detach().clone(), wq=p.weight_q, ws=p.w_scale)
        y = orig(p, _Tap.apply(x, rec, "dx") if x.requires_grad else x)
        rec["y"] = y.detach().clone()
        calls.append(rec)
        return _Tap.apply(y, rec, "g") if y.requires_grad else y

    monkeypatch.setattr(tq, "linear_int8_base", spy)
    return calls


def _rel(ours, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(f32(ours) - ref).max() / max(np.abs(ref).max(), 1e-30))


def _hold_calls(calls, grads):
    assert calls
    for c in calls:
        x = jnp.asarray(c["x"].numpy())
        wq, ws = jnp.asarray(c["wq"].numpy()), jnp.asarray(c["ws"].numpy())
        jcodes, jscale = jq.quantize_activation_rows(x)
        codes, scale = tq.quantize_activation_rows(c["x"])
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
        y, vjp = jax.vjp(lambda a: jq._int8_matmul(a, wq, ws), x)
        assert _rel(c["y"], y) <= LAYER_REL, _rel(c["y"], y)
        if grads:
            (jdx,) = vjp(jnp.asarray(c["g"].numpy()))
            assert _rel(c["dx"], jdx) <= LAYER_REL, _rel(c["dx"], jdx)


def _pixels():
    return np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)


def test_stage1_int8_vision_tower_matches_jax(tree, monkeypatch):
    jtree = jq.quantize_linear_tree(tree)
    want = {k: v for k, v in _jax_quantized(jtree).items() if k.startswith("vision_model.")}
    tower = port_tower(tree, CFG, text_side=False)
    done = tq.quantize_linear_tree(tower)
    got = _port_quantized(tower)
    assert set(done) == set(got) == set(want)
    assert "vision_model.head.attention.out_proj" in got
    assert "vision_model.head.mlp.fc2" in got
    assert not any("in_proj" in k or "embedding" in k for k in got)
    for k, (wq, ws) in want.items():
        assert torch.equal(got[k][0], t(wq)) and torch.equal(got[k][1], t(ws)), k
    calls = _spy(monkeypatch)
    with torch.no_grad():
        tsiglip.vision_forward(tower.vision_model, t(_pixels()), port_cfg(CFG).vision)
    assert len(calls) == len(got)
    _hold_calls(calls, grads=False)


def test_stage2_qlora_siglip_matches_jax(tree, monkeypatch):
    jtree, _ = jlora.inject(tree, jax.random.key(3), r=4, alpha=8.0)
    want = _jax_quantized(jq.quantize_lora_base(jtree))
    model = port_tower(tree, CFG, text_side=True).requires_grad_(False)
    lora.inject(model, torch.Generator().manual_seed(0), r=4, alpha=8.0)
    done = tq.quantize_lora_base(model)
    got = _port_quantized(model)
    assert set(done) == set(got) == set(want)
    assert any(k.startswith("text_model.") for k in got)
    assert isinstance(model.vision_model.encoder.layers[0].mlp.fc1.lora_A,
                      torch.nn.Parameter)
    for k, (wq, ws) in want.items():
        assert torch.equal(got[k][0], t(wq)) and torch.equal(got[k][1], t(ws)), k
    calls = _spy(monkeypatch)
    for p in model.parameters():
        p.requires_grad_(False)
    px = t(_pixels()).requires_grad_(True)      # gradients pass through every base
    _, pooled = tsiglip.vision_forward(model.vision_model, px, port_cfg(CFG).vision)
    pooled.square().sum().backward()
    assert len(calls) == sum(1 for k in got if k.startswith("vision_model."))
    _hold_calls(calls, grads=True)
    assert isinstance(model.vision_model.head.attention.out_proj.weight, torch.Tensor)
    assert not isinstance(model.vision_model.head.attention.out_proj, tnn_port.Int8Layer)
