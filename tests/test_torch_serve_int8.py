"""The int8 serving engine (``quant="int8"``) against the JAX package, on
the CPU.

* The int8 layer set: the DiT's and the tower's linears with
  min(out, in) >= 64 and every VAE conv (encoder and decoder, the mid-block
  attention's 1x1 convs too) with in and out >= 256 — exactly the modules
  JAX's ``quantize_linear_tree`` / ``quantize_conv_tree`` give factors — and
  their codes and scales bit for bit.
* Each int8 layer call of one reconstruct and one embed, recorded with its
  input, against eager JAX on that input: the activation codes and scales
  bit for bit, the dequantized output at 1e-6 of its largest magnitude.
* The whole reconstruct and embed against JAX's int8 composition on the
  same noise: a whole int8 network is chaotic between two implementations
  (one flipped code moves its row, the next layer flips more), so they are
  held to twice JAX's own int8 noise (JAX int8 against JAX float).
* A padded bucket against an exact one: the VAE convs quantize per call with
  one amax over the bucket, and padding repeats the last row, which leaves
  the amax as it was.

The spec is the tiny serving one with a tower of width 64 and a VAE with a
256-channel level, so that every int8 kind is present.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genhancer_tpu.core import quant as jquant
from genhancer_tpu.models import vae as jvae
from genhancer_tpu.models.towers import clip as jclip
from genhancer_tpu.serve.engine import InferenceEngine as JaxEngine
from genhancer_tpu_torch.core import quant as tquant
from genhancer_tpu_torch.core.nn import Int8Layer
from genhancer_tpu_torch.serve.engine import InferenceEngine, _pad_to
from genhancer_tpu_torch.weights.convert import state_dicts_from_jax

from test_torch_parity import TINY_TOWER, f32, jax_params, jax_spec, port_modules, port_spec, t
from test_torch_serve import jax_reconstruct

torch.set_num_threads(1)

VAE8 = jvae.VAEConfig(resolution=32, ch=128, ch_mult=(1, 2), num_res_blocks=1, z_channels=4)
TOWER8 = dataclasses.replace(
    TINY_TOWER, vision=jclip.CLIPVisionConfig(hidden_size=64, intermediate_size=128,
                                              num_layers=1, num_heads=2, image_size=32,
                                              patch_size=16))
STEPS = 2


@pytest.fixture(scope="module")
def spec():
    return dataclasses.replace(jax_spec(), vae_cfg=VAE8, tower_cfg=TOWER8)


@pytest.fixture(scope="module")
def params(spec):
    return jax_params(spec, seed=1)


@pytest.fixture(scope="module")
def jq(params):
    """JAX's int8 serving tree (``serve/engine.py:93-103``)."""
    return dict(params, dit=jquant.quantize_linear_tree(params["dit"]),
                vae=jquant.quantize_conv_tree(params["vae"]),
                clip=dict(params["clip"],
                          model=jquant.quantize_linear_tree(params["clip"]["model"])))


def make_engine(spec, params, quant="int8", **kw):
    kw.setdefault("buckets", (1, 4))
    return InferenceEngine(port_spec(spec), port_modules(spec, params), device="cpu",
                           num_steps=STEPS, quant=quant, **kw)


@pytest.fixture(scope="module")
def engine(spec, params):
    return make_engine(spec, params)


def test_int8_layer_set_and_codes_equal_jax(engine, jq):
    """The swapped modules are those JAX gives factors, and their codes and
    scales equal JAX's bit for bit (a linear's ``w_scale`` [o, 1], a conv's
    [1, 1, 1, O]; the conv codes OIHW against JAX's HWIO)."""
    want = state_dicts_from_jax(jax.device_get(jq))
    m = engine.modules
    roots = {"dit": m["dit"], "tower": m["clip"]["model"], "vae": m["vae"]}
    for tree, root in roots.items():
        jax_paths = sorted(k[: -len(".weight_q")] for k in want[tree] if k.endswith(".weight_q"))
        ours = sorted(p for p, mod in root.named_modules() if isinstance(mod, Int8Layer))
        assert ours == jax_paths == sorted(engine.int8_layers[tree]), tree
        assert jax_paths, f"no int8 layer in {tree}"
        sd = root.state_dict()
        for p in jax_paths:
            for leaf in ("weight_q", "w_scale"):
                np.testing.assert_array_equal(sd[f"{p}.{leaf}"].numpy(),
                                              want[tree][f"{p}.{leaf}"].numpy(), err_msg=p)
    vae_paths = engine.int8_layers["vae"]
    assert {"decoder.mid.attn_1.q", "decoder.mid.attn_1.proj_out",
            "encoder.mid.attn_1.k", "decoder.up.1.upsample.conv"} <= set(vae_paths)
    assert any(p.startswith("encoder.") for p in vae_paths)
    assert not any("conv_in" in p or "conv_out" in p for p in vae_paths)   # < 256 channels
    counts = {k: len(v) for k, v in engine.int8_layers.items()}
    assert counts == {"dit": 19, "tower": 6, "vae": 22}, counts


def record_int8_calls(monkeypatch, modules):
    """Stand-ins for the int8 base product and the int8 conv that record
    each call: its module path, input and output."""
    names = {id(mod): p for p, mod in modules.named_modules()}
    calls, base, conv = [], tquant.linear_int8_base, tquant.conv2d_int8

    def spy_base(p, x):
        y = base(p, x)
        calls.append(dict(kind="linear", path=names[id(p)], p=p, x=x.clone(), y=y.clone()))
        return y

    def spy_conv(p, x, stride=1, padding=None):
        y = conv(p, x, stride=stride, padding=padding)
        calls.append(dict(kind="conv", path=names[id(p)], p=p, x=x.clone(), y=y.clone(),
                          stride=stride, padding=padding))
        return y

    monkeypatch.setattr(tquant, "linear_int8_base", spy_base)
    monkeypatch.setattr(tquant, "conv2d_int8", spy_conv)
    return calls


def test_each_int8_call_matches_eager_jax(engine, monkeypatch):
    calls = record_int8_calls(monkeypatch, engine.modules)
    rng = np.random.default_rng(2)
    img = engine._wire(rng.random((2, 32, 32, 3), dtype=np.float32))
    noise = rng.standard_normal((2, 16, 16, 4), dtype=np.float32)
    engine._recon(engine._place(img), t(noise))
    engine._embed(engine._place(img))
    monkeypatch.undo()
    seen = {c["path"] for c in calls}
    # serving runs no VAE encode: every int8 layer but the encoder's
    assert seen == {f"{k}.{p}" if k != "tower" else f"clip.model.{p}"
                    for k, ps in engine.int8_layers.items() for p in ps
                    if not p.startswith("encoder.")}
    # per reconstruct: the tower once and every DiT linear per step; the embed
    # the tower once more; the VAE decoder's convs once
    n_lin = sum(c["kind"] == "linear" for c in calls)
    assert n_lin == 2 * len(engine.int8_layers["tower"]) + STEPS * len(engine.int8_layers["dit"])
    worst = 0.0
    for c in calls:
        x, p = c["x"], c["p"]
        if c["kind"] == "linear":
            q, s = tquant.quantize_activation_rows(x)
            jqv, jsv = jquant.quantize_activation_rows(jnp.asarray(f32(x)))
            want = jquant._int8_fwd_base(jnp.asarray(f32(x)), jnp.asarray(p.weight_q.numpy()),
                                         jnp.asarray(p.w_scale.numpy()))
            got = c["y"]
        else:
            q, s = tquant.quantize_activation_tensor(x)
            jqv, jsv = jquant.quantize_activation_tensor(jnp.asarray(f32(x).transpose(0, 2, 3, 1)))
            q = q.permute(0, 2, 3, 1)
            node = {"weight_q": jnp.asarray(p.weight_q.permute(2, 3, 1, 0).numpy()),
                    "w_scale": jnp.asarray(p.w_scale.numpy())}
            if p.bias is not None:
                node["bias"] = jnp.asarray(f32(p.bias))
            pad = "SAME" if c["padding"] is None else "VALID"
            assert c["padding"] in (None, 0), c
            want = jquant.conv2d_int8(node, jnp.asarray(f32(x).transpose(0, 2, 3, 1)),
                                      stride=c["stride"], padding=pad)
            got = c["y"].permute(0, 2, 3, 1)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jqv), err_msg=c["path"])
        np.testing.assert_array_equal(f32(s).reshape(-1), f32(jsv).reshape(-1),
                                      err_msg=c["path"])
        err = np.abs(f32(got) - f32(want)).max() / max(np.abs(f32(want)).max(), 1e-30)
        worst = max(worst, err)
    assert worst <= 1e-6, worst


def test_reconstruct_and_embed_within_jax_int8_noise(spec, params, jq, engine):
    rng = np.random.default_rng(3)
    img = rng.random((2, 32, 32, 3), dtype=np.float32)
    noise = rng.standard_normal((2, 16, 16, 4), dtype=np.float32)
    ref_q = jax_reconstruct(spec, jq, jnp.asarray(img), jnp.asarray(noise), STEPS,
                            engine.guidance, "float32")
    ref_f = jax_reconstruct(spec, params, jnp.asarray(img), jnp.asarray(noise), STEPS,
                            engine.guidance, "float32")
    ours = engine._recon(engine._place(img), t(noise)).numpy()
    plain = make_engine(spec, params, quant="none")
    ours_f = plain._recon(plain._place(img), t(noise)).numpy()
    noise_level = np.abs(ref_q - ref_f).max()
    assert noise_level > 1e-4                                  # int8 is really on
    np.testing.assert_allclose(ours_f, ref_f, rtol=0, atol=1e-4)
    assert np.abs(ours - ref_q).max() <= 2 * noise_level, (np.abs(ours - ref_q).max(), noise_level)

    jeng = JaxEngine(spec, jax.tree_util.tree_map(jnp.asarray, params), num_steps=STEPS,
                     buckets=(1, 4), quant="int8")
    jeng_f = JaxEngine(spec, jax.tree_util.tree_map(jnp.asarray, params), num_steps=STEPS,
                       buckets=(1, 4))
    e_q, e_f, e_ours = jeng.embed(img), jeng_f.embed(img), engine.embed(img)
    assert e_ours.shape == (2, 24) and e_ours.dtype == np.float32
    assert np.abs(e_ours - e_q).max() <= 2 * np.abs(e_q - e_f).max()
    assert np.abs(e_q - e_f).max() > 1e-5


def test_padded_bucket_equals_exact_bucket(spec, params, engine):
    """Three requests padded to the bucket of 4 (the last row repeated)
    against the same three in an exact bucket of 3: the per-call conv amax
    is the same, so the three rows agree."""
    exact = make_engine(spec, params, buckets=(3,))
    rng = np.random.default_rng(4)
    img = exact._wire(rng.random((3, 32, 32, 3), dtype=np.float32))
    noise = rng.standard_normal((3, 16, 16, 4), dtype=np.float32)
    out3 = exact._recon(exact._place(img), t(noise)).numpy()
    out4 = engine._recon(engine._place(_pad_to(img, 4)), t(_pad_to(noise, 4))).numpy()
    np.testing.assert_allclose(out4[:3], out3, rtol=0, atol=1e-6)
    np.testing.assert_allclose(engine.embed(img)[:3], exact.embed(img), rtol=0, atol=1e-6)
    # a bucket mate that raises the amax moves the others (per-call, not per
    # sample, in both packages)
    loud = np.concatenate([img, np.full_like(img[:1], 255 if img.dtype == np.uint8 else 1.0)])
    loud_noise = np.concatenate([noise, 8 * noise[:1]])
    out_loud = engine._recon(engine._place(loud), t(loud_noise)).numpy()
    assert np.abs(out_loud[:3] - out3).max() > 0


def test_quant_knob_is_checked(spec, params):
    with pytest.raises(ValueError, match="none|int8"):
        make_engine(spec, params, quant="fp8")
    assert make_engine(spec, params, quant="none").int8_layers == {}
