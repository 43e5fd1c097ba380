"""The port's int8 stack (genhancer_tpu_torch/core/quant.py and the plain
versions of K7 and K8) against the JAX package (genhancer_tpu/core/quant.py,
core/pallas/rowquant.py, core/pallas/int8_dw.py) on the same numpy inputs.

Bounds, each with its reason:
  * the quantizers (``quantize_weight``, ``quantize_activation_rows`` with
    and without the column scale, ``quantize_activation_tensor``,
    ``_quantize_cols``) are bit-identical to eager JAX: the same float32
    amax, IEEE division and round-half-even on both sides;
  * K7's plain version against the Pallas ``rowquant`` (interpret mode):
    codes within one at a rate below 5e-3 and scales within 2e-7 relative —
    the JAX test's own contract (``tests/test_quant.py``): inside the
    interpreted kernel XLA may turn ``/ 127`` into ``* (1 / 127)``;
  * the SwitchBack functions (forward, dx and dW, float32) and
    ``linear_int8_base``/``conv2d_int8`` within 1e-5 of max|JAX|: the int8
    codes and int32 sums agree exactly, the float32 dequantization and the
    float32 dW sums round in another order;
  * K8's plain version against the Pallas ``int8_dw`` within 1e-5 of
    max|JAX|, ragged T (300, 777) included: exact codes and int32 block
    sums, float32 partials added in the same t order.  Each 512-row block's
    column maxima are planted at 127/8, where ``amax / 127`` and XLA's
    ``amax * (1 / 127)`` (the interpreted kernel runs under jit) are the
    same float: with free maxima a scale one ulp off flips a code now and
    then, one code step of one product (about 1e-3 of max|dW|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genhancer_tpu.core import quant as jq
from genhancer_tpu.core.pallas import int8_dw as jdw
from genhancer_tpu.core.pallas import rowquant as jrq
from genhancer_tpu_torch.core import nn as tnn_port
from genhancer_tpu_torch.core import quant as tq
from genhancer_tpu_torch.core.kernels import int8_dw as K8
from genhancer_tpu_torch.core.kernels import rowquant as K7

from test_torch_parity import f32, t

torch.set_num_threads(1)

REL = 1e-5


def _rel(ours, ref):
    ours, ref = f32(ours), np.asarray(ref, np.float32)
    return np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30)


def _same(ours, ref):
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("shape,axis", [((96, 160), 0), ((3, 3, 24, 40), 3)])
def test_quantize_weight_bit_identical(shape, axis):
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32) * 0.05
    q, s = jq.quantize_weight(jnp.asarray(w), axis=axis)
    wt = t(w) if len(shape) == 2 else t(w).permute(3, 2, 0, 1)     # HWIO -> OIHW
    tq_, ts = tq.quantize_weight(wt, axis=0)
    if len(shape) == 4:
        tq_, ts = tq_.permute(2, 3, 1, 0), ts.reshape(1, 1, 1, -1)
    _same(tq_.contiguous(), q)
    _same(ts.contiguous(), s)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_cs", [False, True])
def test_quantize_activation_rows_bit_identical(dtype, with_cs):
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((2, 37, 200)), getattr(jnp, dtype))
    cs = np.exp(rng.standard_normal(200)).astype(np.float32) if with_cs else None
    q, s = jq.quantize_activation_rows(x, None if cs is None else jnp.asarray(cs))
    tq_, ts = tq.quantize_activation_rows(t(np.asarray(x)), None if cs is None else t(cs))
    _same(tq_, q)
    _same(ts, s)


def test_quantize_tensor_and_cols_bit_identical():
    x = np.random.default_rng(2).standard_normal((2, 7, 9, 24)).astype(np.float32)
    q, s = jq.quantize_activation_tensor(jnp.asarray(x))
    tq_, ts = tq.quantize_activation_tensor(t(x))
    _same(tq_, q)
    assert float(ts) == float(s)
    q, s = jq._quantize_cols(jnp.asarray(x.reshape(-1, 24)))
    tq_, ts = tq._quantize_cols(t(x.reshape(-1, 24)))
    _same(tq_, q)
    _same(ts, s)


@pytest.mark.parametrize("dtype,with_cs", [("float32", False), ("bfloat16", True)])
def test_rowquant_plain_vs_pallas(monkeypatch, dtype, with_cs):
    monkeypatch.setattr(jrq, "_INTERPRET", True)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((160, 384)), getattr(jnp, dtype))
    cs = np.exp(rng.standard_normal(384)).astype(np.float32) if with_cs else None
    q, s = jrq.rowquant(x, None if cs is None else jnp.asarray(cs))
    tq_, ts = K7.rowquant(t(np.asarray(x)), None if cs is None else t(cs))
    np.testing.assert_allclose(ts.numpy(), np.asarray(s), rtol=2e-7)
    d = np.abs(tq_.numpy().astype(np.int32) - np.asarray(q, np.int32))
    assert d.max() <= 1 and (d != 0).mean() < 5e-3, (d.max(), (d != 0).mean())


# (JAX function, the port's dW kind, cached)
SWITCHBACK = {
    "switchback_linear": (jq.switchback_linear, "bf16", False),
    "switchback_linear_cached": (jq.switchback_linear_cached, "bf16", True),
    "switchback_linear_dw": (jq.switchback_linear_dw, "int8_dw", False),
    "switchback_linear_cached_dw": (jq.switchback_linear_cached_dw, "int8_dw", True),
    "switchback_linear_full": (jq.switchback_linear_full, "cols", False),
    "switchback_linear_full_cached": (jq.switchback_linear_full_cached, "cols", True),
}


@pytest.mark.parametrize("name", list(SWITCHBACK))
def test_switchback_functions_match_jax_vjp(monkeypatch, name):
    """Forward, dx and dW against ``jax.vjp``; T = 300 tokens (a ragged
    512-row block for the int8_dw variants, whose O and I tile to 128)."""
    jfn, dw, cached = SWITCHBACK[name]
    monkeypatch.setattr(jdw, "_INTERPRET", True)
    monkeypatch.setenv("GENHANCER_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 150, 256)).astype(np.float32)
    w = (rng.standard_normal((384, 256)) * 0.05).astype(np.float32)
    g = rng.standard_normal((2, 150, 384)).astype(np.float32)
    wq, ws = jq.quantize_weight(jnp.asarray(w), axis=0)
    extra = (wq, ws[:, 0]) if cached else ()
    y, vjp = jax.vjp(lambda a, b: jfn(a, b, *extra), jnp.asarray(x), jnp.asarray(w))
    jdx, jdw_ = vjp(jnp.asarray(g))

    xt = t(x).requires_grad_(True)
    wt = t(w).requires_grad_(True)
    yt = tq.switchback(xt, wt, *(t(np.asarray(a)) for a in extra), dw=dw)
    yt.backward(t(g))
    for ours, ref in ((yt, y), (xt.grad, jdx), (wt.grad, jdw_)):
        assert _rel(ours, ref) <= REL, (name, _rel(ours, ref))


def test_int8_matmul_ste_matches_jax_vjp():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 17, 96)).astype(np.float32)
    w = (rng.standard_normal((80, 96)) * 0.1).astype(np.float32)
    g = rng.standard_normal((3, 17, 80)).astype(np.float32)
    wq, ws = jq.quantize_weight(jnp.asarray(w), axis=0)
    y, vjp = jax.vjp(lambda a: jq.linear_int8_base({"weight_q": wq, "w_scale": ws}, a),
                     jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    lin = tnn_port.Int8Layer(t(np.asarray(wq)), t(np.asarray(ws)))
    xt = t(x).requires_grad_(True)
    yt = tq.linear_int8_base(lin, xt)
    yt.backward(t(g))
    assert _rel(yt, y) <= REL and _rel(xt.grad, jdx) <= REL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_with_bias_matches_jax(dtype):
    """``core.nn.linear`` on an int8 node: the product in x's dtype, then
    the bias in that dtype (bfloat16: within one bf16 ulp, 8e-3)."""
    from genhancer_tpu.core import nn as jnn
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.standard_normal((4, 9, 64)), getattr(jnp, dtype))
    w = (rng.standard_normal((72, 64)) * 0.1).astype(np.float32)
    b = rng.standard_normal(72).astype(np.float32)
    wq, ws = jq.quantize_weight(jnp.asarray(w), axis=0)
    ref = jnn.linear({"weight_q": wq, "w_scale": ws, "bias": jnp.asarray(b)}, x)
    lin = tnn_port.Int8Layer(t(np.asarray(wq)), t(np.asarray(ws)), torch.nn.Parameter(t(b)))
    ours = tnn_port.linear(lin, t(np.asarray(x)))
    assert ours.dtype == getattr(torch, dtype)
    assert _rel(ours, ref) <= (REL if dtype == "float32" else 8e-3)


@pytest.mark.parametrize("kernel,stride,pad", [(3, 1, "SAME"), (1, 1, "SAME"), (3, 2, "VALID")])
def test_conv2d_int8_matches_jax(kernel, stride, pad):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 11, 13, 24)).astype(np.float32)       # NHWC
    w = (rng.standard_normal((kernel, kernel, 24, 40)) * 0.1).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32)
    wq, ws = jq.quantize_weight(jnp.asarray(w), axis=3)
    ref = jq.conv2d_int8({"weight_q": wq, "w_scale": ws, "bias": jnp.asarray(b)},
                         jnp.asarray(x), stride=stride, padding=pad)
    conv = tnn_port.Int8Layer(t(np.asarray(wq)).permute(3, 2, 0, 1).contiguous(),
                               t(np.asarray(ws)), torch.nn.Parameter(t(b)))
    ours = tnn_port.conv2d(conv, t(x).permute(0, 3, 1, 2), stride=stride,
                           padding=0 if pad == "VALID" else None)
    assert _rel(ours.permute(0, 2, 3, 1), ref) <= REL


@pytest.mark.parametrize("T,O,I", [(1024, 128, 256), (300, 256, 128), (777, 128, 384),
                                   (32, 128, 256), (513, 256, 768)])
def test_int8_dw_plain_vs_pallas(monkeypatch, T, O, I):
    monkeypatch.setattr(jdw, "_INTERPRET", True)
    rng = np.random.default_rng(8)
    g, x = (rng.uniform(-15.0, 15.0, (T, c)).astype(np.float32) for c in (O, I))
    for a in (g, x):
        a[::512] = 15.875 * np.sign(rng.standard_normal((a[::512].shape)))
    g, x = jnp.asarray(g, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16)
    ref = jdw.int8_dw(g, x, out_dtype=jnp.float32)
    ours = K8.int8_dw(t(np.asarray(g)), t(np.asarray(x)), torch.float32)
    assert ours.shape == (O, I) and _rel(ours, ref) <= REL
    assert K8.dw_supported(T, O, I) == jdw.dw_supported(T, O, I)


@pytest.mark.parametrize("T", [32, 513])
def test_block_codes_match_eager_jax(T):
    """The plain version of K8's quantization pass, in the kernel's K-major
    workspace (codes [C, Tp], t contiguous, zero past T; scales [nT, C]),
    against the TPU kernel's per-block quantization (``_dw_kernel:67-70``) in
    eager JAX, bit for bit; and the workspace's block products, summed in
    the kernel's association, are ``int8_dw_ref``'s dW bit for bit."""
    rng = np.random.default_rng(9)
    g = rng.standard_normal((T, 128)).astype(np.float32)
    x = rng.standard_normal((T, 256)).astype(np.float32)
    dw, codes = K8.int8_dw_with_codes(t(g), t(x), torch.float32)
    blocks = list(range(0, T, 512))
    for a, q, s in ((g, codes.gq, codes.sg), (x, codes.xq, codes.sx)):
        assert q.shape == (a.shape[1], -(-T // 128) * 128) and s.shape == (len(blocks), a.shape[1])
        assert not q[:, T:].any()
        for k, t0 in enumerate(blocks):
            blk = jnp.asarray(a[t0:t0 + 512])
            js = jnp.maximum(jnp.max(jnp.abs(blk), axis=0, keepdims=True), 1e-12) / 127.0
            jcode = jnp.clip(jnp.round(blk / js), -127, 127).astype(jnp.int8)
            np.testing.assert_array_equal(s[k].numpy(), np.asarray(js)[0])
            np.testing.assert_array_equal(q[:, t0:t0 + blk.shape[0]].numpy(), np.asarray(jcode).T)
    acc = None
    for k, t0 in enumerate(blocks):
        gq, xq = (c[:, t0:t0 + 512].to(torch.float64) for c in (codes.gq, codes.xq))
        part = ((gq @ xq.t()).to(torch.float32) * codes.sg[k][:, None]) * codes.sx[k][None, :]
        acc = part if acc is None else acc + part
    assert torch.equal(acc, dw)


def _tiny_tower_and_vae():
    """A tower with linears of 64 (quantized at min_features 64), some
    narrower ones, and a VAE with 16-channel convs (quantized at 16)."""
    from test_torch_parity import jax_params, port_cfg
    import dataclasses
    from genhancer_tpu.models import vae as jvae
    from genhancer_tpu.models.towers import clip as jclip
    from genhancer_tpu.tasks import image as jimage
    from test_torch_parity import TINY_DIT, TINY_TOWER, jax_spec
    tower = dataclasses.replace(
        TINY_TOWER, vision=dataclasses.replace(TINY_TOWER.vision, hidden_size=64,
                                               intermediate_size=48),
        projection_dim=72)
    spec = dataclasses.replace(jax_spec(), tower_cfg=tower,
                               vae_cfg=jvae.VAEConfig(resolution=32, ch=8, ch_mult=(1, 2),
                                                      num_res_blocks=1, z_channels=4))
    return spec, jax_params(spec)


def test_surgery_selects_the_jax_paths():
    """Module surgery and ``switchback_cache_paths`` pick the same flat
    paths as the JAX tree functions on the same tiny trees."""
    from genhancer_tpu.train.state import flatten_params
    from genhancer_tpu_torch.tasks import image as timage
    from genhancer_tpu_torch.weights.convert import load_jax_params
    from test_torch_parity import port_spec
    spec, params = _tiny_tower_and_vae()
    jt = flatten_params(jq.quantize_linear_tree(params["clip"]["model"]))
    jv = flatten_params(jq.quantize_conv_tree(params["vae"]["encoder"], min_channels=16))
    mods = timage.build_modules(port_spec(spec))
    load_jax_params(mods, params)
    tower_paths = tq.quantize_linear_tree(mods["clip"]["model"])
    vae_paths = tq.quantize_conv_tree(mods["vae"].encoder, 16)
    assert {p + ".weight_q" for p in tower_paths} == {k for k in jt if k.endswith("weight_q")}
    assert {p + ".weight_q" for p in vae_paths} == {k for k in jv if k.endswith("weight_q")}
    assert tower_paths and vae_paths and "visual_projection" in tower_paths
    # the port's int8 buffers hold the JAX codes and scales
    sd = mods["clip"]["model"].state_dict()
    for k in jt:
        if k.endswith(("weight_q", "w_scale")):
            np.testing.assert_array_equal(sd[k].numpy(), np.asarray(jt[k]))
    sd = mods["vae"].encoder.state_dict()
    for k in jv:
        if k.endswith("w_scale"):
            np.testing.assert_array_equal(sd[k].numpy(), np.asarray(jv[k]))
    # SwitchBack's cache: a DiT wide enough for some linears to reach 512
    flat = {"dit.a.weight": torch.zeros(512, 640), "dit.b.weight": torch.zeros(64, 512),
            "dit.c.bias": torch.zeros(512), "clip.d.weight": torch.zeros(512, 512),
            "dit.e.weight": torch.zeros(1024, 512)}
    jflat = {k: jnp.zeros(v.shape) for k, v in flat.items()}
    assert tq.switchback_cache_paths(flat) == jq.switchback_cache_paths(jflat)
    assert tq.SWITCHBACK_MIN_DIM == jq.SWITCHBACK_MIN_DIM
    assert tq.INT8_CONV_MIN_CH == jq.INT8_CONV_MIN_CH
