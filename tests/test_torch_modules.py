"""Each ported module against its JAX function on the same weights and inputs.

Weights are the JAX package's init, loaded into the port's modules through
``genhancer_tpu_torch.weights.convert``; inputs come from numpy seeds.
Tolerances: float32 modules 1e-5 (only summation order differs between XLA
and PyTorch); the composed DiT/VAE/tower at float32 1e-4 (the same, over a
few layers); bfloat16 paths a stated fraction of the output scale, because
XLA and PyTorch round intermediate bf16 results at different points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genhancer_tpu.core import nn as jnn
from genhancer_tpu.core import rope as jrope
from genhancer_tpu.models import dit as jdit
from genhancer_tpu.models import vae as jvae
from genhancer_tpu.models.towers import clip as jclip
from genhancer_tpu.models.towers import projectors as jproj
from genhancer_tpu.tasks import conditioning as jcond
from genhancer_tpu.train import flow as jflow
from genhancer_tpu_torch.core import nn as tnn
from genhancer_tpu_torch.core import rope as trope
from genhancer_tpu_torch.models import dit as tdit
from genhancer_tpu_torch.models import vae as tvae
from genhancer_tpu_torch.models.towers import clip as tclip
from genhancer_tpu_torch.models.towers import projectors as tproj
from genhancer_tpu_torch.tasks import conditioning as tcond
from genhancer_tpu_torch.train import flow as tflow

from test_torch_parity import f32, jax_params, jax_spec, port_cfg, port_modules, t

torch.set_num_threads(1)


def close(got, ref, tol):
    np.testing.assert_allclose(f32(got), f32(ref), rtol=tol, atol=tol)


def close_scaled(got, ref, frac):
    """|got - ref| <= frac * max|ref| — for bf16 paths."""
    ref = f32(ref)
    err = np.abs(f32(got) - ref).max()
    assert err <= frac * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.fixture(scope="module")
def spec32():
    return jax_spec(compute_dtype=jnp.float32, dit_param_dtype=jnp.float32)


@pytest.fixture(scope="module")
def params32(spec32):
    return jax_params(spec32, seed=1)


@pytest.fixture(scope="module")
def mods32(spec32, params32):
    return port_modules(spec32, params32)


@pytest.fixture(scope="module")
def spec16():
    return jax_spec(compute_dtype=jnp.bfloat16, dit_param_dtype=jnp.bfloat16)


@pytest.fixture(scope="module")
def params16(spec16):
    return jax_params(spec16, seed=2)


@pytest.fixture(scope="module")
def mods16(spec16, params16):
    return port_modules(spec16, params16)


rng = np.random.default_rng


# --------------------------------------------------------------- rope

def test_rope_tables_and_ids():
    ids = rng(0).integers(0, 30, (2, 9, 3)).astype(np.float32)
    jc, js = jrope.multi_axis_rope(jnp.asarray(ids), (16, 56, 56), 10_000)
    tc, ts = trope.multi_axis_rope(t(ids), (16, 56, 56), 10_000)
    close(tc, jc, 1e-5)
    close(ts, js, 1e-5)
    c1, s1 = trope.rope_table(t(ids[..., 1]), 8, 10_000)
    jc1, js1 = jrope.rope_table(jnp.asarray(ids[..., 1]), 8, 10_000)
    close(c1, jc1, 1e-6)
    close(s1, js1, 1e-6)
    np.testing.assert_array_equal(f32(trope.spatial_ids(3, 5, t=2.0)),
                                  f32(jrope.spatial_ids(3, 5, t=2.0)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_interleaved_pairs(dtype):
    r = rng(1)
    x = jnp.asarray(r.standard_normal((2, 7, 3, 16), dtype=np.float32)).astype(dtype)
    ids = r.integers(0, 30, (2, 7, 3)).astype(np.float32)
    jc, js = jrope.multi_axis_rope(jnp.asarray(ids), (8, 4, 4), 10_000)
    tc, ts = trope.multi_axis_rope(t(ids), (8, 4, 4), 10_000)
    got = trope.apply_rope(t(np.asarray(x)), tc, ts)
    assert got.dtype == t(np.asarray(x)).dtype
    # the rotation is float32 math rounded once to the dtype
    close(got, jrope.apply_rope(x, jc, js), 1e-6 if dtype == "float32" else 8e-3)


# --------------------------------------------------------------- norms

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_rmsnorm(dtype):
    r = rng(2)
    x = jnp.asarray(r.standard_normal((3, 5, 32), dtype=np.float32) * 3 + 1).astype(dtype)
    w = r.standard_normal(32, dtype=np.float32)
    b = r.standard_normal(32, dtype=np.float32)
    ln = tnn.LayerNorm(32)
    ln.load_state_dict({"weight": t(w), "bias": t(b)})
    rms = tnn.RMSNorm(32)
    rms.load_state_dict({"scale": t(w)})
    tx = t(np.asarray(x))
    tol = 1e-5 if dtype == "float32" else 3e-2    # bf16: one ulp at |y| ~ 4
    with torch.no_grad():
        close(tnn.layernorm(None, tx), jnn.layernorm({}, x), tol)
        close(tnn.layernorm(ln, tx, eps=1e-5),
              jnn.layernorm({"weight": jnp.asarray(w), "bias": jnp.asarray(b)}, x, eps=1e-5), tol)
        close(tnn.rmsnorm(rms, tx), jnn.rmsnorm({"scale": jnp.asarray(w)}, x), tol)


def test_groupnorm_nchw_matches_nhwc():
    r = rng(3)
    x = r.standard_normal((2, 4, 5, 64), dtype=np.float32) * 2
    w = r.standard_normal(64, dtype=np.float32)
    b = r.standard_normal(64, dtype=np.float32)
    gn = tnn.GroupNorm(64)
    gn.load_state_dict({"weight": t(w), "bias": t(b)})
    ref = jnn.groupnorm({"weight": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x))
    with torch.no_grad():
        got = tnn.groupnorm(gn, t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    close(got, ref, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_timestep_embedding(dtype):
    ts = jnp.asarray(rng(4).random(5, dtype=np.float32)).astype(dtype)
    got = tnn.timestep_embedding(t(np.asarray(ts)), 256)
    assert got.dtype == torch.float32
    # t*1000 rounds alike in bf16; the float32 arguments reach 1000 rad,
    # where one ulp (6.1e-5) of a frequency difference moves cos/sin by that
    close(got, jnn.timestep_embedding(ts, 256), 1e-4)


def test_activations():
    x = rng(5).standard_normal(64, dtype=np.float32) * 3
    for name in ("gelu_tanh", "gelu", "quick_gelu", "silu"):
        close(tnn.ACTIVATIONS[name](t(x)), jnn.ACTIVATIONS[name](jnp.asarray(x)), 1e-6)


# ----------------------------------------------------------------- DiT

def _dit_inputs(cfg, seed=6, b=2, l_img=8):
    r = rng(seed)
    return dict(
        img=r.standard_normal((b, l_img, cfg.in_channels), dtype=np.float32),
        img_ids=r.integers(0, 4, (b, l_img, 3)).astype(np.float32),
        txt=r.standard_normal((b, 1, cfg.context_in_dim), dtype=np.float32),
        txt_ids=np.zeros((b, 1, 3), np.float32),
        timesteps=r.random(b, dtype=np.float32),
        y=r.standard_normal((b, cfg.vec_in_dim), dtype=np.float32),
        guidance=np.full((b,), 4.0, np.float32))


def _dit_pair(params, mods, cfg, dtype):
    inp = _dit_inputs(cfg)
    jin = {k: jnp.asarray(v) for k, v in inp.items()}
    jin["img"] = jin["img"].astype(dtype)
    jin["txt"] = jin["txt"].astype(dtype)
    tin = {k: t(np.asarray(v)) for k, v in jin.items()}
    ref = jdit.dit_forward(params["dit"], cfg, **jin)
    with torch.inference_mode():
        got = tdit.dit_forward(mods["dit"], port_cfg(cfg), **tin)
    assert got.dtype == tin["img"].dtype and got.shape == tin["img"].shape
    return got, ref


def test_dit_forward_f32(spec32, params32, mods32):
    got, ref = _dit_pair(params32, mods32, spec32.dit_cfg, jnp.float32)
    close(got, ref, 1e-4)


def test_dit_forward_bf16(spec16, params16, mods16):
    """bf16 weights and activations: within 3% of the output scale."""
    got, ref = _dit_pair(params16, mods16, spec16.dit_cfg, jnp.bfloat16)
    close_scaled(got, ref, 3e-2)


def test_pack_unpack_latent():
    x = rng(7).standard_normal((2, 8, 6, 4), dtype=np.float32)
    packed = tdit.pack_latent(t(x))
    np.testing.assert_array_equal(f32(packed), f32(jdit.pack_latent(jnp.asarray(x))))
    np.testing.assert_array_equal(f32(tdit.unpack_latent(packed, 8, 6)), x)


# ----------------------------------------------------------------- VAE

def test_vae_decode(spec32, params32, mods32):
    z = rng(8).standard_normal((2, 4, 4, spec32.vae_cfg.z_channels), dtype=np.float32)
    ref = jvae.vae_decode(params32["vae"], spec32.vae_cfg, jnp.asarray(z))
    with torch.inference_mode():
        got = tvae.vae_decode(mods32["vae"], port_cfg(spec32.vae_cfg), t(z))
    assert tuple(got.shape) == (2, 8, 8, 3)     # f2 tiny VAE
    close(got, ref, 1e-4)


def test_vae_encode_posterior_mean(spec32, params32, mods32):
    x = rng(9).random((2, 16, 16, 3), dtype=np.float32) * 2 - 1
    ref = jvae.vae_encode(params32["vae"], spec32.vae_cfg, jnp.asarray(x), sample=False)
    with torch.inference_mode():
        got = tvae.vae_encode(mods32["vae"], port_cfg(spec32.vae_cfg), t(x), sample=False)
    assert tuple(got.shape) == (2, 8, 8, spec32.vae_cfg.z_channels)
    close(got, ref, 1e-4)


# --------------------------------------------------------------- tower

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vision_forward_and_projection(spec32, params32, mods32, dtype):
    cfg = spec32.tower_cfg
    px = jnp.asarray(rng(10).standard_normal((2, 32, 32, 3), dtype=np.float32)).astype(dtype)
    jlast, jpool = jclip.vision_forward(params32["clip"]["model"]["vision_model"], px, cfg.vision)
    jproj_ = jnn.linear(params32["clip"]["model"]["visual_projection"], jpool)
    tower = mods32["clip"]["model"]
    with torch.inference_mode():
        last, pool = tclip.vision_forward(tower.vision_model, t(np.asarray(px)),
                                          port_cfg(cfg).vision)
        proj = tclip.visual_projection(tower, pool)
    assert tuple(last.shape) == (2, 5, 16) and tuple(proj.shape) == (2, 24)
    if dtype == "float32":
        close(last, jlast, 1e-4)
        close(pool, jpool, 1e-4)
        close(proj, jproj_, 1e-4)
    else:
        close_scaled(last, jlast, 3e-2)
        close_scaled(proj, jproj_, 3e-2)


def test_projector(spec32, params32, mods32):
    x = rng(11).standard_normal((3, 24), dtype=np.float32)
    for name in ("project_clip", "project_t5"):
        with torch.inference_mode():
            got = tproj.projector(mods32["clip"][name], t(x))
        close(got, jproj.projector(params32["clip"][name], jnp.asarray(x)), 1e-5)


def test_image_conditioning(spec32, params32, mods32):
    px = rng(12).random((2, 32, 32, 3), dtype=np.float32)
    ref = jcond.image_conditioning("clip", params32["clip"], jnp.asarray(px),
                                   spec32.tower_cfg, spec32.latent_hw,
                                   compute_dtype=jnp.float32)
    with torch.inference_mode():
        got = tcond.image_conditioning("clip", mods32["clip"], t(px),
                                       port_cfg(spec32.tower_cfg), spec32.latent_hw,
                                       compute_dtype=torch.float32)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape, k
        close(got[k], ref[k], 1e-4)
    # SigLIP is ported (tests/test_torch_siglip.py): its statistics are JAX's
    assert tcond.tower_stats("siglip") == jcond.tower_stats("siglip") == ((0.5,) * 3,) * 2


# ---------------------------------------------------------- sampling

@pytest.mark.parametrize("shift", [True, False])
def test_get_schedule(shift):
    assert tflow.get_schedule(20, 196, shift=shift) == jflow.get_schedule(20, 196, shift=shift)
    assert tflow.time_shift(0.7, 1.0, 0.3) == jflow.time_shift(0.7, 1.0, 0.3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_denoise_euler(spec32, params32, mods32, spec16, params16, mods16, dtype):
    """Three Euler steps of the tiny DiT from the same noise."""
    spec, params, mods = ((spec32, params32, mods32) if dtype == "float32"
                          else (spec16, params16, mods16))
    cfg = spec.dit_cfg
    inp = _dit_inputs(cfg, seed=13)
    jd = jnp.dtype(dtype)
    timesteps = jflow.get_schedule(3, inp["img"].shape[1])

    def jfn(x, tv, gv):
        return jdit.dit_forward(params["dit"], cfg, img=x, img_ids=jnp.asarray(inp["img_ids"]),
                                txt=jnp.asarray(inp["txt"]).astype(jd),
                                txt_ids=jnp.asarray(inp["txt_ids"]), timesteps=tv,
                                y=jnp.asarray(inp["y"]).astype(jd), guidance=gv)

    tcfg = port_cfg(cfg)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16

    def tfn(x, tv, gv):
        return tdit.dit_forward(mods["dit"], tcfg, img=x, img_ids=t(inp["img_ids"]),
                                txt=t(inp["txt"]).to(tdt), txt_ids=t(inp["txt_ids"]),
                                timesteps=tv, y=t(inp["y"]).to(tdt), guidance=gv)

    ref = jflow.denoise_euler(jfn, jnp.asarray(inp["img"]).astype(jd), timesteps)
    with torch.inference_mode():
        got = tflow.denoise_euler(tfn, t(inp["img"]).to(tdt), timesteps)
    if dtype == "float32":
        close(got, ref, 1e-4)
    else:
        close_scaled(got, ref, 3e-2)
