"""K1b/K2b: gradients of the port's fused attention against ``jax.grad`` of
the JAX Pallas kernels (genhancer_tpu/core/pallas/short_attention.py, in
interpret mode, as tests/test_flash_attention.py runs them).

On CPU tensors the port's ``autograd.Function``s run the plain forward and
the plain backward (``fused_*_bwd_ref``), which mirror ``_bwd_body`` line
for line; the launch counters must stay at 0.  Tolerances, on
max|port - jax| / max(1, max|jax|): float32 1e-5 (only the float32
summation order differs); bfloat16 2e-2 (ds and the rotated gradients are
rounded to bfloat16 at the same points on both sides, but a float32
summation-order difference can flip a rounding, which then enters a sum
over L terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genhancer_tpu.core.pallas.short_attention import fused_attention as jax_fused_attention
from genhancer_tpu.core.pallas.short_attention import fused_rope_attention as jax_fused_rope
from genhancer_tpu.core.rope import multi_axis_rope as jax_multi_axis_rope
from genhancer_tpu_torch.core.kernels import short_attention as K
from genhancer_tpu_torch.core.rope import multi_axis_rope

from test_torch_parity import f32, t

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def zero_counters():
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0
    yield
    assert all(n == 0 for n in K.LAUNCHES.values()), K.LAUNCHES


def _inputs(seed, b, l, h, d, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, l, h, d), dtype=np.float32) for _ in range(4)]
    ids = rng.integers(0, 20, (b, l, 3)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jx = [jnp.asarray(x).astype(jdt) for x in arrs]
    tx = [t(np.asarray(x)) for x in jx]
    return jx, tx, ids


def _close(ours, ref, dtype, what):
    ours, ref = f32(ours), f32(ref)
    err = np.abs(ours - ref).max() / max(1.0, np.abs(ref).max())
    assert err <= TOL[dtype], f"{what}: {err:.3e} > {TOL[dtype]}"


def _axes(d):
    return (d // 2, d // 4, d // 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l", [13, 65])
def test_rope_attention_grads_match_pallas(dtype, l):
    (jq, jk, jv, jdo), (tq, tk, tv, tdo), ids = _inputs(l, 2, l, 4, 16, dtype)
    jcos, jsin = jax_multi_axis_rope(jnp.asarray(ids), _axes(16), 10_000)
    cos, sin = multi_axis_rope(t(ids), _axes(16), 10_000)
    _, vjp = jax.vjp(lambda q, k, v: jax_fused_rope(q, k, v, jcos, jsin), jq, jk, jv)
    ref = vjp(jdo)
    q, k, v = (x.clone().requires_grad_(True) for x in (tq, tk, tv))
    out = K.fused_rope_attention(q, k, v, cos, sin)
    grads = torch.autograd.grad(out, (q, k, v), grad_outputs=tdo)
    for name, g, r in zip("qkv", grads, ref):
        assert g.dtype == tq.dtype and g.shape == tq.shape
        _close(g, r, dtype, f"d{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l", [13, 65])
def test_attention_grads_match_pallas(dtype, l):
    (jq, jk, jv, jdo), (tq, tk, tv, tdo), _ = _inputs(200 + l, 2, l, 4, 8, dtype)
    _, vjp = jax.vjp(jax_fused_attention, jq, jk, jv)
    ref = vjp(jdo)
    q, k, v = (x.clone().requires_grad_(True) for x in (tq, tk, tv))
    grads = torch.autograd.grad(K.fused_attention(q, k, v), (q, k, v), grad_outputs=tdo)
    for name, g, r in zip("qkv", grads, ref):
        _close(g, r, dtype, f"d{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_is_the_autograd_backward(dtype):
    """The Functions' CPU backward is exactly the explicit plain version."""
    (_, _, _, _), (q, k, v, do), ids = _inputs(3, 1, 13, 2, 16, dtype)
    cos, sin = multi_axis_rope(t(ids), _axes(16), 10_000)
    o = K.fused_rope_attention_ref(q, k, v, cos, sin)
    qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
    got = torch.autograd.grad(K.fused_rope_attention(qq, kk, vv, cos, sin), (qq, kk, vv), do)
    want = K.fused_rope_attention_bwd_ref(q, k, v, o, do, cos, sin)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_strided_views_route_gradients_to_the_projection():
    """The DiT splits one fused projection into strided q/k/v views; the
    backward's contiguous dq/dk/dv must reach the projection through them."""
    rng = np.random.default_rng(9)
    b, l, h, d = 2, 13, 4, 16
    fused = t(rng.standard_normal((b, l, 3 * h * d + 8), dtype=np.float32)).requires_grad_(True)
    ids = t(rng.integers(0, 20, (b, l, 3)).astype(np.float32))
    cos, sin = multi_axis_rope(ids, _axes(d), 10_000)
    do = t(rng.standard_normal((b, l, h, d), dtype=np.float32))
    q, k, v = (x.reshape(b, l, h, d) for x in fused[..., : 3 * h * d].split(h * d, dim=-1))
    assert q.stride(1) == 3 * h * d + 8
    (g_fused,) = torch.autograd.grad(K.fused_rope_attention(q, k, v, cos, sin), fused, do)
    qc, kc, vc = (x.detach().contiguous().requires_grad_(True) for x in (q, k, v))
    gq, gk, gv = torch.autograd.grad(K.fused_rope_attention(qc, kc, vc, cos, sin),
                                     (qc, kc, vc), do)
    want = torch.cat([gq.reshape(b, l, -1), gk.reshape(b, l, -1), gv.reshape(b, l, -1),
                      torch.zeros(b, l, 8)], dim=-1)
    torch.testing.assert_close(g_fused, want, rtol=0, atol=0)
