"""K1/K2 fused short attention: the port's wrappers against the JAX Pallas
kernels (genhancer_tpu/core/pallas/short_attention.py) in interpret mode.

On CPU tensors the wrappers run their plain versions; the launch counters
must stay at 0 there.  Tolerances: float32 2e-5 (the JAX package's own
Pallas-vs-XLA bound; only summation order differs); bfloat16 1.6e-2 — two
bf16 ulps at |o| < 1: the Pallas kernel and the plain version round RoPE
outputs and probabilities to bf16 at the same points, but a float32
summation-order difference can flip a rounding.  The bfloat16 rounding
points themselves (K1's o, K1b's dq, dk, dv) are held to mean|port - jax| /
mean|jax| <= 2e-4, with controls that round p elsewhere and must miss it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genhancer_tpu.core.pallas.short_attention import fused_attention as jax_fused_attention
from genhancer_tpu.core.pallas.short_attention import fused_rope_attention as jax_fused_rope
from genhancer_tpu.core.rope import multi_axis_rope as jax_multi_axis_rope
from genhancer_tpu_torch.core import attention as A
from genhancer_tpu_torch.core.kernels import short_attention as K
from genhancer_tpu_torch.core.kernels import flash_attention as F
from genhancer_tpu_torch.core.rope import apply_rope, multi_axis_rope

from test_torch_flash_attention import ROUNDING_BOUND, _mean_rel, _single_pass_fwd
from test_torch_parity import f32, t

torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 1.6e-2}


def _inputs(seed, b, l, h, d, dtype):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, l, h, d), dtype=np.float32) for _ in range(3))
    ids = rng.integers(0, 20, (b, l, 3)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, k, v))
    tq, tk, tv = (t(np.asarray(x)) for x in (jq, jk, jv))
    return (jq, jk, jv, jnp.asarray(ids)), (tq, tk, tv, t(ids))


def _axes(d):
    return (d // 2, d // 4, d // 4)


@pytest.fixture(autouse=True)
def zero_counters():
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0
    yield
    assert K.LAUNCHES == {"fused_rope_attention": 0, "fused_attention": 0,
                          "fused_rope_attention_bwd": 0, "fused_attention_bwd": 0}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l", [13, 65])
def test_fused_rope_attention_matches_pallas(dtype, l):
    (jq, jk, jv, jids), (tq, tk, tv, tids) = _inputs(l, 2, l, 4, 16, dtype)
    jcos, jsin = jax_multi_axis_rope(jids, _axes(16), 10_000)
    cos, sin = multi_axis_rope(tids, _axes(16), 10_000)
    np.testing.assert_allclose(f32(cos), f32(jcos), rtol=1e-6, atol=1e-6)
    ref = jax_fused_rope(jq, jk, jv, jcos, jsin)
    out = K.fused_rope_attention(tq, tk, tv, cos, sin)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    np.testing.assert_allclose(f32(out), f32(ref), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l", [13, 65])
def test_fused_attention_matches_pallas(dtype, l):
    (jq, jk, jv, _), (tq, tk, tv, _) = _inputs(100 + l, 2, l, 4, 8, dtype)
    ref = jax_fused_attention(jq, jk, jv)
    out = K.fused_attention(tq, tk, tv)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    np.testing.assert_allclose(f32(out), f32(ref), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("l, h, d", [(197, 2, 128), (257, 2, 64)])
def test_bf16_rounding_points_match_pallas(l, h, d):
    """K1 normalises p before rounding it (``_attn_body``); K1b rounds p
    before dV, ds before dQ and dK, and d_rq, d_rk before and after the
    un-rotation (``_bwd_body``, ``_bwd_kernel``).  A rounding moved elsewhere
    shifts about half the outputs by one bf16 ulp, under the max-based
    bound, so the mean error is held to 2e-4 (as on the card), and the
    other rounding points must miss it: p rounded before it is normalised
    for o, p kept in float32 (K5b's point) for dv."""
    import jax
    rng = np.random.default_rng(l + d)
    jq, jk, jv, jdo = (jnp.asarray(rng.standard_normal((1, l, h, d), dtype=np.float32))
                       .astype(jnp.bfloat16) for _ in range(4))
    ids = rng.integers(0, 20, (1, l, 3)).astype(np.float32)
    jcos, jsin = jax_multi_axis_rope(jnp.asarray(ids), _axes(d), 10_000)
    ref_o, vjp = jax.vjp(lambda q, k, v: jax_fused_rope(q, k, v, jcos, jsin), jq, jk, jv)
    ref_grads = vjp(jdo)
    q, k, v, do = (t(np.asarray(x)) for x in (jq, jk, jv, jdo))
    cos, sin = multi_axis_rope(t(ids), _axes(d), 10_000)
    rq, rk = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    o = K.fused_rope_attention_ref(q, k, v, cos, sin)
    assert _mean_rel(o, ref_o) <= ROUNDING_BOUND < _mean_rel(_single_pass_fwd(rq, rk, v), ref_o)
    grads = K.fused_rope_attention_bwd_ref(q, k, v, o, do, cos, sin)
    for g, r in zip(grads, ref_grads):
        assert _mean_rel(g, r) <= ROUNDING_BOUND
    lse = F.flash_attention_fwd_ref(rq, rk, v)[1]
    ctl = F.flash_attention_bwd_ref(rq, rk, v, o, lse, do)[2]
    assert _mean_rel(ctl, ref_grads[2]) > ROUNDING_BOUND


def test_block_rows_fill_the_card():
    """The bf16 forward takes 64-row blocks where 128-row ones would leave
    SMs of the card idle (serving at B=1), else 128."""
    assert K.block_rows(1, 197, 24, 132) == 64          # 48 blocks of 128 rows
    assert K.block_rows(8, 197, 24, 132) == 128         # 384
    assert K.block_rows(2, 257, 16, 132) == 64          # 96
    assert K.block_rows(4, 257, 16, 132) == 128         # 192


def test_strided_views_match_contiguous():
    """The DiT's single blocks hand the kernels strided views of one fused
    projection; the result must not depend on the layout."""
    rng = np.random.default_rng(5)
    qkv = t(rng.standard_normal((2, 13, 3 * 4 * 8), dtype=np.float32))
    q, k, v = (x.reshape(2, 13, 4, 8) for x in qkv.split(32, dim=-1))
    assert v.stride(1) == 96
    np.testing.assert_array_equal(f32(K.fused_attention(q, k, v)),
                                  f32(K.fused_attention(q.contiguous(), k.contiguous(),
                                                        v.contiguous())))


def test_dispatch_short_and_long_on_cpu():
    """attention/sdpa_auto route L <= FUSED_MAX_SEQ to K1/K2 (plain versions
    on CPU tensors) and longer sequences to sdpa_ref on the CPU."""
    (_, _, _, _), (tq, tk, tv, tids) = _inputs(1, 1, 13, 2, 16, "float32")
    cos, sin = multi_axis_rope(tids, _axes(16), 10_000)
    np.testing.assert_array_equal(
        f32(A.attention(tq, tk, tv, cos, sin)),
        f32(K.fused_rope_attention_ref(tq, tk, tv, cos, sin).reshape(1, 13, 32)))
    long_q = torch.zeros((1, A.FUSED_MAX_SEQ + 1, 1, 8))
    out = A.sdpa_auto(long_q, long_q, long_q)
    assert out.shape == long_q.shape
    assert A.FUSED_MAX_SEQ == 600


def test_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor off the CPU launches the kernel or raises — here the meta
    device, which has no kernel, must raise rather than compute."""
    q = torch.empty((1, 4, 2, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        K.fused_attention(q, q, q)
    cos = torch.empty((1, 4, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        K.fused_rope_attention(q, q, q, cos, cos)
