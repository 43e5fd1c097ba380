"""K5/K5b: the port's flash attention against the JAX Pallas kernel
(genhancer_tpu/core/pallas/flash_attention.py, in interpret mode, as
tests/test_flash_attention.py runs it) — the forward and ``jax.vjp``.

On CPU tensors the port's ``autograd.Function`` runs the plain forward and
the plain backward (``flash_attention_fwd_ref``/``_bwd_ref``), which mirror
``_fwd_kernel`` and ``_dq_kernel``/``_dkv_kernel`` line for line; the launch
counters must stay at 0.  Tolerances, on max|port - jax| / max(1,
max|jax|): float32 1e-5 (only the float32 summation order differs);
bfloat16 2e-2 (p and ds are rounded to bfloat16 at the same points on both
sides, but a float32 summation-order difference can flip a rounding, which
then enters a sum over L terms).  The bfloat16 rounding points themselves
are held to mean|port - jax| / mean|jax| <= 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genhancer_tpu.core.pallas.flash_attention import flash_attention as jax_flash
from genhancer_tpu_torch.core import attention as A
from genhancer_tpu_torch.core.kernels import flash_attention as F
from genhancer_tpu_torch.core.kernels import short_attention as K

from test_torch_parity import f32, t

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
ROUNDING_BOUND = 2e-4


@pytest.fixture(autouse=True)
def zero_counters():
    for k in F.LAUNCHES:
        F.LAUNCHES[k] = 0
    yield
    assert all(n == 0 for n in F.LAUNCHES.values()), F.LAUNCHES


def _inputs(seed, b, l, h, d, dtype):
    rng = np.random.default_rng(seed)
    jx = [jnp.asarray(rng.standard_normal((b, l, h, d), dtype=np.float32)).astype(dtype)
          for _ in range(4)]
    return jx, [t(np.asarray(x)) for x in jx]


def _close(ours, ref, dtype, what):
    ours, ref = f32(ours), f32(ref)
    err = np.abs(ours - ref).max() / max(1.0, np.abs(ref).max())
    assert err <= TOL[dtype], f"{what}: {err:.3e} > {TOL[dtype]}"


@pytest.mark.parametrize("l, h, d, dtype", [
    (600, 2, 64, "float32"), (600, 1, 128, "bfloat16"),
    (729, 2, 72, "float32"), (729, 2, 72, "bfloat16"),
    (964, 1, 128, "float32"), (964, 1, 128, "bfloat16"),
])
def test_forward_and_grads_match_pallas(l, h, d, dtype):
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(l + d, 1, l, h, d, dtype)
    ref_o, vjp = jax.vjp(jax_flash, jq, jk, jv)
    ref = vjp(jdo)
    q, k, v = (x.clone().requires_grad_(True) for x in (tq, tk, tv))
    out = F.flash_attention(q, k, v)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    _close(out, ref_o, dtype, "o")
    grads = torch.autograd.grad(out, (q, k, v), grad_outputs=tdo)
    for name, g, r in zip("qkv", grads, ref):
        assert g.dtype == tq.dtype and g.shape == tq.shape and g.is_contiguous()
        _close(g, r, dtype, f"d{name}")


def test_lse_matches_the_pallas_residual():
    """The plain forward's row log-sum-exp is the kernel's VJP residual."""
    from genhancer_tpu.core.pallas.flash_attention import _fwd
    (jq, jk, jv, _), (tq, tk, tv, _) = _inputs(5, 2, 613, 2, 64, "float32")
    _, jlse = _fwd(jq, jk, jv, 256)
    _, lse = F.flash_attention_fwd_ref(tq, tk, tv)
    assert lse.shape == (2, 2, 613) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :, :613, 0], rtol=1e-6)


def _mean_rel(ours, ref):
    ours, ref = f32(ours), f32(ref)
    return np.abs(ours - ref).mean() / np.abs(ref).mean()


def _single_pass_fwd(q, k, v):
    """K1/K2's rounding point: exp(s - max) rounded to v's dtype before PV,
    divided by the row sum after."""
    s = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) / q.shape[-1] ** 0.5
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bhlm,bmhd->blhd", e.to(v.dtype).float(), v.float())
    return (o / e.sum(dim=-1).permute(0, 2, 1)[..., None]).to(q.dtype)


@pytest.mark.parametrize("l, h, d", [(729, 2, 72), (964, 1, 128)])
def test_bf16_rounding_points_match_pallas(l, h, d):
    """K5 rounds p after normalising it, and K5b's dv keeps p in float32.
    A rounding moved elsewhere shifts about half the outputs by one bf16 ulp,
    under the max-based bound, so the mean error is held to 2e-4 (as on the
    card), and the other rounding points must miss it: the single-pass
    forward, and K2b's plain backward, which rounds p before p^T dO."""
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(l + d + 1, 1, l, h, d, "bfloat16")
    ref_o, vjp = jax.vjp(jax_flash, jq, jk, jv)
    ref_dv = vjp(jdo)[2]
    o, lse = F.flash_attention_fwd_ref(q, k, v)
    dv = F.flash_attention_bwd_ref(q, k, v, o, lse, do)[2]
    assert _mean_rel(o, ref_o) <= ROUNDING_BOUND < _mean_rel(_single_pass_fwd(q, k, v), ref_o)
    ctl = K.fused_attention_bwd_ref(q, k, v, o, do)[2]
    assert _mean_rel(dv, ref_dv) <= ROUNDING_BOUND < _mean_rel(ctl, ref_dv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_is_the_autograd_backward(dtype):
    """The Function's CPU backward is exactly the explicit plain version."""
    _, (q, k, v, do) = _inputs(3, 1, 37, 2, 16, dtype)
    o, lse = F.flash_attention_fwd_ref(q, k, v)
    qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
    got = torch.autograd.grad(F.flash_attention(qq, kk, vv), (qq, kk, vv), do)
    want = F.flash_attention_bwd_ref(q, k, v, o, lse, do)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_dispatch_routes_long_sequences_to_flash(monkeypatch):
    """attention/sdpa/sdpa_auto at L >= 600 reach flash_attention (on the CPU,
    its plain version); shorter ones keep K1/K2."""
    calls = []
    real = F.flash_attention
    monkeypatch.setattr(F, "flash_attention", lambda *a: calls.append(a[0].shape) or real(*a))
    rng = np.random.default_rng(0)
    for l in (599, 600, 601):
        q = t(rng.standard_normal((1, l, 1, 8), dtype=np.float32))
        out = A.sdpa_auto(q, q, q)
        torch.testing.assert_close(out, A.sdpa_ref(q, q, q), rtol=1e-5, atol=1e-6)
        cos, sin = torch.ones((1, l, 4)), torch.zeros((1, l, 4))
        assert A.attention(q, q, q, cos, sin).shape == (1, l, 8)
    assert [s[1] for s in calls] == [601, 601]
    q = t(rng.standard_normal((1, 600, 1, 8), dtype=np.float32))
    A.sdpa(q, q, q)
    assert calls[-1][1] == 600
