"""The split-TF32 product of the float32 attention forward
(``csrc/attention_tf32.cuh``), on the CPU through its plain emulation
``short_attention.split_tf32_attention_ref``.

* ``tf32_round`` (round to nearest, ties away, as ``cvt.rna.tf32.f32``)
  against the rule, bit for bit, on crafted values and against an
  independent float64 formulation on random normal floats;
* the three-product emulation (hi hi + hi lo + lo hi for Q K^T and for
  P V) against the JAX package's ``fused_attention`` (its Pallas kernel in
  interpret mode, exact float32 on the CPU): mean|a - jax| / mean|jax|
  below 1e-5, the bound the card holds the kernel to;
* each control (one product; each cross term of either product left out)
  misses that bound on the same inputs (L >= 65: at L = 1, p = 1 and o = v,
  so Q K^T and p's lo part do not enter);
* the kv order inside each group of 8 that lets the S accumulator's
  registers serve as the A operand of the k8 TF32 P V product, with V^T
  stored in the order 0 2 4 6 1 3 5 7, gives the same product as P V.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genhancer_tpu.core.pallas.short_attention import fused_attention as jax_fused_attention
from genhancer_tpu_torch.core.kernels import short_attention as K

torch.set_num_threads(1)

BOUND = 1e-5
SPLIT = K.SPLIT_TERMS


def _f32(bits):
    return torch.from_numpy(np.array([bits], dtype=np.uint32).view(np.float32))


def _bits(x):
    return int(x.numpy().view(np.uint32)[0])


# (input bits, the rule's bits; None: a NaN)
CRAFTED = {
    "one": (0x3F800000, 0x3F800000),
    "tie, positive: away from zero": (0x3F801000, 0x3F802000),
    "tie, negative: away from zero": (0xBF801000, 0xBF802000),
    "tie at an odd last bit": (0x3F803000, 0x3F804000),
    "just below half": (0x3F800FFF, 0x3F800000),
    "just above half": (0x3F801001, 0x3F802000),
    "carry into the exponent": (0x3FFFF000, 0x40000000),
    "carry into the exponent, negative": (0xBFFFFFFF, 0xC0000000),
    "subnormal tie": (0x00001000, 0x00002000),
    "subnormal below half": (0x00000FFF, 0x00000000),
    "subnormal carry to the least normal, negative": (0x807FF000, 0x80800000),
    "+0": (0x00000000, 0x00000000),
    "-0": (0x80000000, 0x80000000),
    "largest TF32": (0x7F7FE000, 0x7F7FE000),
    "+inf": (0x7F800000, 0x7F800000),
    "-inf": (0xFF800000, 0xFF800000),
    "quiet NaN": (0x7FC00000, None),
    "NaN whose rounding would carry into the sign": (0x7FFFF000, None),
    "negative NaN": (0xFFC00001, None),
}


@pytest.mark.parametrize("case", list(CRAFTED))
def test_tf32_round_crafted(case):
    bits, want = CRAFTED[case]
    got = K.tf32_round(_f32(bits))
    assert got.dtype == torch.float32
    if want is None:
        assert torch.isnan(got).all()
    else:
        assert _bits(got) == want, f"{bits:#010x} -> {_bits(got):#010x}, want {want:#010x}"


def test_tf32_round_random_normals():
    """Normal float32 values of every exponent against the same rule in
    float64: the magnitude to 11 significant bits, half away from zero."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(20000) * 10.0 ** rng.uniform(-36, 36, 20000)).astype(np.float32)
    x = x[np.abs(x) >= np.finfo(np.float32).tiny]
    m, e = np.frexp(np.abs(x).astype(np.float64))            # |x| = m 2^e, m in [0.5, 1)
    want = (np.sign(x) * np.floor(m * 2.0 ** 11 + 0.5) * 2.0 ** (e - 11)).astype(np.float32)
    got = K.tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _mean_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).mean() / np.abs(want).mean()


@functools.lru_cache(maxsize=None)
def _case(l, d):
    """Seeded numpy q, k, v [2, L, 2, D] and the JAX package's output."""
    rng = np.random.default_rng(1000 * l + d)
    q, k, v = (rng.standard_normal((2, l, 2, d), dtype=np.float32) for _ in range(3))
    want = np.asarray(jax_fused_attention(*(jnp.asarray(x) for x in (q, k, v))), np.float32)
    return (q, k, v), want


def _emulate(l, d, qk=SPLIT, pv=SPLIT):
    (q, k, v), want = _case(l, d)
    got = K.split_tf32_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)), qk=qk, pv=pv)
    assert got.dtype == torch.float32 and got.shape == (2, l, 2, d)
    return got.numpy(), want


@pytest.mark.parametrize("d", [8, 64, 72])
@pytest.mark.parametrize("l", [1, 65, 257])
def test_split_matches_jax(l, d):
    got, want = _emulate(l, d)
    assert _mean_rel(got, want) <= BOUND
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


CONTROLS = {
    "one product": (("hh",), ("hh",)),
    "Q K^T without hi lo": (("hh", "lh"), SPLIT),
    "Q K^T without lo hi": (("hh", "hl"), SPLIT),
    "P V without hi lo": (SPLIT, ("hh", "lh")),
    "P V without lo hi": (SPLIT, ("hh", "hl")),
}


@pytest.mark.parametrize("d", [8, 64, 72])
@pytest.mark.parametrize("l", [65, 257])
@pytest.mark.parametrize("control", list(CONTROLS))
def test_controls_miss_the_bound(control, l, d):
    qk, pv = CONTROLS[control]
    got, want = _emulate(l, d, qk=qk, pv=pv)
    assert _mean_rel(got, want) > 10 * BOUND


# ---------------------------------------------------------------- the kv order

def _accumulator_coords(n):
    """(row, col) of register i of thread t of a wgmma m64nN float32
    accumulator: d[4j + e] at (16 w + l/4, 8j + 2(l%4) + e), d[4j + 2 + e]
    eight rows below (warp w = t/32, lane l = t%32)."""
    out = np.zeros((128, n // 2, 2), np.int64)
    for t in range(128):
        w, lane = divmod(t, 32)
        r, c = 16 * w + lane // 4, lane % 4
        for j in range(n // 8):
            for e in range(2):
                out[t, 4 * j + e] = (r, 8 * j + 2 * c + e)
                out[t, 4 * j + 2 + e] = (r + 8, 8 * j + 2 * c + e)
    return out


def _tf32_a_coords():
    """(row, k) of register i of thread t of the A fragment of a wgmma
    m64nNk8 TF32 product: a0 (r, c), a1 (r + 8, c), a2 (r, c + 4),
    a3 (r + 8, c + 4), r = 16 w + l/4, c = l%4."""
    out = np.zeros((128, 4, 2), np.int64)
    for t in range(128):
        w, lane = divmod(t, 32)
        r, c = 16 * w + lane // 4, lane % 4
        out[t] = [(r, c), (r + 8, c), (r, c + 4), (r + 8, c + 4)]
    return out


# the kernel's a0..a3 of k8 step j: d[4j], d[4j + 2], d[4j + 1], d[4j + 3]
A_FROM_D = (0, 2, 1, 3)


def _kv_column(i):
    """The column of V^T where the kernel stores kv row i of a group of 8."""
    return (i >> 1) + 4 * (i & 1)


@pytest.mark.parametrize("bk, dp", [(64, 64), (32, 128)])
def test_kv_order_gives_the_same_pv(bk, dp):
    """The product the tensor cores form from the kernel's registers and
    its V^T tile equals P V within 1e-6; the unpermuted V^T does not."""
    rng = np.random.default_rng(bk + dp)
    p = rng.random((64, bk)).astype(np.float32)
    v = rng.standard_normal((bk, dp)).astype(np.float32)
    acc, a_at = _accumulator_coords(bk), _tf32_a_coords()
    a = np.full((64, bk), np.nan, np.float32)       # A as the hardware reads it
    for t in range(128):
        for j in range(bk // 8):
            for i, src in enumerate(A_FROM_D):
                r, col = acc[t, 4 * j + src]
                ar, ak = a_at[t, i]
                assert ar == r
                a[ar, 8 * j + ak] = p[r, col]
    assert not np.isnan(a).any()
    vt = np.zeros((dp, bk), np.float32)             # V^T as the split pass stores it
    for row in range(bk):
        vt[:, 8 * (row // 8) + _kv_column(row % 8)] = v[row]
    want = p.astype(np.float64) @ v
    np.testing.assert_allclose(a.astype(np.float64) @ vt.T, want, rtol=0, atol=1e-6)
    assert np.abs(a.astype(np.float64) @ v - want).max() > 1e-2
