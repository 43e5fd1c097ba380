"""Card-only checks of the port's CUDA kernels (marker ``cuda``).

They skip where ``torch.cuda.is_available()`` is false.  This file imports
no JAX, so it also runs on a GPU machine without the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Bounds as in chip_smoke.py: float32 1e-4, bfloat16 2e-2 (a float32
summation-order difference can flip a bf16 rounding); for gradients the
bound is relative to max(1, max|plain|); K3 within one ulp of the storage
dtype.  The bf16 rounding points are held to mean|kernel - plain| /
mean|plain| <= 2e-4: K1/K2/K5's o, K1b's and K2b's dq, dk and dv, K5b's dv, each
against a control that rounds p elsewhere and must miss the bound (p
rounded before it is normalised; dv from p in float32 or p rounded).  The
float32 forward (split TF32 on the tensor cores) is held to exact float32
(TF32 off) at max 1e-4 and mean|kernel - plain| / mean|plain| <= 1e-5,
against controls that leave a TF32 product out and must miss it.  The
int8 kernels: K7 and K4 bit-identical (IEEE division and rint on both
sides); K6 codes identical or one apart at a rate below 1e-3, scales within
1e-6 relative, p within 1e-6 absolute (the card's log2f/exp2f against the
host's); K8 within 1e-5 of max|plain| (the
same codes and int32 sums, float32 partials in the same order).
"""

import subprocess

import pytest
import torch

from genhancer_tpu_torch.core import attention as A
from genhancer_tpu_torch.core.kernels import adamw as KA
from genhancer_tpu_torch.core.kernels import flash_attention as F
from genhancer_tpu_torch.core.kernels import int8_dw as K8
from genhancer_tpu_torch.core.kernels import rowquant as K7
from genhancer_tpu_torch.core.kernels import short_attention as K
from genhancer_tpu_torch.core.rope import apply_rope, multi_axis_rope

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)
ROUNDING_BOUND = 2e-4
TF32_MEAN_BOUND = 1e-5
# the plain emulation's (qk, pv) terms with a TF32 product left out
TF32_CONTROLS = {"one product": (("hh",), ("hh",)),
                 "Q K^T without hi lo": (("hh", "lh"), K.SPLIT_TERMS),
                 "Q K^T without lo hi": (("hh", "hl"), K.SPLIT_TERMS),
                 "P V without hi lo": (K.SPLIT_TERMS, ("hh", "lh")),
                 "P V without lo hi": (K.SPLIT_TERMS, ("hh", "hl"))}


def _mean_rel(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().mean() / want.abs().mean()).item()


def _round_before_normalise(q, k, v):
    """The control for o's rounding point: exp(s - max) rounded to v's dtype
    before the float32 PV product, divided by the row sum after."""
    s = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) / q.shape[-1] ** 0.5
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bhlm,bmhd->blhd", e.to(v.dtype).float(), v.float())
    return (o / e.sum(dim=-1).permute(0, 2, 1)[..., None]).to(q.dtype)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("l, d", [(13, 64), (70, 72), (197, 128)])
def test_kernels_match_plain_and_count(cuda, dtype, tol, l, d):
    g = torch.Generator(device=cuda).manual_seed(l)
    q, k, v = (torch.randn((2, l, 3, d), generator=g, device=cuda).to(dtype) for _ in range(3))
    before = dict(K.LAUNCHES)
    out = K.fused_attention(q, k, v)
    torch.cuda.synchronize()
    ref = K.fused_attention_ref(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() <= tol
    if dtype == torch.bfloat16:
        # p normalised, then rounded (_attn_body), against the single pass
        assert _mean_rel(out, ref) <= ROUNDING_BOUND < _mean_rel(_round_before_normalise(q, k, v),
                                                                 ref)
    ids = torch.randint(0, 16, (2, l, 3), generator=g, device=cuda).to(torch.float32)
    axes = (d // 2, d // 4, d // 4)            # sums to D
    cos, sin = multi_axis_rope(ids, axes, 10_000)
    out = K.fused_rope_attention(q, k, v, cos, sin)
    torch.cuda.synchronize()
    ref = K.fused_rope_attention_ref(q, k, v, cos, sin)
    assert (out.float() - ref.float()).abs().max().item() <= tol
    if dtype == torch.bfloat16:
        ctl = _round_before_normalise(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v)
        assert _mean_rel(out, ref) <= ROUNDING_BOUND < _mean_rel(ctl, ref)
    assert K.LAUNCHES["fused_attention"] == before["fused_attention"] + 1
    assert K.LAUNCHES["fused_rope_attention"] == before["fused_rope_attention"] + 1


def test_long_sequences_raise_on_cuda(cuda):
    """Long sequences launch K5 (no plain fallback); a length no kernel takes
    (odd D below PALLAS_MIN_SEQ) raises."""
    q = torch.randn((1, A.FUSED_MAX_SEQ + 1, 1, 8), device=cuda)
    before = F.LAUNCHES["flash_attention"]
    A.sdpa_auto(q, q, q)
    cos = torch.ones((1, A.FUSED_MAX_SEQ + 1, 4), device=cuda)
    A.attention(q, q, q, cos, torch.zeros_like(cos))
    torch.cuda.synchronize()
    assert F.LAUNCHES["flash_attention"] == before + 2
    q = torch.zeros((1, 8, 1, 7), device=cuda)
    with pytest.raises(NotImplementedError, match="K5"):
        A.sdpa_auto(q, q, q)


def test_unsupported_inputs_raise(cuda):
    q = torch.zeros((1, 4, 1, 12), device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        K.fused_attention(q, q, q)
    q = torch.zeros((1, 4, 1, 8), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.fused_attention(q, q, q)
    q = torch.zeros((1, 4, 1, 8), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        KA.fused_adamw_leaf(q[..., ::2], q[..., ::2], q[..., ::2], q[..., ::2],
                            torch.zeros(4, device=cuda))


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("l, d", [(13, 64), (70, 72), (197, 128)])
def test_backward_matches_plain_and_counts(cuda, dtype, tol, l, d):
    """K1b/K2b through the autograd Functions against the plain backward."""
    g = torch.Generator(device=cuda).manual_seed(100 + l)
    q, k, v, do = (torch.randn((2, l, 3, d), generator=g, device=cuda).to(dtype)
                   for _ in range(4))
    ids = torch.randint(0, 16, (2, l, 3), generator=g, device=cuda).to(torch.float32)
    cos, sin = multi_axis_rope(ids, (d // 2, d // 4, d // 4), 10_000)
    for rope in (False, True):
        before = dict(K.LAUNCHES)
        qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
        out = (K.fused_rope_attention(qq, kk, vv, cos, sin) if rope
               else K.fused_attention(qq, kk, vv))
        grads = torch.autograd.grad(out, (qq, kk, vv), do)
        torch.cuda.synchronize()
        ref = (K.fused_rope_attention_bwd_ref(q, k, v, out.detach(), do, cos, sin) if rope
               else K.fused_attention_bwd_ref(q, k, v, out.detach(), do))
        for gk, gr in zip(grads, ref):
            err = (gk.float() - gr.float()).abs().max().item()
            assert err <= tol * max(1.0, gr.float().abs().max().item()), (rope, err)
        name = "fused_rope_attention_bwd" if rope else "fused_attention_bwd"
        assert K.LAUNCHES[name] == before[name] + 1
        if dtype == torch.bfloat16:
            # K1b and K2b: p rounded before dV, ds before dQ/dK, dq and dk
            # rounded (K1b: un-rotated and rounded again); the control keeps
            # p in float32 for dV
            for gk, gr in zip(grads, ref):
                assert _mean_rel(gk, gr) <= ROUNDING_BOUND
            rq, rk = (apply_rope(q, cos, sin), apply_rope(k, cos, sin)) if rope else (q, k)
            lse = F.flash_attention_fwd_ref(rq, rk, v)[1]
            ctl = F.flash_attention_bwd_ref(rq, rk, v, out.detach(), lse, do)[2]
            assert _mean_rel(ctl, ref[2]) > ROUNDING_BOUND


@pytest.mark.parametrize("pdt, gdt", [(torch.bfloat16, torch.float32),
                                      (torch.float32, torch.float32),
                                      (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("shape", [(1000, 24), (3, 7), (4096,)])
def test_adamw_matches_plain_within_one_ulp(cuda, pdt, gdt, shape):
    g = torch.Generator(device=cuda).manual_seed(7)
    p, m, v = (torch.randn(shape, generator=g, device=cuda).to(pdt) for _ in range(3))
    v = v.abs()
    grad = torch.randn(shape, generator=g, device=cuda).to(gdt)
    sc = torch.tensor([0.5, 1e-3, 1 / (1 - 0.9), 1 / (1 - 0.999)], device=cuda)
    ref = KA.fused_adamw_leaf_ref(p, m, v, grad, sc, 0.9, 0.999, 1e-8, 0.01)
    before = KA.LAUNCHES["fused_adamw"]
    KA.fused_adamw_leaf(p, m, v, grad, sc, 0.9, 0.999, 1e-8, 0.01)
    torch.cuda.synchronize()
    assert KA.LAUNCHES["fused_adamw"] == before + 1
    for got, want in zip((p, m, v), ref):
        assert KA.ulp_distance(got, want).max().item() <= 1.0


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("l, d, h", [(600, 64, 3), (729, 72, 3), (1031, 128, 3),
                                     (964, 128, 24)])
def test_flash_matches_plain_and_counts(cuda, dtype, tol, l, d, h):
    """K5 forward (o and lse) and K5b through the autograd Function against
    the plain versions, on strided q/k/v views of one fused projection (bf16:
    the wgmma/TMA kernels; L = 964 is the sliding@224 length, not a multiple
    of the 128-row tiles)."""
    g = torch.Generator(device=cuda).manual_seed(200 + l)
    b = 2
    fused = torch.randn((b, l, 3 * h * d + 8), generator=g, device=cuda).to(dtype)
    q, k, v = (x.reshape(b, l, h, d) for x in fused[..., : 3 * h * d].split(h * d, dim=-1))
    do = torch.randn((b, l, h, d), generator=g, device=cuda).to(dtype)
    before = dict(F.LAUNCHES)
    o, lse = F._fwd_kernel(q, k, v, want_lse=True)
    torch.cuda.synchronize()
    ro, rlse = F.flash_attention_fwd_ref(q, k, v)
    assert (o.float() - ro.float()).abs().max().item() <= tol
    assert (lse - rlse).abs().max().item() <= 1e-4 * max(1.0, rlse.abs().max().item())
    qq, kk, vv = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out = F.flash_attention(qq, kk, vv)
    grads = torch.autograd.grad(out, (qq, kk, vv), do)
    torch.cuda.synchronize()
    want = F.flash_attention_bwd_ref(q, k, v, out.detach(), rlse, do)
    for gk, gr in zip(grads, want):
        err = (gk.float() - gr.float()).abs().max().item()
        assert err <= tol * max(1.0, gr.float().abs().max().item()), err
    assert F.LAUNCHES["flash_attention"] == before["flash_attention"] + 2
    assert F.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    if dtype == torch.bfloat16:
        # the rounding points (o: normalised p; dv: p in float32), against
        # controls that round p elsewhere: before normalising, K2b's plain dv
        assert _mean_rel(o, ro) <= ROUNDING_BOUND < _mean_rel(_round_before_normalise(q, k, v), ro)
        ctl = K.fused_attention_bwd_ref(q, k, v, out.detach(), do)[2]
        assert _mean_rel(grads[2], want[2]) <= ROUNDING_BOUND < _mean_rel(ctl, want[2])


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_flash_backward_where_lse_is_very_negative(cuda, dtype, tol):
    """Every logit near -113, so every row's lse is below -88 and exp(0 - lse)
    overflows float32 in the kv columns past L of the last, ragged tile: the
    gradients stay finite and match the plain backward."""
    g = torch.Generator(device=cuda).manual_seed(11)
    b, l, h, d = 1, 601, 2, 128
    q = (torch.randn((b, l, h, d), generator=g, device=cuda) - 10).to(dtype)
    k = (1 + 0.1 * torch.randn((b, l, h, d), generator=g, device=cuda)).to(dtype)
    v, do = (torch.randn((b, l, h, d), generator=g, device=cuda).to(dtype) for _ in range(2))
    qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
    out = F.flash_attention(qq, kk, vv)
    grads = torch.autograd.grad(out, (qq, kk, vv), do)
    torch.cuda.synchronize()
    _, rlse = F.flash_attention_fwd_ref(q, k, v)
    assert rlse.max().item() < -88
    want = F.flash_attention_bwd_ref(q, k, v, out.detach(), rlse, do)
    for gk, gr in zip(grads, want):
        assert torch.isfinite(gk).all()
        err = (gk.float() - gr.float()).abs().max().item()
        assert err <= tol * max(1.0, gr.float().abs().max().item()), err


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_rope_backward_where_lse_is_very_negative(cuda, dtype, tol):
    """K1b at L = 197, whose last 64-row kv tile is ragged: every logit near
    -108, so every row's lse is near -103 and exp(0 - lse) overflows float32
    in the kv columns past L.  The tables rotate every position alike (ids
    all 3), so the logits are q.k while dq and dk still go through the
    un-rotation.  The gradients stay finite and match the plain backward."""
    g = torch.Generator(device=cuda).manual_seed(12)
    b, l, h, d = 1, 197, 2, 128
    q = (torch.randn((b, l, h, d), generator=g, device=cuda) - 9.5).to(dtype)
    k = (1 + 0.1 * torch.randn((b, l, h, d), generator=g, device=cuda)).to(dtype)
    v, do = (torch.randn((b, l, h, d), generator=g, device=cuda).to(dtype) for _ in range(2))
    cos, sin = multi_axis_rope(torch.full((b, l, 3), 3.0, device=cuda), (64, 32, 32), 10_000)
    qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
    out = K.fused_rope_attention(qq, kk, vv, cos, sin)
    grads = torch.autograd.grad(out, (qq, kk, vv), do)
    torch.cuda.synchronize()
    _, rlse = F.flash_attention_fwd_ref(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v)
    assert rlse.max().item() < -88
    want = K.fused_rope_attention_bwd_ref(q, k, v, out.detach(), do, cos, sin)
    for gk, gr in zip(grads, want):
        assert torch.isfinite(gk).all()
        err = (gk.float() - gr.float()).abs().max().item()
        assert err <= tol * max(1.0, gr.float().abs().max().item()), err


@pytest.mark.parametrize("l", [257, 577])
def test_tower_backward_where_lse_is_very_negative(cuda, l):
    """K2b at the towers' L = 257 (224 px), whose last 64-row kv tile (dq)
    and last 128-row dk/dv block each hold one row, and L = 577 (CLIP-L/14
    @336: the last dk/dv block holds 65 rows, the last 64-row kv tile one):
    every logit near -108, so every row's lse — those of the last dk/dv
    block and of each dq block's last kv tile included — is near -103 and
    exp(0 - lse) overflows float32 in the kv columns past L.  The gradients
    stay finite and match the plain backward."""
    g = torch.Generator(device=cuda).manual_seed(13)
    b, h, d = 1, 2, 64
    q = (torch.randn((b, l, h, d), generator=g, device=cuda) - 13.5).to(torch.bfloat16)
    k = (1 + 0.1 * torch.randn((b, l, h, d), generator=g, device=cuda)).to(torch.bfloat16)
    v, do = (torch.randn((b, l, h, d), generator=g, device=cuda).to(torch.bfloat16)
             for _ in range(2))
    qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
    before = K.LAUNCHES["fused_attention_bwd"]
    out = K.fused_attention(qq, kk, vv)
    grads = torch.autograd.grad(out, (qq, kk, vv), do)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fused_attention_bwd"] == before + 1
    _, rlse = F.flash_attention_fwd_ref(q, k, v)
    assert -110 < rlse.min().item() and rlse.max().item() < -88
    want = K.fused_attention_bwd_ref(q, k, v, out.detach(), do)
    for gk, gr in zip(grads, want):
        assert torch.isfinite(gk).all()
        err = (gk.float() - gr.float()).abs().max().item()
        assert err <= 2e-2 * max(1.0, gr.float().abs().max().item()), err


def test_tower_kernels_at_l577(cuda):
    """The CLIP-L/14@336 tower's attention (L = 577 = 4 x 128 + 65, H = 16,
    D = 64): K2 in float32 (the MMVP-VLM eval's dtype) within 1e-4 of the
    plain version; K2b in bf16 (video stage 2) within 2e-2, its dq, dk, dv
    at the plain version's rounding points (mean error <= 2e-4), with the
    dv-from-float32-p control missing that bound."""
    g = torch.Generator(device=cuda).manual_seed(577)
    q, k, v = (torch.randn((2, 577, 16, 64), generator=g, device=cuda) for _ in range(3))
    before = dict(K.LAUNCHES)
    out = K.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert (out - K.fused_attention_ref(q, k, v)).abs().max().item() <= 1e-4
    q, k, v, do = (x.to(torch.bfloat16) for x in (q, k, v, torch.randn_like(q)))
    qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
    out = K.fused_attention(qq, kk, vv)
    grads = torch.autograd.grad(out, (qq, kk, vv), do)
    torch.cuda.synchronize()
    ref = K.fused_attention_bwd_ref(q, k, v, out.detach(), do)
    for gk, gr in zip(grads, ref):
        assert (gk.float() - gr.float()).abs().max().item() <= \
            2e-2 * max(1.0, gr.float().abs().max().item())
        assert _mean_rel(gk, gr) <= ROUNDING_BOUND
    lse = F.flash_attention_fwd_ref(q, k, v)[1]
    ctl = F.flash_attention_bwd_ref(q, k, v, out.detach(), lse, do)[2]
    assert _mean_rel(ctl, ref[2]) > ROUNDING_BOUND
    assert K.LAUNCHES["fused_attention"] == before["fused_attention"] + 2
    assert K.LAUNCHES["fused_attention_bwd"] == before["fused_attention_bwd"] + 1


def _siglip_inputs(g, cuda, path, negative=False):
    """bf16 q, k, v, dO (and RoPE tables for K1) at the SigLIP-384 paths'
    shapes: the DiT's joint L = 577 = 9 x 64 + 1 (K1/K1b: the last 64-row kv
    tile holds one row) and the so400m tower's L = 729 = 5 x 128 + 89, D =
    72 (K5/K5b, D padded to 128 in shared memory), both at B = 16.  With
    ``negative`` every logit is near -108, so every lse is below -88."""
    b, l, h, d = (16, 577, 24, 128) if path == "K1" else (16, 729, 16, 72)
    shift = 9.5 if d == 128 else 12.7
    q = torch.randn((b, l, h, d), generator=g, device=cuda)
    k = torch.randn((b, l, h, d), generator=g, device=cuda)
    if negative:
        q, k = q - shift, 1 + 0.1 * k
    v, do = (torch.randn((b, l, h, d), generator=g, device=cuda) for _ in range(2))
    tables = None
    if path == "K1":
        ids = (torch.full((b, l, 3), 3.0, device=cuda) if negative else
               torch.randint(0, 24, (b, l, 3), generator=g, device=cuda).to(torch.float32))
        tables = multi_axis_rope(ids, (16, 56, 56), 10_000)
    return [x.to(torch.bfloat16) for x in (q, k, v, do)], tables


def _siglip_run(path, q, k, v, do, tables):
    """(o, grads, plain o, plain grads, the inputs the plain attention sees)."""
    qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
    if path == "K1":
        cos, sin = tables
        out = K.fused_rope_attention(qq, kk, vv, cos, sin)
        grads = torch.autograd.grad(out, (qq, kk, vv), do)
        rq, rk = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        ro = K.fused_rope_attention_ref(q, k, v, cos, sin)
        want = K.fused_rope_attention_bwd_ref(q, k, v, out.detach(), do, cos, sin)
    else:
        out = F.flash_attention(qq, kk, vv)
        grads = torch.autograd.grad(out, (qq, kk, vv), do)
        rq, rk = q, k
        ro, rlse = F.flash_attention_fwd_ref(q, k, v)
        want = F.flash_attention_bwd_ref(q, k, v, out.detach(), rlse, do)
    torch.cuda.synchronize()
    return out.detach(), grads, ro, want, (rq, rk)


@pytest.mark.parametrize("path", ["K1", "K5"])
def test_siglip_path_shapes_match_plain(cuda, path):
    """K1/K1b at [16, 577, 24, 128] and K5/K5b at [16, 729, 16, 72], bf16,
    against their plain versions: 2e-2, and the rounding points (o; K1b's
    dq, dk, dv; K5b's dv) to a mean error of 2e-4, with the controls (p
    rounded before normalising; dv from the other kernel's p) missing it."""
    g = torch.Generator(device=cuda).manual_seed(13 + len(path))
    (q, k, v, do), tables = _siglip_inputs(g, cuda, path)
    names = (("fused_rope_attention", "fused_rope_attention_bwd") if path == "K1"
             else ("flash_attention", "flash_attention_bwd"))
    table = K.LAUNCHES if path == "K1" else F.LAUNCHES
    before = dict(table)
    out, grads, ro, want, (rq, rk) = _siglip_run(path, q, k, v, do, tables)
    assert [table[n] - before[n] for n in names] == [1, 1]
    assert (out.float() - ro.float()).abs().max().item() <= 2e-2
    assert _mean_rel(out, ro) <= ROUNDING_BOUND < _mean_rel(_round_before_normalise(rq, rk, v), ro)
    for gk, gr in zip(grads, want):
        err = (gk.float() - gr.float()).abs().max().item()
        assert err <= 2e-2 * max(1.0, gr.float().abs().max().item()), err
    if path == "K1":
        for gk, gr in zip(grads, want):
            assert _mean_rel(gk, gr) <= ROUNDING_BOUND
        lse = F.flash_attention_fwd_ref(rq, rk, v)[1]
        ctl = F.flash_attention_bwd_ref(rq, rk, v, out, lse, do)[2]
    else:
        assert _mean_rel(grads[2], want[2]) <= ROUNDING_BOUND
        ctl = K.fused_attention_bwd_ref(q, k, v, out, do)[2]
    assert _mean_rel(ctl, want[2]) > ROUNDING_BOUND


@pytest.mark.parametrize("path", ["K1", "K5"])
def test_siglip_path_shapes_where_lse_is_very_negative(cuda, path):
    """The same shapes with every lse below -88: exp(0 - lse) overflows
    float32 in the columns past L of the ragged last tile (one row of
    K1b's 64-row kv tile, 89 of K5b's 128-row one); the gradients stay
    finite and match the plain backward."""
    g = torch.Generator(device=cuda).manual_seed(17 + len(path))
    (q, k, v, do), tables = _siglip_inputs(g, cuda, path, negative=True)
    _, grads, _, want, (rq, rk) = _siglip_run(path, q, k, v, do, tables)
    _, rlse = F.flash_attention_fwd_ref(rq, rk, v)
    assert -115 < rlse.min().item() and rlse.max().item() < -88
    for gk, gr in zip(grads, want):
        assert torch.isfinite(gk).all()
        err = (gk.float() - gr.float()).abs().max().item()
        assert err <= 2e-2 * max(1.0, gr.float().abs().max().item()), err


@pytest.mark.parametrize("kernel, b, l, h, d", [
    ("K2", 50, 257, 16, 64), ("K2", 50, 577, 16, 64),      # the MMVP-VLM eval's tower
    ("K1", 2, 197, 24, 128), ("K5", 2, 700, 4, 128),       # D = 128
    ("K1", 2, 129, 4, 128), ("K2", 2, 65, 4, 72), ("K2", 2, 1, 4, 8), ("K5", 1, 1031, 4, 72)])
def test_float32_forward_keeps_float32_accuracy(cuda, monkeypatch, kernel, b, l, h, d):
    """K1, K2 and K5 in float32 (the split-TF32 wgmma body) against their
    plain versions in exact float32: max 1e-4 and mean error 1e-5; every
    control (the plain emulation with a product left out) misses the mean
    bound.  At L = 1, p = 1 and o = v: only the one-product control can
    show there."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator(device=cuda).manual_seed(l + d)
    q, k, v = (torch.randn((b, l, h, d), generator=g, device=cuda) for _ in range(3))
    before = dict(K.LAUNCHES), dict(F.LAUNCHES)
    if kernel == "K1":
        ids = torch.randint(0, 16, (b, l, 3), generator=g, device=cuda).to(torch.float32)
        cos, sin = multi_axis_rope(ids, (d // 2, d // 4, d // 4), 10_000)
        out = K.fused_rope_attention(q, k, v, cos, sin)
        ref = K.fused_rope_attention_ref(q, k, v, cos, sin)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    elif kernel == "K2":
        out, ref = K.fused_attention(q, k, v), K.fused_attention_ref(q, k, v)
    else:
        out, ref = F.flash_attention(q, k, v), F.flash_attention_fwd_ref(q, k, v)[0]
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 1e-4
    assert _mean_rel(out, ref) <= TF32_MEAN_BOUND
    for name in (TF32_CONTROLS if l > 1 else ["one product"]):
        ctl = K.split_tf32_attention_ref(q, k, v, *TF32_CONTROLS[name])
        assert _mean_rel(ctl, ref) > TF32_MEAN_BOUND, name
    launched = {"K1": K.LAUNCHES["fused_rope_attention"] - before[0]["fused_rope_attention"],
                "K2": K.LAUNCHES["fused_attention"] - before[0]["fused_attention"],
                "K5": F.LAUNCHES["flash_attention"] - before[1]["flash_attention"]}
    assert launched == {n: int(n == kernel) for n in launched}


@pytest.mark.parametrize("l", [257, 577])
def test_float32_lse_where_one_row_is_very_negative(cuda, l):
    """K2 in float32 at the towers' lengths with one q row planted so that
    its logits are near -108: that row's lse (near -103) and every other
    row's match the plain version's, and K2b in float32, which reads them,
    stays finite and matches the plain backward."""
    g = torch.Generator(device=cuda).manual_seed(14)
    b, h, d = 2, 2, 64
    q = torch.randn((b, l, h, d), generator=g, device=cuda)
    q[:, l // 2] -= 13.5
    k = 1 + 0.1 * torch.randn((b, l, h, d), generator=g, device=cuda)
    v, do = (torch.randn((b, l, h, d), generator=g, device=cuda) for _ in range(2))
    _, lse, _, _ = K._fwd_kernel(q, k, v, None, want_lse=True)
    _, rlse = F.flash_attention_fwd_ref(q, k, v)
    torch.cuda.synchronize()
    assert -110 < rlse[:, :, l // 2].min().item() and rlse[:, :, l // 2].max().item() < -88
    assert (lse - rlse).abs().max().item() <= 1e-4 * rlse.abs().max().item()
    qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
    before = K.LAUNCHES["fused_attention_bwd"]
    out = K.fused_attention(qq, kk, vv)
    grads = torch.autograd.grad(out, (qq, kk, vv), do)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fused_attention_bwd"] == before + 1
    want = K.fused_attention_bwd_ref(q, k, v, out.detach(), do)
    for gk, gr in zip(grads, want):
        assert torch.isfinite(gk).all()
        err = (gk - gr).abs().max().item()
        assert err <= 1e-4 * max(1.0, gr.abs().max().item()), err


def test_short_kernels_refuse_layouts_the_tma_cannot_read(cuda):
    """A bf16 view misaligned by one element raises before any launch in K1,
    K2, K1b and K2b; nothing falls back."""
    b, l, h, d = 1, 197, 2, 64
    fused = torch.randn((b, l, 3 * h * d + 8), device=cuda).to(torch.bfloat16)
    good = fused[..., : h * d].reshape(b, l, h, d)
    bad = fused[..., 1: 1 + h * d].reshape(b, l, h, d)
    cos, sin = multi_axis_rope(torch.zeros((b, l, 3), device=cuda), (32, 16, 16), 10_000)
    before = dict(K.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        K.fused_rope_attention(good, bad, good, cos, sin)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        K.fused_attention(good, good, bad)
    o, lse, rq, rk = K._fwd_kernel(good, good, good, (cos, sin), want_lse=True)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        K._bwd_kernel(rq, rk, bad, o, lse, torch.ones_like(o), (cos, sin))
    o, lse, _, _ = K._fwd_kernel(good, good, good, None, want_lse=True)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        K._bwd_kernel(good, bad, good, o, lse, torch.ones_like(o), None)
    assert K.LAUNCHES["fused_rope_attention"] == before["fused_rope_attention"] + 1
    assert K.LAUNCHES["fused_attention"] == before["fused_attention"] + 1
    assert K.LAUNCHES["fused_rope_attention_bwd"] == before["fused_rope_attention_bwd"]
    assert K.LAUNCHES["fused_attention_bwd"] == before["fused_attention_bwd"]


def test_flash_refuses_layouts_the_tma_cannot_read(cuda):
    """A bf16 view misaligned by one element raises before any launch, in
    the forward and in the backward; nothing falls back."""
    b, l, h, d = 1, 700, 2, 64
    fused = torch.randn((b, l, 3 * h * d + 8), device=cuda).to(torch.bfloat16)
    good = fused[..., : h * d].reshape(b, l, h, d)
    bad = fused[..., 1: 1 + h * d].reshape(b, l, h, d)
    before = dict(F.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        F.flash_attention(good, bad, good)
    o, lse = F._fwd_kernel(good, good, good, want_lse=True)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        F._bwd_kernel(good, good, bad, o, lse, torch.ones_like(o))
    assert F.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert F.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t, c", [(6304, 3072), (300, 777), (32, 18432), (5, 60000),
                                  (8224, 1024), (8224, 4096), (6304, 21504), (32, 3072),
                                  (300, 60000)])
def test_rowquant_bit_identical(cuda, dtype, t, c):
    """K7 with and without the column scale, one launch per call, on each of
    its bodies (``rowquant_tiling``): the warp body (the tower's 1024), the
    block body (the tower's 4096, the DiT's 3072 and 21504), a cluster per
    row (T = 32 and 5 at 3072 to 60000 columns), the scalar body (777
    columns, and 300 float32 rows of 60000, wider than the block body
    holds)."""
    g = torch.Generator(device=cuda).manual_seed(c)
    x = torch.randn((t, c), generator=g, device=cuda).to(dtype)
    cs = torch.rand(c, generator=g, device=cuda) + 0.5
    for col in (None, cs):
        before = K7.LAUNCHES["rowquant"]
        q, s = K7.rowquant(x, col)
        torch.cuda.synchronize()
        rq, rs = K7.rowquant_ref(x, col)
        assert torch.equal(q, rq) and torch.equal(s, rs)
        assert K7.LAUNCHES["rowquant"] == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [16, 3136])
@pytest.mark.parametrize("c", [64, 256, 768, 3072])
def test_rowquant_at_the_static_base_widths(cuda, dtype, t, c):
    """K7 at the widths the static DiT base and QLoRA hand it (img_in's and
    final_layer's 64, time_in's 256, vector_in's 768, the model's 3072) and
    their rows (T = 16: the vec linears at B = 16; T = 3136: img_in at 16 x
    196 tokens), with and without the column scale: bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(t + c)
    x = torch.randn((t, c), generator=g, device=cuda).to(dtype)
    for col in (None, torch.rand(c, generator=g, device=cuda) + 0.5):
        before = K7.LAUNCHES["rowquant"]
        q, s = K7.rowquant(x, col)
        torch.cuda.synchronize()
        rq, rs = K7.rowquant_ref(x, col)
        assert torch.equal(q, rq) and torch.equal(s, rs)
        assert K7.LAUNCHES["rowquant"] == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t, i, o", [(16, 3072, 64), (16, 64, 3072), (3136, 64, 3072),
                                     (48, 1024, 1024)])
def test_qlora_linear_matches_plain(cuda, dtype, t, i, o):
    """``core.nn.linear`` on a module carrying its kept weight, QLoRA's int8
    base (``quant.quantize_lora_base``), LoRA factors and a bias, on the card
    (K7 and ``_int_mm``) against the same module on the CPU (the plain
    path): y and dx within 1e-5 of max|CPU| in float32 (the same codes and
    int32 sums; the dequantization in another order), 2e-2 in bfloat16; the
    int8 base runs inside the SwitchBack context too."""
    from genhancer_tpu_torch.core import nn as tnn
    from genhancer_tpu_torch.core import quant
    g = torch.Generator().manual_seed(t + i)
    mod = tnn.Linear(i, o)
    with torch.no_grad():
        mod.weight.copy_(torch.randn((o, i), generator=g) * 0.05)
        mod.bias.copy_(torch.randn(o, generator=g))
    mod.weight.requires_grad_(False)
    mod.lora_A = torch.nn.Parameter(torch.randn((4, i), generator=g) * 0.05)
    mod.lora_B = torch.nn.Parameter(torch.randn((o, 4), generator=g) * 0.05)
    mod.register_buffer("lora_scale", torch.tensor(4.0))
    assert quant.quantize_lora_base(mod) == ("",)
    x = torch.randn((2, t // 2, i), generator=g).to(dtype)
    gy = torch.randn((2, t // 2, o), generator=g).to(dtype)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    out = {}
    for dev in ("cpu", "cuda"):
        m = mod.to(dev)
        for ctx in ("plain", "switchback"):
            xd = x.to(dev).clone().requires_grad_(True)
            before = K7.LAUNCHES["rowquant"]
            if ctx == "plain":
                y = tnn.linear(m, xd)
            else:
                with tnn.int8_training_ctx(full=True):
                    y = tnn.linear(m, xd)
            y.backward(gy.to(dev))
            if dev == "cuda":
                torch.cuda.synchronize()
                assert K7.LAUNCHES["rowquant"] == before + 2      # x, then g
            out[dev, ctx] = (y.detach().cpu().float(), xd.grad.cpu().float())
    for ctx in ("plain", "switchback"):
        for got, want in zip(out["cuda", ctx], out["cpu", ctx]):
            assert (got - want).abs().max() <= tol * max(1.0, want.abs().max().item()), ctx


def _halfway_rows(t, c, scale, dtype, device):
    """Rows of scale * (k + 0.5), k in [-127, 126], with the row maximum 127 *
    scale: s = scale, every element half-way between two codes."""
    k = (torch.arange(t * c, device=device) % 254 - 127).reshape(t, c).to(torch.float32)
    x = (k + 0.5) * scale
    x[:, 0] = 127.0 * scale
    return x.to(dtype)


@pytest.mark.parametrize("t, c", [(512, 1024), (256, 3072), (512, 9216), (32, 18432),
                                  (300, 777)])
def test_rowquant_misaligned_and_halfway(cuda, t, c):
    """K7 bit for bit where its fast codes must defer to the IEEE division
    (every element half-way, s = 1 and s = 7, and s = 7 from the column
    scale), and on contiguous views whose base is 2 (bfloat16) or 4
    (float32) bytes past 16, which run the scalar body."""
    cases = [(_halfway_rows(t, c, 1.0, torch.bfloat16, cuda), None),
             (_halfway_rows(t, c, 7.0, torch.float32, cuda), None),
             (_halfway_rows(t, c, 1.0, torch.bfloat16, cuda), torch.full((c,), 7.0, device=cuda))]
    g = torch.Generator(device=cuda).manual_seed(t)
    for dtype in (torch.bfloat16, torch.float32):
        flat = torch.randn((t * c + 1,), generator=g, device=cuda).to(dtype)
        cs = torch.rand(c, generator=g, device=cuda) + 0.5
        cases += [(flat[1:].view(t, c), None), (flat[1:].view(t, c), cs)]
    for x, col in cases:
        before = K7.LAUNCHES["rowquant"]
        q, s = K7.rowquant(x, col)
        torch.cuda.synchronize()
        rq, rs = K7.rowquant_ref(x, col)
        assert torch.equal(q, rq) and torch.equal(s, rs), (x.dtype, col is not None)
        assert K7.LAUNCHES["rowquant"] == before + 1


@pytest.mark.parametrize("t, o, i", [
    (6304, 3072, 768), (777, 128, 384), (300, 384, 128),
    (32, 3072, 768), (512, 3072, 768), (513, 3072, 768),   # one k32 step; one block; ragged
    (32, 18432, 3072), (6304, 18432, 3072)])               # the widest modulation, the timed T
def test_int8_dw_matches_plain(cuda, t, o, i):
    """K8, bfloat16 and float32 inputs, both out dtypes: the K-major
    workspace bit for bit against the plain per-block quantization, dW
    against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(t)
    for dtype in (torch.bfloat16, torch.float32):
        gg = torch.randn((t, o), generator=g, device=cuda).to(dtype)
        xx = torch.randn((t, i), generator=g, device=cuda).to(dtype)
        for out in (torch.float32, torch.bfloat16):
            before = K8.LAUNCHES["int8_dw"]
            dw, codes = K8.int8_dw_with_codes(gg, xx, out)
            torch.cuda.synchronize()
            ref = K8.int8_dw_ref(gg, xx, out)
            assert dw.dtype == out and K8.LAUNCHES["int8_dw"] == before + 1
            for got, want in zip(codes, (*K8.block_codes_ref(gg), *K8.block_codes_ref(xx))):
                assert torch.equal(got, want)
            err = (dw.float() - ref.float()).abs().max() / ref.float().abs().max()
            assert err.item() <= (1e-5 if out == torch.float32 else 8e-3)


def test_int8_dw_refuses_widths_off_128(cuda):
    """K8 takes O and I multiples of 128 (``dw_supported``) and raises
    otherwise, before any launch."""
    before = K8.LAUNCHES["int8_dw"]
    for o, i in ((192, 256), (256, 320)):
        g = torch.zeros((64, o), device=cuda)
        x = torch.zeros((64, i), device=cuda)
        with pytest.raises(ValueError, match="multiples of 128"):
            K8.int8_dw(g, x)
    assert K8.LAUNCHES["int8_dw"] == before


@pytest.mark.parametrize("pdt, gdt", [(torch.bfloat16, torch.float32),
                                      (torch.float32, torch.float32),
                                      (torch.bfloat16, torch.bfloat16),
                                      (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("shape, aligned", [
    ((96, 640), True), ((64, 3072), True),   # the register path, one block per row
    ((16, 6144), True), ((32, 15360), True),  # clusters of two and of four blocks per row
    ((4, 40000), True),       # a cluster of eight blocks of 640 threads
    ((40, 777), True),        # a ragged row: the L2 path
    ((2, 70000), True),       # wider than the register path holds: the L2 path
    ((48, 3072), False)])     # bases one element past 16 bytes: the L2 path
def test_adamw_quant_bit_identical(cuda, pdt, gdt, shape, aligned):
    """K4: K3's update plus the int8 copy of the stored p, on both of its
    paths."""
    g = torch.Generator(device=cuda).manual_seed(11)
    n = shape[0] * shape[1]

    def leaf(make):
        return make(shape) if aligned else make((n + 1,))[1:].view(shape)
    p, m = (leaf(lambda s: torch.randn(s, generator=g, device=cuda).to(pdt)) for _ in range(2))
    v = leaf(lambda s: torch.rand(s, generator=g, device=cuda).to(pdt))
    grad = torch.randn(shape, generator=g, device=cuda).to(gdt)
    assert (p.data_ptr() % 16 == 0) == aligned
    sc = torch.tensor([0.5, 1e-3, 1 / (1 - 0.9), 1 / (1 - 0.999)], device=cuda)
    want = KA.fused_adamw_quant_leaf_ref(p, m, v, grad, sc, 0.9, 0.999, 1e-8, 0.01)
    wq = torch.empty(shape, dtype=torch.int8, device=cuda)
    ws = torch.empty(shape[0], device=cuda)
    before = KA.LAUNCHES["fused_adamw_quant"]
    KA.fused_adamw_quant_leaf(p, m, v, grad, sc, wq, ws, 0.9, 0.999, 1e-8, 0.01)
    torch.cuda.synchronize()
    assert KA.LAUNCHES["fused_adamw_quant"] == before + 1
    for got, ref in zip((p, m, v, wq, ws), want):
        assert torch.equal(got, ref)


def _k6_check(p, m8, v8, grad, quant, sc):
    """K6 on one leaf against its plain version, within the bounds of the
    head of this file."""
    shape = p.shape
    want = KA.fused_adamw8_leaf_ref(p, m8, v8, grad, sc, 0.9, 0.999, 1e-8, 0.01, quant)
    wq = torch.empty(shape, dtype=torch.int8, device=p.device) if quant else None
    ws = torch.empty(shape[0], device=p.device) if quant else None
    name = "fused_adamw8_quant" if quant else "fused_adamw8"
    before = KA.LAUNCHES[name]
    KA.fused_adamw8_leaf(p, m8, v8, grad, sc, 0.9, 0.999, 1e-8, 0.01, wq=wq, ws=ws)
    torch.cuda.synchronize()
    assert KA.LAUNCHES[name] == before + 1
    assert (p.float() - want[0].float()).abs().max().item() <= 1e-6
    for got, ref in ((m8, want[1]), (v8, want[2])):
        d = (got.q.int() - ref.q.int()).abs()
        assert d.max().item() <= 1 and (d > 0).float().mean().item() < 1e-3
        assert ((got.s - ref.s).abs() <= 1e-6 * ref.s.abs()).all()
    if quant:
        assert torch.equal(wq, want[3]) and torch.equal(ws, want[4])
    return wq, ws


def _k6_leaf(g, shape, pdt=torch.bfloat16, gdt=torch.float32, aligned=True):
    p = (torch.randn(shape, generator=g, device="cuda") * 0.02).to(pdt)
    if not aligned:   # the same values on a base one element past 16 bytes
        p = torch.empty(p.numel() + 1, dtype=pdt, device="cuda")[1:].view(shape).copy_(p)
    grad = (torch.randn(shape, generator=g, device="cuda") * 1e-3).to(gdt)
    m8 = KA.m8_encode_m(torch.randn(shape, generator=g, device="cuda") * 1e-3)
    v8 = KA.m8_encode_v(10.0 ** (torch.rand(shape, generator=g, device="cuda") * 6 - 10))
    return p, m8, v8, grad


@pytest.fixture(scope="module")
def moment8_shapes():
    """One leaf shape per width of the 8-bit state: the stage-1 trainable
    leaves of configs/MetaCLIP_large_stage1.yaml that ``moment8_ok`` takes."""
    from pathlib import Path
    from genhancer_tpu_torch.tasks import factory
    from genhancer_tpu_torch.tasks.image import build_modules, trainable_predicate
    from genhancer_tpu_torch.train.config import load_config
    cfg = Path(__file__).resolve().parents[1] / "configs" / "MetaCLIP_large_stage1.yaml"
    spec, _, _ = factory.build_spec(load_config(str(cfg)))
    trains = trainable_predicate(spec)
    by_width = {}
    for n, w in build_modules(spec, device="meta").named_parameters():
        if trains(n) and KA.moment8_ok(w):
            by_width.setdefault(w.shape[1], tuple(w.shape))
    return [by_width[c] for c in sorted(by_width)]


@pytest.mark.parametrize("quant", [False, True])
def test_adamw8_at_every_state_width(cuda, moment8_shapes, quant):
    """K6, both bodies, on one leaf of each width of the 8-bit state, so
    that each cluster size of the register path runs; the second path gives
    the same bits on copies."""
    g = torch.Generator(device=cuda).manual_seed(13)
    sc = torch.tensor([1.0, 1e-3, 1.1, 1.05], device=cuda)
    assert moment8_shapes[0][1] == 256 and moment8_shapes[-1][1] == 15360, moment8_shapes
    for shape in moment8_shapes:
        p, m8, v8, grad = _k6_leaf(g, shape)
        # the second path (p one element past 16 bytes) on copies: the same bits
        p2 = torch.empty(p.numel() + 1, dtype=p.dtype, device=cuda)[1:].view(shape).copy_(p)
        m2, v2 = (KA.Moment8(*(t.clone() for t in mom)) for mom in (m8, v8))
        wq2 = torch.empty(shape, dtype=torch.int8, device=cuda) if quant else None
        ws2 = torch.empty(shape[0], device=cuda) if quant else None
        KA.fused_adamw8_leaf(p2, m2, v2, grad, sc, 0.9, 0.999, 1e-8, 0.01, wq=wq2, ws=ws2)
        wq, ws = _k6_check(p, m8, v8, grad, quant, sc)
        for got, want in zip((p, *m8, *v8) + ((wq, ws) if quant else ()),
                             (p2, *m2, *v2) + ((wq2, ws2) if quant else ())):
            assert torch.equal(got, want)


@pytest.mark.parametrize("shape, pdt, gdt, aligned", [
    ((48, 3072), torch.bfloat16, torch.float32, False),   # p's base past 16 bytes
    ((40, 777), torch.bfloat16, torch.float32, True),     # a ragged row
    ((4, 40000), torch.bfloat16, torch.float32, True),    # wider than the register path
    ((64, 3072), torch.float32, torch.bfloat16, True),    # float32 p, bfloat16 grads
    ((16, 6144), torch.bfloat16, torch.bfloat16, True),   # a cluster of two blocks
    ((8, 24576), torch.bfloat16, torch.float32, True)])   # a cluster of eight blocks
@pytest.mark.parametrize("quant", [False, True])
def test_adamw8_edges_and_second_path(cuda, quant, shape, pdt, gdt, aligned):
    """K6 where its body differs from the stage-1 leaves': the second path
    (adamw8_kernel) for a misaligned p, a ragged row and a row wider than
    the register path holds; float32 p; eight blocks per row."""
    g = torch.Generator(device=cuda).manual_seed(14)
    sc = torch.tensor([0.5, 1e-3, 1 / (1 - 0.9), 1 / (1 - 0.999)], device=cuda)
    p, m8, v8, grad = _k6_leaf(g, shape, pdt, gdt, aligned)
    assert (p.data_ptr() % 16 == 0) == aligned
    _k6_check(p, m8, v8, grad, quant, sc)


@pytest.mark.parametrize("quant", [False, True])
def test_adamw8_matches_plain(cuda, quant):
    """K6, both bodies, on a moment8_ok leaf."""
    g = torch.Generator(device=cuda).manual_seed(12)
    shape = (256, 1024)
    p = (torch.randn(shape, generator=g, device=cuda) * 0.02).to(torch.bfloat16)
    grad = torch.randn(shape, generator=g, device=cuda) * 1e-3
    m8 = KA.m8_encode_m(torch.randn(shape, generator=g, device=cuda) * 1e-3)
    v8 = KA.m8_encode_v(10.0 ** (torch.rand(shape, generator=g, device=cuda) * 6 - 10))
    sc = torch.tensor([1.0, 1e-3, 1.1, 1.05], device=cuda)
    want = KA.fused_adamw8_leaf_ref(p, m8, v8, grad, sc, 0.9, 0.999, 1e-8, 0.01, quant)
    wq = torch.empty(shape, dtype=torch.int8, device=cuda) if quant else None
    ws = torch.empty(shape[0], device=cuda) if quant else None
    name = "fused_adamw8_quant" if quant else "fused_adamw8"
    before = KA.LAUNCHES[name]
    KA.fused_adamw8_leaf(p, m8, v8, grad, sc, 0.9, 0.999, 1e-8, 0.01, wq=wq, ws=ws)
    torch.cuda.synchronize()
    assert KA.LAUNCHES[name] == before + 1
    assert (p.float() - want[0].float()).abs().max().item() <= 1e-6
    for got, ref in ((m8, want[1]), (v8, want[2])):
        d = (got.q.int() - ref.q.int()).abs()
        assert d.max().item() <= 1 and (d > 0).float().mean().item() < 1e-3
        assert ((got.s - ref.s).abs() <= 1e-6 * ref.s.abs()).all()
    if quant:
        assert torch.equal(wq, want[3]) and torch.equal(ws, want[4])


# A standalone check of K6's fast paths, compiled against csrc/adamw.cu: it
# counts, per fast path, the inputs it takes and those whose bits differ
# from the accurate operation's, and exits non-zero if any differ.
FAST_PATHS_CHECK = r"""
#include <cstdio>
__device__ unsigned long long n_ok[4], n_bad[4], n_slow[4];

__device__ __forceinline__ uint32_t mix(uint64_t x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ULL;
  x ^= x >> 33;
  return (uint32_t)x;
}

__device__ void tally(int k, unsigned long long ok, unsigned long long bad,
                      unsigned long long slow) {
  atomicAdd(&n_ok[k], ok);
  atomicAdd(&n_bad[k], bad);
  atomicAdd(&n_slow[k], slow);
}

__global__ void check_sqrt() {
  unsigned long long ok = 0, bad = 0, slow = 0;
  for (uint64_t b = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x; b < 0x7f800000ull;
       b += (uint64_t)gridDim.x * blockDim.x) {
    const float x = __uint_as_float((uint32_t)b);
    bool f;
    const float s = sqrt_fast(x, f);
    if (!f) { ++slow; continue; }
    ++ok;
    bad += __float_as_uint(s) != __float_as_uint(__fsqrt_rn(x));
  }
  tally(0, ok, bad, slow);
}

__global__ void check_div(uint64_t n) {
  unsigned long long ok = 0, bad = 0, slow = 0;
  for (uint64_t i = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x; i < n;
       i += (uint64_t)gridDim.x * blockDim.x) {
    const uint32_t a = mix(2 * i), b = mix(2 * i + 1);
    const float x = __uint_as_float((a & 0x807fffffu) | ((57u + (a >> 8) % 141u) << 23));
    const float y = __uint_as_float((b & 0x807fffffu) | ((57u + (b >> 8) % 141u) << 23));
    bool f;
    const float q = div_fast(x, y, f);
    if (!f || fabsf(y) < 0x1p-64f || fabsf(y) >= 0x1p64f) { ++slow; continue; }
    ++ok;
    bad += __float_as_uint(q) != __float_as_uint(__fdiv_rn(x, y));
  }
  tally(1, ok, bad, slow);
}

__global__ void check_log(uint64_t n) {
  unsigned long long ok = 0, bad = 0, slow = 0;
  for (uint64_t i = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x; i < n;
       i += (uint64_t)gridDim.x * blockDim.x) {
    const uint32_t a = mix(i + (1ull << 40));
    const float x = __uint_as_float((a & 0x007fffffu) | ((80u + (a >> 23) % 47u) << 23));
    bool f;
    const float k = log_code_fast(x, 1.0f, f);
    if (!f) { ++slow; continue; }
    ++ok;
    bad += k != m8_log_code(x, 1.0f);
  }
  tally(2, ok, bad, slow);
}

__global__ void check_w(uint64_t n) {
  unsigned long long ok = 0, bad = 0, slow = 0;
  for (uint64_t i = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x; i < n;
       i += (uint64_t)gridDim.x * blockDim.x) {
    const uint32_t a = mix(2 * i + (1ull << 41)), b = mix(2 * i + 1 + (1ull << 41));
    const float amax = __uint_as_float((b & 0x007fffffu) | ((60u + (b >> 23) % 90u) << 23));
    const float ws = w_scale(amax);
    const float p = __fmul_rn(amax, (float)(a >> 8) * 0x1p-23f - 1.0f);  // |p| <= amax
    bool f;
    const int8_t c = w_code_fast(p, __frcp_rn(ws), f);
    if (!f) { ++slow; continue; }
    ++ok;
    bad += c != w_code(p, ws);
  }
  tally(3, ok, bad, slow);
}

int main() {
  check_sqrt<<<1024, 256>>>();
  check_div<<<1024, 256>>>(1ull << 32);
  check_log<<<1024, 256>>>(1ull << 31);
  check_w<<<1024, 256>>>(1ull << 32);
  const cudaError_t err = cudaDeviceSynchronize();
  unsigned long long ok[4], bad[4], slow[4];
  cudaMemcpyFromSymbol(ok, n_ok, sizeof(ok));
  cudaMemcpyFromSymbol(bad, n_bad, sizeof(bad));
  cudaMemcpyFromSymbol(slow, n_slow, sizeof(slow));
  const char* name[4] = {"sqrt_fast", "div_fast", "log_code_fast", "w_code_fast"};
  printf("cuda %d;", (int)err);
  for (int k = 0; k < 4; ++k)
    printf(" %s: %llu fast, %llu differ, %llu to the accurate path;", name[k], ok[k], bad[k],
           slow[k]);
  printf("\n");
  return err != cudaSuccess || bad[0] + bad[1] + bad[2] + bad[3] != 0;
}
"""


def test_k6_fast_paths_are_exact(cuda, tmp_path):
    """K6's branch-free fast paths (``csrc/adamw.cu``) give the accurate
    operations' bits wherever they report ok: every non-negative finite
    float through ``sqrt_fast``, 2^32 operand pairs through ``div_fast``
    (exponents in [-70, 70]), 2^31 ratios through ``log_code_fast`` and 2^32
    (p, max|p|) pairs through ``w_code_fast`` (K8's ``code_fast`` is the
    same arithmetic).  Run with ``-s`` to see the counts."""
    from genhancer_tpu_torch.core.kernels import _build
    src = tmp_path / "fast_paths.cu"
    src.write_text(f'#include "{_build.CSRC / "adamw.cu"}"\n' + FAST_PATHS_CHECK)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    exe = tmp_path / "fast_paths"
    build = subprocess.run([_build._nvcc(), *flags, "-o", str(exe), str(src)],
                           capture_output=True, text=True)
    assert build.returncode == 0, build.stdout + build.stderr
    run = subprocess.run([str(exe)], capture_output=True, text=True, timeout=300)
    print(f"[fast paths] {run.stdout.strip()}")
    assert run.returncode == 0, run.stdout
