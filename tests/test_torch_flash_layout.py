"""The layout rule of the bf16 wgmma/TMA attention kernels (K1, K2, K1b,
K2b, K5, K5b), on the CPU.

The kernels read q, k, v (and the backward's dO) through TMA tensor maps:
D contiguous, each base pointer and each B/L/H stride a multiple of 16
bytes (``short_attention._tma_layout_error``, which reads only shapes,
strides, dtypes and ``data_ptr() % 16``).  The models must pass it without
a copy: the q/k/v are recorded where the DiT hands them to the
long-sequence attention (a tiny bf16 forward at a joint length of 608, both
block kinds), where the DiT hands them to K1 (joint length 72: the double
block concatenates, the single block passes a strided ``v`` view) and where
a tiny bf16 tower hands them to K2 and, training, to K2b (with o and dO),
where the CLIP-L/14@336 LoRA tower of video stage 2 hands them over at
L=577 (forward, ``tower_remat`` recompute, backward), where the SigLIP
so400m tower hands them to K5 at L=729, D=72 and, training as stage 2
trains it, to K5b (with o and dO), and built at the published flux-dev
widths.  Views the TMA cannot read are refused with the ``ValueError`` the
CUDA path raises (``_check_tma_layout``, the same call the wrappers make
before a launch).
"""

import re

import pytest
import torch

from genhancer_tpu_torch.core import attention as A
from genhancer_tpu_torch.core.kernels import short_attention as K
from genhancer_tpu_torch.core.rope import apply_rope, multi_axis_rope
from genhancer_tpu_torch.models import dit as tdit

torch.set_num_threads(1)
BF16 = torch.bfloat16


def _tiny_dit_attention_inputs(monkeypatch, l_img=600, target=(A, "sdpa")):
    """q, k, v of every call of ``target`` (module, name) in a tiny bf16 DiT
    forward (1 double block, 1 single block, l_img + 8 joint tokens): the
    long-sequence attention by default."""
    cfg = tdit.DiTConfig(in_channels=64, vec_in_dim=32, context_in_dim=48, hidden_size=128,
                         num_heads=2, depth=1, depth_single_blocks=1, axes_dim=(16, 24, 24))
    g = torch.Generator().manual_seed(0)
    model = tdit.DiT(cfg, dtype=BF16)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.02 * torch.randn(p.shape, generator=g))
    calls = []

    def record(q, k, v, *tables):
        calls.append((q, k, v))
        return torch.zeros_like(q)

    monkeypatch.setattr(*target, record)
    b, l_txt = 1, 8
    ids = lambda n: torch.randint(0, 16, (b, n, 3), generator=g).to(torch.float32)  # noqa: E731
    with torch.no_grad():
        tdit.dit_forward(model, cfg, img=torch.randn((b, l_img, 64), generator=g).to(BF16),
                         img_ids=ids(l_img),
                         txt=torch.randn((b, l_txt, 48), generator=g).to(BF16),
                         txt_ids=ids(l_txt), timesteps=torch.rand(b, generator=g),
                         y=torch.randn((b, 32), generator=g).to(BF16),
                         guidance=torch.full((b,), 4.0))
    return calls


def test_dit_attention_inputs_pass(monkeypatch):
    calls = _tiny_dit_attention_inputs(monkeypatch)
    assert len(calls) == 2                  # the double block, then the single block
    for q, k, v in calls:
        assert q.dtype == BF16 and q.shape[1] == 608 and q.shape[-1] == 64
        assert K._tma_layout_error(q, k, v) is None
        K._check_tma_layout("flash_attention", q, k, v)
    # the single block hands over a strided view of linear1's output, not a copy
    v_single = calls[1][2]
    assert not v_single.is_contiguous() and v_single.stride(1) == 3 * 128 + 4 * 128


def test_dit_short_attention_inputs_pass(monkeypatch):
    """What K1 receives (q, k before the rotation, v; K1 writes the rotated
    pair itself, contiguous) at a joint length of 72, both block kinds."""
    calls = _tiny_dit_attention_inputs(monkeypatch, 64, (K, "fused_rope_attention"))
    assert len(calls) == 2
    for q, k, v in calls:
        assert q.dtype == BF16 and q.shape[1] == 72 and q.shape[-1] == 64
        assert K._tma_layout_error(q, k, v) is None
        K._check_tma_layout("fused_rope_attention", q, k, v)
    v_double, v_single = calls[0][2], calls[1][2]
    assert v_double.is_contiguous()         # torch.cat of the txt and img streams
    assert not v_single.is_contiguous() and v_single.stride(1) == 3 * 128 + 4 * 128


def test_tower_attention_inputs_pass(monkeypatch):
    """What K2 receives in a tiny bf16 vision tower (1 layer, 17 tokens), and
    what K2b receives when the tower trains as stage 2 trains it (LoRA on
    every linear, a nonzero B, the base frozen, dropout on): q, k, v, the
    forward's o and dO."""
    from genhancer_tpu_torch.models.towers import clip as tclip
    cfg = tclip.CLIPVisionConfig(hidden_size=128, intermediate_size=256, num_layers=1,
                                 num_heads=2, image_size=32, patch_size=8)
    g = torch.Generator().manual_seed(1)
    tower = tclip.VisionTransformer(cfg, device=None, dtype=BF16)
    with torch.no_grad():
        for p in tower.parameters():
            p.copy_(0.02 * torch.randn(p.shape, generator=g))
    pixels = torch.randn((2, 32, 32, 3), generator=g).to(BF16)
    calls, bwd_calls = [], []

    def record(q, k, v):
        calls.append((q, k, v))
        return torch.zeros_like(q)

    with monkeypatch.context() as mp:
        mp.setattr(K, "fused_attention", record)
        with torch.no_grad():
            tclip.vision_forward(tower, pixels, cfg)
    assert len(calls) == 1
    q, k, v = calls[0]
    assert q.dtype == BF16 and q.shape == (2, 17, 2, 64)
    assert K._tma_layout_error(q, k, v) is None
    K._check_tma_layout("fused_attention", q, k, v)

    bwd_ref = K.fused_attention_bwd_ref

    def record_bwd(q, k, v, o, do):
        bwd_calls.append((q, k, v, o, do))
        return bwd_ref(q, k, v, o, do)

    monkeypatch.setattr(K, "fused_attention_bwd_ref", record_bwd)
    from genhancer_tpu_torch.core.nn import lora_dropout_ctx
    from genhancer_tpu_torch.train import lora
    tower.requires_grad_(False)
    _, wrapped = lora.inject(tower, g, r=16, alpha=16.0)
    assert len(wrapped) == 6
    with torch.no_grad():
        for path in wrapped:
            tower.get_submodule(path).lora_B.normal_(0.0, 0.02, generator=g)
    with lora_dropout_ctx(g, 0.1):
        x, pooled = tclip.vision_forward(tower, pixels, cfg)
    (x.float().square().mean() + pooled.float().sum()).backward()
    assert len(bwd_calls) == 1
    assert tower.get_submodule(wrapped[0]).lora_A.grad.abs().sum() > 0
    assert all(t.dtype == BF16 and t.shape == (2, 17, 2, 64) for t in bwd_calls[0])
    assert K._tma_layout_error(*bwd_calls[0]) is None
    K._check_tma_layout("fused_attention_bwd", *bwd_calls[0])


def test_middle336_lora_tower_attention_inputs_pass(monkeypatch):
    """What K2 and K2b receive from the OpenAI CLIP-L/14@336 tower of video
    stage 2 at L=577 (one layer at the published width, hidden 1024 in 16
    heads of 64, LoRA on every linear, dropout on, ``tower_remat`` on): q,
    k, v of the forward and of the recompute, and q, k, v, o and dO of the
    backward."""
    from genhancer_tpu_torch.core.nn import lora_dropout_ctx
    from genhancer_tpu_torch.models.towers import clip as tclip
    from genhancer_tpu_torch.models.towers.encoder import tower_remat_scope
    from genhancer_tpu_torch.train import lora
    cfg = tclip.CLIPVisionConfig(num_layers=1, image_size=336)
    g = torch.Generator().manual_seed(2)
    tower = tclip.VisionTransformer(cfg, device=None, dtype=BF16)
    with torch.no_grad():
        for p in tower.parameters():
            p.copy_(0.02 * torch.randn(p.shape, generator=g))
    tower.requires_grad_(False)
    _, wrapped = lora.inject(tower, g, r=16, alpha=16.0)
    with torch.no_grad():
        for path in wrapped:
            tower.get_submodule(path).lora_B.normal_(0.0, 0.02, generator=g)
    fwd, bwd = [], []
    fwd_ref, bwd_ref = K.fused_attention_ref, K.fused_attention_bwd_ref

    def record_fwd(q, k, v):
        fwd.append((q, k, v))
        return fwd_ref(q, k, v)

    def record_bwd(q, k, v, o, do):
        bwd.append((q, k, v, o, do))
        return bwd_ref(q, k, v, o, do)

    monkeypatch.setattr(K, "fused_attention_ref", record_fwd)
    monkeypatch.setattr(K, "fused_attention_bwd_ref", record_bwd)
    pixels = torch.randn((1, 336, 336, 3), generator=g).to(BF16)
    with lora_dropout_ctx(g, 0.1), tower_remat_scope(True):
        x, _ = tclip.vision_forward(tower, pixels, cfg)
    x.float().square().mean().backward()
    assert len(fwd) == 2 and len(bwd) == 1       # the forward, its recompute, K2b
    for ts in fwd + bwd:
        assert all(t.dtype == BF16 and t.shape == (1, 577, 16, 64) for t in ts)
        assert K._tma_layout_error(*ts) is None
    K._check_tma_layout("fused_attention_bwd", *bwd[0])


def test_siglip_lora_tower_attention_inputs_pass(monkeypatch):
    """What K5 and K5b receive from the SigLIP so400m tower at 384 px (one
    layer at the published width: hidden 1152 in 16 heads of 72, 729
    tokens; LoRA on ``SIGLIP_TARGETS``, a nonzero B, dropout on, under
    autograd as stage 2 runs it): q, k, v of the forward and q, k, v, o and
    dO of the backward.  The head stride is 144 bytes and the token stride
    2304, both multiples of 16; the MAP head's probe takes no kernel."""
    from genhancer_tpu_torch.core.kernels import flash_attention as F
    from genhancer_tpu_torch.core.nn import lora_dropout_ctx
    from genhancer_tpu_torch.models.towers import siglip as tsiglip
    from genhancer_tpu_torch.train import lora
    cfg = tsiglip.SiglipVisionConfig(num_layers=1, image_size=384)
    g = torch.Generator().manual_seed(3)
    tower = tsiglip.VisionTransformer(cfg, device=None, dtype=BF16)
    with torch.no_grad():
        for p in tower.parameters():
            p.copy_(0.02 * torch.randn(p.shape, generator=g))
    tower.requires_grad_(False)
    _, wrapped = lora.inject(tower, g, r=16, alpha=16.0, targets=lora.SIGLIP_TARGETS)
    assert len(wrapped) == 6 + 3
    with torch.no_grad():
        for path in wrapped:
            tower.get_submodule(path).lora_B.normal_(0.0, 0.02, generator=g)
    fwd, bwd = [], []
    fwd_ref, bwd_ref = F.flash_attention_fwd_ref, F.flash_attention_bwd_ref

    def record_fwd(q, k, v):
        fwd.append((q, k, v))
        return fwd_ref(q, k, v)

    def record_bwd(q, k, v, o, lse, do):
        bwd.append((q, k, v, o, do))
        return bwd_ref(q, k, v, o, lse, do)

    monkeypatch.setattr(F, "flash_attention_fwd_ref", record_fwd)
    monkeypatch.setattr(F, "flash_attention_bwd_ref", record_bwd)
    pixels = torch.randn((1, 384, 384, 3), generator=g).to(BF16)
    with lora_dropout_ctx(g, 0.1):
        x, pooled = tsiglip.vision_forward(tower, pixels, cfg)
    (x.float().square().mean() + pooled.float().sum()).backward()
    assert len(fwd) == 1 and len(bwd) == 1
    assert tower.get_submodule(wrapped[0]).lora_A.grad.abs().sum() > 0
    for ts in fwd + bwd:
        assert all(t.dtype == BF16 and t.shape == (1, 729, 16, 72) for t in ts)
        assert K._tma_layout_error(*ts) is None
    q = fwd[0][0]
    assert q.stride(2) * 2 == 144 and q.stride(1) * 2 == 2304
    K._check_tma_layout("flash_attention", *fwd[0])
    K._check_tma_layout("flash_attention_bwd", *bwd[0])


def test_published_width_layouts_pass():
    """flux-dev: hidden 3072, 24 heads of 128, mlp 12288; linear1's output
    rows are 3 * 3072 + 12288 = 21504 wide."""
    b, l, h, d, hidden = 2, 8, 24, 128, 3072
    lin1 = torch.zeros((b, l, 3 * hidden + 4 * hidden), dtype=BF16)
    q, k, v = tdit._split_qkv(lin1[..., : 3 * hidden], h)
    assert v.stride(1) == 21504
    ids = torch.zeros((b, l, 3))
    cos, sin = multi_axis_rope(ids, (16, 56, 56), 10_000)
    rq, rk = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    assert K._tma_layout_error(rq, rk, v) is None            # single blocks
    txt = torch.zeros((b, 4, 3 * hidden), dtype=BF16)
    tq, tk, tv = tdit._split_qkv(txt, h)
    cq, ck, cv = (torch.cat([t, i], dim=1) for t, i in ((tq, q), (tk, k), (tv, v)))
    cos, sin = multi_axis_rope(torch.zeros((b, 12, 3)), (16, 56, 56), 10_000)
    assert K._tma_layout_error(apply_rope(cq, cos, sin), apply_rope(ck, cos, sin),
                               cv) is None                   # double blocks
    # the strided views chip_smoke.py checks on the card: row stride 3 H D + 64
    fused = torch.zeros((b, l, 3 * h * d + 64), dtype=BF16)
    assert K._tma_layout_error(*(x.reshape(b, l, h, d)
                                 for x in fused[..., : 3 * h * d].split(h * d, -1))) is None


def _views(kind):
    b, l, h, d = 2, 16, 3, 64
    fused = torch.zeros((b, l, 3 * h * d + 16), dtype=BF16)
    good = fused[..., : h * d].reshape(b, l, h, d)
    if kind == "misaligned by one element":
        bad = fused[..., 1: 1 + h * d].reshape(b, l, h, d)
        return good, bad, "16-byte-aligned base pointer"
    if kind == "D not contiguous":
        wide = torch.zeros((b, l, h, 2 * d), dtype=BF16)
        return good, wide[..., ::2], "D must be contiguous"
    if kind == "row stride not a multiple of 16 bytes":
        odd = torch.zeros((b, l, h * d + 4), dtype=BF16)
        return good, odd[..., : h * d].reshape(b, l, h, d), "multiple of 16 bytes"
    raise AssertionError(kind)


@pytest.mark.parametrize("name", ["flash_attention", "fused_rope_attention", "fused_attention",
                                  "fused_rope_attention_bwd", "fused_attention_bwd"])
@pytest.mark.parametrize("kind", ["misaligned by one element", "D not contiguous",
                                  "row stride not a multiple of 16 bytes"])
def test_layouts_the_tma_cannot_read_are_refused(kind, name):
    good, bad, why = _views(kind)
    assert K._tma_layout_error(good, good, good) is None
    err = K._tma_layout_error(good, bad, good)
    assert err is not None and why in err and err.startswith("operand 1")
    with pytest.raises(ValueError, match=re.escape(f"{name}: {err}")):
        K._check_tma_layout(name, good, bad, good)
    # the float32 kernels load their tiles with the threads and take any B/L/H strides
    K._check_tma_layout(name, good.float(), bad.float(), good.float())


def test_size_one_dims_do_not_count():
    """A stride of a length-1 dimension is never followed: it neither fails
    the rule nor reaches the tensor map."""
    x = torch.zeros((1, 16, 1, 64), dtype=BF16).as_strided((1, 16, 1, 64), (3, 64, 5, 1))
    assert K._tma_layout_error(x, x, x) is None
    assert K._tma_strides(x) == [16 * 64, 64, 64]
