"""K7's host-side rules on the CPU (``core/kernels/rowquant.py``).

* ``rowquant_tiling`` reaches every column of every row exactly once, within
  the bodies' limits, at every K7 shape of the int8 paths — taken from the
  model itself: the int8 tower's linears (T = 32 x 257 tokens, and T = 32
  for ``visual_projection``) and the DiT's SwitchBack linears
  (``switchback_cache_paths`` on meta tensors; inputs and column-scaled
  gradients at T = 32, 6272 and 6304) — and at the odd shapes, which must
  take the scalar body where the vector loads cannot run.  The coverage is
  the index arithmetic of ``csrc/rowquant.cu`` (``rowquant_warp_kernel``,
  ``rowquant_block_kernel``), written out in numpy.
* The kernel's fast codes (``code_fast``, ``store_codes``): the product with
  the row's reciprocal scale, rounded by adding 1.5 * 2^23, whose low byte is
  the code, kept where it lies further than 2^-12 from a half-way point and
  otherwise redone with the IEEE division — emulated in torch float32 — give
  the codes of ``rowquant_ref`` bit for bit, on random rows and on planted
  half-way rows, where the product alone rounds the wrong way.
"""

import numpy as np
import pytest
import torch

from genhancer_tpu_torch.core.kernels import rowquant as K7

torch.set_num_threads(1)

INT8_CONFIG = "configs/tpu_fast_stage1.yaml"
MAGIC = 12582912.0     # 1.5 * 2^23


def _main_path_shapes():
    """(T, C, column-scaled) of every K7 call of one int8 micro-batch (B=32),
    from the modules of ``configs/tpu_fast_stage1.yaml`` on meta tensors."""
    from genhancer_tpu_torch.core import quant as tq
    from genhancer_tpu_torch.tasks import factory
    from genhancer_tpu_torch.tasks.image import build_modules
    from genhancer_tpu_torch.train.config import load_config
    from pathlib import Path
    cfg = load_config(str(Path(__file__).resolve().parents[1] / INT8_CONFIG))
    spec, _, _ = factory.build_spec(cfg)
    mods = build_modules(spec, device="meta")
    tower = mods["clip"]["model"]
    shapes = set()
    for path in tq.quantize_linear_tree(tower):
        t = 32 if path == "visual_projection" else 32 * 257
        shapes.add((t, tower.get_submodule(path).weight_q.shape[1], False))
    flat = dict(mods.named_parameters())
    for path in tq.switchback_cache_paths(flat):
        o, i = flat[path].shape
        for t in (32, 6272, 6304):
            shapes |= {(t, i, False), (t, o, True)}
    return sorted(shapes)


MAIN_PATH = _main_path_shapes()
# (T, C, itemsize, aligned): ragged and misaligned inputs, rows that only the
# cluster or the re-reading body reaches
ODD = [(777, 3000, 2, True), (777, 777, 2, True), (300, 777, 4, True), (5, 60000, 4, True),
       (300, 60000, 4, True), (6304, 3072, 2, False), (32, 18432, 4, False), (1, 8, 2, True),
       (2 * K7.SMS - 1, 21504, 2, True), (3, 200000, 2, True), (3, 600000, 2, True)]


def _covers_once(idx, n):
    idx = idx[idx < n]
    return np.array_equal(np.bincount(idx, minlength=n), np.ones(n, np.int64))


def _check_tiling(t, c, itemsize, aligned):
    tl = K7.rowquant_tiling(t, c, itemsize, aligned)
    assert tl.body in K7.BODIES
    if not aligned or c % K7.UNIT:
        assert tl.body == "scalar", (t, c, itemsize, aligned, tl)
    if tl.body == "scalar":
        # one block per row, columns tid, tid + threads, ...: every column once
        assert (tl.rows_per_block, tl.threads, tl.cluster, tl.units) == (1, K7.SCALAR_THREADS, 1, 0)
        return tl
    n = c // K7.UNIT
    assert tl.units * itemsize // 2 <= K7.MAX_VECTORS
    assert tl.threads % 32 == 0 and 1 <= tl.cluster <= 8 and tl.cluster & (tl.cluster - 1) == 0
    if tl.body == "warp":
        # row = block * rows_per_block + warp; lane l holds units l + 32 j
        assert tl.units in K7.WARP_UNITS
        assert tl.threads == 32 * tl.rows_per_block <= 256 and tl.cluster == 1
        blocks = -(-t // tl.rows_per_block)
        rows = (np.arange(blocks)[:, None] * tl.rows_per_block
                + np.arange(tl.rows_per_block)[None, :]).ravel()
        units = (np.arange(32)[:, None] + 32 * np.arange(tl.units)[None, :]).ravel()
    else:
        # row = block // cluster; thread t of block k holds units
        # k * threads + t + j * cluster * threads
        assert tl.units in K7.BLOCK_UNITS
        assert tl.rows_per_block == 1 and tl.threads <= K7.BLOCK_THREADS
        rows = np.arange(t * tl.cluster) // tl.cluster
        rows = rows[np.arange(t * tl.cluster) % tl.cluster == 0]
        team = tl.cluster * tl.threads
        units = (np.arange(team)[:, None] + team * np.arange(tl.units)[None, :]).ravel()
        assert tl.cluster == 1 or t < 2 * K7.SMS   # clusters only where rows are few
    assert _covers_once(rows, t) and _covers_once(units, n), (t, c, itemsize, tl)
    return tl


@pytest.mark.parametrize("itemsize", [2, 4])
def test_tiling_covers_every_main_path_call(itemsize):
    """Every K7 call of the int8 paths (bfloat16 as they run, and float32)
    runs a vector body that reaches each row and column once: a warp per
    row up to 1024 columns, a block per row above, a cluster per row at T =
    32 from 3072 columns."""
    assert len(MAIN_PATH) > 20
    for t, c, _ in MAIN_PATH:
        tl = _check_tiling(t, c, itemsize, True)
        assert tl.body != "scalar", (t, c, tl)
        assert tl.body == ("warp" if c <= 1024 else "block"), (t, c, tl)
        if t == 32 and c >= 3072:
            assert tl.cluster > 1, (t, c, tl)


@pytest.mark.parametrize("t, c, itemsize, aligned", ODD)
def test_tiling_of_odd_calls(t, c, itemsize, aligned):
    tl = _check_tiling(t, c, itemsize, aligned)
    if (t, c) in ((300, 60000), (3, 600000)):   # wider than any vector body holds
        assert tl.body == "scalar"
    if (t, c) == (3, 200000):
        assert tl.body == "block" and tl.cluster == 8


def test_only_a_cpu_tensor_takes_the_plain_version():
    """The wrapper's plain path is for CPU tensors alone: a tensor on another
    device (here meta) raises instead of falling back."""
    x = torch.zeros((4, 16))
    q, s = K7.rowquant(x)
    assert q.dtype == torch.int8 and s.shape == (4,)
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        K7.rowquant(x.to("meta"))


def _fast_codes(x2, cs=None):
    """The kernel's code rule in float32: (codes, codes without the IEEE
    redo, number of elements redone)."""
    xf = x2.to(torch.float32)
    if cs is not None:
        xf = xf * cs
    s = K7.div127(torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-12))
    r = torch.ones_like(s) / s
    y = xf * r
    t = y + MAGIC
    ok = (y - (t - MAGIC)).abs() < 0.5 - 2.0 ** -12
    fast = (t.view(torch.int32) & 0xFF).to(torch.uint8).view(torch.int8)
    exact = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return torch.where(ok, fast, exact), fast, int((~ok).sum())


def _halfway_rows(t, c, scale, dtype):
    """Rows whose elements are scale * (k + 0.5), k in [-127, 126], and whose
    maximum is 127 * scale, so s = scale and every element is half-way."""
    k = (torch.arange(t * c) % 254 - 127).reshape(t, c).to(torch.float32)
    x = (k + 0.5) * scale
    x[:, 0] = 127.0 * scale
    return x.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_cs", [False, True])
def test_fast_codes_equal_ieee_codes_on_random_rows(dtype, with_cs):
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((257, 1000)).astype(np.float32)
                         * np.exp(rng.standard_normal((257, 1))).astype(np.float32)).to(dtype)
    cs = torch.from_numpy(np.exp(rng.standard_normal(1000)).astype(np.float32)) if with_cs else None
    q, _, _ = _fast_codes(x, cs)
    rq, _ = K7.rowquant_ref(x, cs)
    assert torch.equal(q, rq)


@pytest.mark.parametrize("dtype, scale, cs_scale", [
    (torch.float32, 1.0, None), (torch.bfloat16, 1.0, None),     # s = 1: a r = a / s
    (torch.float32, 7.0, None), (torch.float32, 0.3, None),      # s not a power of two
    (torch.bfloat16, 1.0, 7.0)])                                 # s = 7 from the column scale
def test_fast_codes_equal_ieee_codes_on_halfway_rows(dtype, scale, cs_scale):
    x = _halfway_rows(64, 254, scale, dtype)
    cs = None if cs_scale is None else torch.full((254,), cs_scale)
    q, fast, redone = _fast_codes(x, cs)
    rq, rs = K7.rowquant_ref(x, cs)
    assert torch.equal(q, rq)
    assert redone >= 64 * 253 - 64 * 8   # the guard catches (nearly) every planted element
    if 7.0 in (scale, cs_scale):
        assert torch.equal(rs, torch.full((64,), 7.0))
        # a r rounds the wrong way on some of them: the IEEE redo is what makes it exact
        assert not torch.equal(fast, rq)
