"""K4 (AdamW with the int8 weight emission) and K6 (AdamW on 8-bit moments),
plain versions on the CPU, against the JAX package's Pallas kernels in
interpret mode (genhancer_tpu/core/pallas/adamw.py), and the 8-bit moments
through the port's optimizer-state checkpoint.

Bounds, each with its reason:
  * K4 through the tree-level ``fused_adamw_apply(quant_paths=...)``, at
    small leaves (the JAX side's XLA update), a ragged one and the cached
    widths (its Pallas kernel):
    p, m, v within one ulp of the storage dtype (as K3's test holds them:
    the same float32 formula, where XLA may contract a multiply-add); the
    emitted codes identical or one apart at a rate below 1e-3 and the scales
    within 1e-6 relative (the interpreted kernel runs under jit, where XLA
    may turn ``/ 127`` into ``* (1 / 127)``);
  * K6, both bodies, against ``_update_leaf_pallas8``: the contract of
    tests/test_adamw8.py — p within 1e-6 absolute, codes at most one apart
    at a rate below 1e-3 (XLA's and torch's log2 round some ties apart),
    scales within 1e-6 relative; the emitted weight copy as K4's.  With a
    bfloat16 p, the float32 update moves by an ulp where XLA's and torch's
    exp2 decode a moment one ulp apart, and a few elements (3 in 65536
    here) round to the neighbouring bfloat16: there p is held to one bf16
    ulp at a rate below 1e-3, and 1e-6 elsewhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from genhancer_tpu.core.pallas import adamw as jadamw
from genhancer_tpu_torch.core.kernels import adamw as KA
from genhancer_tpu_torch.train import checkpoint as ckpt
from genhancer_tpu_torch.train import optim
from genhancer_tpu_torch.train.state import TrainState

from test_torch_parity import f32, t

torch.set_num_threads(1)

HYPER = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01)


def _codes_close(got, want, rate=1e-3):
    d = np.abs(got.numpy().astype(np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1 and (d > 0).mean() < rate, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("leaves, pallas", [
    # below the Pallas kernel's 64k elements: the JAX side's XLA update
    ({"dit.x.weight": ((64, 640), jnp.bfloat16), "dit.odd.weight": ((40, 640), np.float32)},
     False),
    # a ragged row (777 columns) of 40 rows: XLA update, quantized outside
    ({"dit.ragged.weight": ((40, 777), jnp.bfloat16)}, False),
    # the widest cached row, and a cached width: the Pallas kernel
    ({"dit.wide.weight": ((32, 15360), jnp.bfloat16),
      "dit.cached.weight": ((64, 3072), jnp.bfloat16)}, True)], ids=["small", "ragged", "wide"])
def test_k4_matches_pallas_quant_emission(monkeypatch, leaves, pallas):
    monkeypatch.setattr(jadamw, "_INTERPRET", True)
    quant_ran = []
    update_leaf_pallas = jadamw._update_leaf_pallas

    def spy(*args, quant=False, **kw):
        quant_ran.append(quant)
        return update_leaf_pallas(*args, quant=quant, **kw)

    monkeypatch.setattr(jadamw, "_update_leaf_pallas", spy)
    rng = np.random.default_rng(1)
    # unit-scale params, as K3's test: |p| near lr would cancel in p - lr*u
    # and make an ulp of the small result a large relative error
    params = {k: rng.standard_normal(shape).astype(dt) for k, (shape, dt) in leaves.items()}
    params["dit.b.bias"] = rng.standard_normal(640).astype(np.float32)
    grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
    quant_paths = tuple(sorted(leaves))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jm = {k: jnp.zeros_like(v) for k, v in jp.items()}
    new_p, new_m, new_v, jquant = jadamw.fused_adamw_apply(
        jp, jm, dict(jm), {k: jnp.asarray(g) for k, g in grads.items()},
        jnp.ones((), jnp.int32), optax.constant_schedule(1e-3), quant_paths=quant_paths)

    tp = {k: t(np.asarray(v)) for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in tp.items()}
    nu = {k: torch.zeros_like(v) for k, v in tp.items()}
    quant = {k: (torch.empty(tp[k].shape, dtype=torch.int8),
                 torch.empty(tp[k].shape[0], dtype=torch.float32)) for k in quant_paths}
    KA.fused_adamw_apply(tp, mu, nu, {k: t(g) for k, g in grads.items()}, 1,
                         lambda c: 1e-3, quant=quant)
    for k in params:
        for ours, ref in ((tp[k], new_p[k]), (mu[k], new_m[k]), (nu[k], new_v[k])):
            assert KA.ulp_distance(ours, t(np.asarray(ref))).max().item() <= 1.0, k
    assert set(jquant) == set(quant)
    for k, (wq, ws) in quant.items():
        _codes_close(wq, jquant[k][0])
        np.testing.assert_allclose(ws.numpy(), np.asarray(jquant[k][1]), rtol=1e-6)
        # and it is quantize_weight of the stored master, bit for bit
        from genhancer_tpu_torch.core.quant import quantize_weight
        rq, rs = quantize_weight(tp[k])
        assert torch.equal(wq, rq) and torch.equal(ws, rs[:, 0])
    assert any(quant_ran) == pallas       # the JAX side ran its Pallas K4 where it should


def _args8(rng, rows=64, cols=1024, p_dtype=jnp.bfloat16):
    p = jnp.asarray(rng.standard_normal((rows, cols)) * 0.02, p_dtype)
    g = jnp.asarray(rng.standard_normal((rows, cols)) * 1e-3, jnp.bfloat16)
    m8 = jadamw.Moment8(*jadamw.m8_encode_m(
        jnp.asarray(rng.standard_normal((rows, cols)) * 1e-3, jnp.float32)))
    v8 = jadamw.Moment8(*jadamw.m8_encode_v(
        jnp.asarray(10.0 ** rng.uniform(-10, -4, (rows, cols)), jnp.float32)))
    scalars = jnp.asarray([1.0, 1e-3, 1.1, 1.05], jnp.float32)
    return p, m8, v8, g, scalars


@pytest.mark.parametrize("quant, p_dtype, shape", [
    (False, "float32", (64, 1024)), (False, "bfloat16", (64, 1024)),
    (True, "float32", (64, 1024)), (True, "bfloat16", (64, 1024)),
    # the widest 8-bit leaf's rows (15360 columns: a cluster of blocks per row on the card)
    (False, "bfloat16", (32, 15360)), (True, "bfloat16", (32, 15360))],
    ids=["False-float32", "False-bfloat16", "True-float32", "True-bfloat16",
         "wide-False-bfloat16", "wide-True-bfloat16"])
def test_k6_matches_pallas8(monkeypatch, quant, p_dtype, shape):
    monkeypatch.setattr(jadamw, "_INTERPRET", True)
    p, m8, v8, g, sc = _args8(np.random.default_rng(2), *shape, p_dtype=getattr(jnp, p_dtype))
    out = jadamw._update_leaf_pallas8(p, m8, v8, g, sc, quant=quant, **HYPER)
    tp = t(np.asarray(p))
    tm = KA.Moment8(*(t(np.asarray(a)) for a in m8))
    tv = KA.Moment8(*(t(np.asarray(a)) for a in v8))
    wq = torch.empty(tp.shape, dtype=torch.int8) if quant else None
    ws = torch.empty(tp.shape[0], dtype=torch.float32) if quant else None
    KA.fused_adamw8_leaf(tp, tm, tv, t(np.asarray(g)), t(np.asarray(sc)), wq=wq, ws=ws, **HYPER)
    dp = np.abs(f32(tp) - np.asarray(out[0], np.float32))
    if p_dtype == "bfloat16":
        flips = KA.ulp_distance(tp, t(np.asarray(out[0]))).numpy()
        assert flips.max() <= 1 and (flips > 0).mean() < 1e-3
        dp = dp[flips == 0]
    assert dp.max() <= 1e-6
    for ours, ref in ((tm, out[1]), (tv, out[2])):
        _codes_close(ours.q, ref.q)
        np.testing.assert_allclose(ours.s.numpy(), np.asarray(ref.s), rtol=1e-6)
    if quant:
        _codes_close(wq, out[3])
        np.testing.assert_allclose(ws.numpy(), np.asarray(out[4])[:, 0], rtol=1e-6)


def test_moment8_code_matches_jax():
    """The encode/decode functions against JAX's on the same moments: codes
    within one at a rate below 1e-3, decoded values within one code step."""
    rng = np.random.default_rng(3)
    v = (10.0 ** rng.uniform(-9.5, -2, (8, 256))).astype(np.float32)
    v[0, :5] = 0.0
    m = (rng.standard_normal((8, 256)) * 10.0 ** rng.uniform(-6, 0, (8, 256))).astype(np.float32)
    m[1, :3] = 0.0
    for enc, dec, jenc, jdec, x in (
            (KA.m8_encode_v, KA.m8_decode_v, jadamw.m8_encode_v, jadamw.m8_decode_v, v),
            (KA.m8_encode_m, KA.m8_decode_m, jadamw.m8_encode_m, jadamw.m8_decode_m, m)):
        q, s = enc(t(x))
        jqq, js = jenc(jnp.asarray(x))
        _codes_close(q, jqq)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_allclose(dec(q, s).numpy(), np.asarray(jdec(jqq, js)), rtol=0.1)
        assert (dec(q, s).numpy()[x == 0] == 0).all()


def test_moment8_state_and_checkpoint_roundtrip(tmp_path):
    """``optimizer_moment_bits: 8`` keeps Moment8 on ``moment8_ok`` leaves
    only (as ``pallas_adamw_clip``'s init), and the port's optimizer-state
    file carries them through a save and a load bit for bit."""
    from genhancer_tpu.train import optim as joptim
    cfg = dict(learning_rate=1e-3, fused_optimizer="pallas", optimizer_moment_bits=8)
    opt = optim.make_optimizer(cfg)
    params = {"w": torch.randn(64, 1024, generator=torch.Generator().manual_seed(0)),
              "b": torch.zeros(64, 3), "odd": torch.zeros(40, 2048)}
    jinit = joptim.make_optimizer(cfg).init({k: jnp.zeros(v.shape) for k, v in params.items()})
    state = opt.init(params)
    for k in params:
        assert isinstance(state["mu"][k], KA.Moment8) == isinstance(jinit.mu[k], jadamw.Moment8)
    assert isinstance(state["nu"]["w"], KA.Moment8) and state["nu"]["w"].q.dtype == torch.int8
    assert (state["nu"]["w"].q == -127).all() and (state["mu"]["w"].q == 0).all()
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    state, _ = opt.apply(params, grads, state)
    ts = TrainState(modules=None, trainable=params, frozen={}, opt_state=state, step=1)
    path = str(tmp_path / "optimizer-state-1.bin")
    ckpt.save_optimizer_state(ts, path)
    fresh = TrainState(modules=None, trainable=params, frozen={}, opt_state=opt.init(params))
    ckpt.load_optimizer_state(fresh, path)
    assert fresh.step == 1 and fresh.opt_state["count"] == 1
    for name in ("mu", "nu"):
        for k in params:
            a, b = fresh.opt_state[name][k], state[name][k]
            assert type(a) is type(b)
            for x, y in zip(jax.tree_util.tree_leaves(tuple(a) if isinstance(a, tuple) else a),
                            jax.tree_util.tree_leaves(tuple(b) if isinstance(b, tuple) else b)):
                assert torch.equal(x, y), (name, k)
