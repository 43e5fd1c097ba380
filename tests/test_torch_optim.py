"""The port's optimizers against the JAX package (genhancer_tpu/train/optim.py,
genhancer_tpu/core/pallas/adamw.py in interpret mode), on the CPU.

* K3's tree-level ``fused_adamw_apply`` (plain version on CPU tensors) over
  mixed bf16/f32 leaves with f32 grads, 3 steps: p, m, v within one ulp
  of the storage dtype per element (the same float32 formula; XLA may
  contract a multiply-add into an FMA);
* the default chain against ``optax.chain(clip_by_global_norm, adamw)`` for
  3 steps, with accumulated f32 grads (moments become f32) and with bf16
  grads (they stay bf16): f32 moments within 1e-5 relative plus 1e-6 of
  the leaf's largest moment (the clip factor g/||g|| carries the norm's
  float32 summation order, and b1*m + (1-b1)*g cancels near zero), bf16
  moments within one ulp, params within one ulp of their dtype;
* the four schedules against optax (float32 arithmetic, rtol 1e-6);
* the knobs: ``fused_optimizer: xla``/``true`` builds ``SinglePassAdamW``
  (its parity: tests/test_torch_xla_optim.py); the int8 ones
  (``emit_quant``, ``optimizer_moment_bits: 8``) build K4/K6's optimizer
  (their parity: tests/test_torch_adamw_int8.py).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from genhancer_tpu.core.pallas import adamw as jadamw
from genhancer_tpu.train import optim as joptim
from genhancer_tpu_torch.core.kernels import adamw as KA
from genhancer_tpu_torch.train import optim

from test_torch_parity import f32, t

torch.set_num_threads(1)

HYPER = dict(learning_rate=1e-3, adam_beta1=0.9, adam_beta2=0.999, adam_epsilon=1e-8,
             adam_weight_decay=0.01, max_grad_norm=1.0, lr_scheduler="constant",
             lr_warmup_steps=0, max_train_steps=100)


def _leaves(rng, spec):
    return {k: rng.standard_normal(shape, dtype=np.float32).astype(
        jnp.bfloat16 if dt == "bf16" else np.float32) for k, (shape, dt) in spec.items()}


def _ulps(got, want) -> float:
    return KA.ulp_distance(got, want).max().item()


@pytest.fixture(autouse=True)
def no_launches():
    KA.LAUNCHES["fused_adamw"] = 0
    yield
    assert KA.LAUNCHES["fused_adamw"] == 0


def test_fused_adamw_apply_matches_pallas_three_steps():
    rng = np.random.default_rng(0)
    spec = {"a.weight": ((512, 128), "bf16"),     # takes the Pallas kernel in JAX
            "a.bias": ((512,), "bf16"), "b.weight": ((24, 40), "f32"),
            "b.odd": ((7, 3), "bf16")}
    params = _leaves(rng, spec)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jm = {k: jnp.zeros_like(v) for k, v in jp.items()}
    jv = {k: jnp.zeros_like(v) for k, v in jp.items()}
    tp = {k: t(np.asarray(v)) for k, v in jp.items()}
    tm = {k: torch.zeros_like(v) for k, v in tp.items()}
    tv = {k: torch.zeros_like(v) for k, v in tp.items()}
    sched = optax.constant_schedule(1e-3)
    for count, scale in ((1, 0.01), (2, 1.0), (3, 0.3)):
        grads = {k: rng.standard_normal(v.shape, dtype=np.float32) * scale
                 for k, v in params.items()}
        jp, jm, jv, _ = jadamw.fused_adamw_apply(
            jp, jm, jv, {k: jnp.asarray(g) for k, g in grads.items()},
            jnp.asarray(count, jnp.int32), sched)
        gnorm = KA.fused_adamw_apply(tp, tm, tv, {k: t(g) for k, g in grads.items()},
                                     count, lambda c: 1e-3)
        np.testing.assert_allclose(gnorm.item(), float(optax.global_norm(grads)), rtol=1e-6)
        for k in params:
            for ours, ref in ((tp[k], jp[k]), (tm[k], jm[k]), (tv[k], jv[k])):
                assert ours.dtype == t(np.asarray(ref)).dtype
                assert _ulps(ours, t(np.asarray(ref))) <= 1.0, (count, k)


@pytest.mark.parametrize("grads_dtype", ["float32", "bfloat16"])
def test_chain_matches_optax_three_steps(grads_dtype):
    """accumulated f32 grads promote bf16 moments to f32 after step 1;
    bf16 grads keep them bf16 (an f32 projector-like leaf keeps f32)."""
    rng = np.random.default_rng(1)
    spec = {"clip.project_t5.1.weight": ((16, 12), "f32"),
            "dit.img_in.weight": ((32, 16), "bf16"), "dit.img_in.bias": ((32,), "bf16")}
    params = _leaves(rng, spec)
    jopt = joptim.make_optimizer(dict(HYPER))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    opt = optim.make_optimizer(dict(HYPER))
    assert isinstance(opt, optim.AdamWChain)
    tp = {k: t(np.asarray(v)) for k, v in jp.items()}
    state = opt.init(tp)
    for scale in (0.01, 1.0, 0.3):        # unclipped, then clipped by the global norm
        grads = {}
        for k, v in params.items():
            g = rng.standard_normal(v.shape, dtype=np.float32) * scale
            if grads_dtype == "bfloat16" and v.dtype != np.float32:
                g = g.astype(jnp.bfloat16)
            grads[k] = jnp.asarray(g)
        upd, jstate = jopt.update(grads, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        state, gnorm = opt.apply(tp, {k: t(np.asarray(g)) for k, g in grads.items()}, state)
        np.testing.assert_allclose(gnorm.item(), float(optax.global_norm(grads)), rtol=1e-2
                                   if grads_dtype == "bfloat16" else 1e-6)
        adam = jstate[1][0]
        for k in params:
            for ours, ref in ((state["mu"][k], adam.mu[k]), (state["nu"][k], adam.nu[k])):
                ref = t(np.asarray(ref))
                assert ours.dtype == ref.dtype, (k, ours.dtype, ref.dtype)
                if ref.dtype == torch.float32:
                    np.testing.assert_allclose(f32(ours), f32(ref), rtol=1e-5,
                                               atol=1e-6 * np.abs(f32(ref)).max())
                else:
                    assert _ulps(ours, ref) <= 1.0, k
            assert _ulps(tp[k], t(np.asarray(jp[k]))) <= 1.0, k
    mu_dt = state["mu"]["dit.img_in.weight"].dtype
    assert mu_dt == (torch.float32 if grads_dtype == "float32" else torch.bfloat16)


@pytest.mark.parametrize("name", ["constant", "constant_with_warmup", "linear", "cosine"])
def test_schedules_match_optax(name):
    ours = optim.make_lr_schedule(name, 1e-4, 10, 100)
    ref = joptim.make_lr_schedule(name, 1e-4, 10, 100)
    for count in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(ours(count), float(ref(jnp.asarray(count, jnp.int32))),
                                   rtol=1e-6, atol=1e-12, err_msg=f"{name} @ {count}")


def test_knob_handling():
    assert isinstance(optim.make_optimizer(dict(HYPER, fused_optimizer="pallas")),
                      optim.FusedAdamW)
    assert isinstance(optim.make_optimizer(dict(HYPER, fused_optimizer="chain")),
                      optim.AdamWChain)
    for fused in ("xla", True):
        assert isinstance(optim.make_optimizer(dict(HYPER, fused_optimizer=fused)),
                          optim.SinglePassAdamW)
    opt8 = optim.make_optimizer(dict(HYPER, fused_optimizer="pallas", optimizer_moment_bits=8),
                                emit_quant=True)
    assert isinstance(opt8, optim.FusedAdamW) and opt8.moment_bits == 8 and opt8.emit_quant
    with pytest.raises(ValueError, match="requires fused_optimizer: pallas"):
        optim.make_optimizer(dict(HYPER, optimizer_moment_bits=8))
    with pytest.raises(ValueError, match="8 or 16"):
        optim.make_optimizer(dict(HYPER, optimizer_moment_bits=4))
    assert optim.effective_steps_per_epoch(16, 2) == joptim.effective_steps_per_epoch(16, 2)


def test_k3_moments_stay_in_the_param_dtype():
    opt = optim.make_optimizer(dict(HYPER, fused_optimizer="pallas"))
    p = {"w": torch.ones(4, 8, dtype=torch.bfloat16), "b": torch.ones(8)}
    state = opt.init(p)
    state, _ = opt.apply(p, {k: torch.full(v.shape, 0.5) for k, v in p.items()}, state)
    assert state["count"] == 1
    assert state["mu"]["w"].dtype == torch.bfloat16 and state["nu"]["b"].dtype == torch.float32
