"""``fused_optimizer: xla`` of the port (``train.optim.SinglePassAdamW``)
against the JAX package's ``fused_adamw_clip`` (genhancer_tpu/train/
optim.py:62-110), on the CPU.

* Three steps over bf16 and float32 leaves with float32 gradients, a
  warmup-then-linear schedule, the second and third steps clipped: the
  parameters and both moments equal JAX's run op by op, bit for bit — the
  lr read before the count's increment, the bias corrections after it, the
  order m/bc1/(sqrt(v/bc2)+eps), the clip min(1, c/(||g||+1e-6)), the
  moments stored in the leaf's dtype, the update rounded to the leaf's
  dtype before ``optax.apply_updates`` adds it.  The gradients are
  multiples of 1/16 up to 1 in size (scaled by powers of two), whose
  squares sum exactly in float32 in any order, so the global norm — held
  on its own at 1e-6 on random gradients — is the same number on both
  sides.
* Against JAX's jitted update, which XLA fuses (its multiply-adds may
  become FMAs): bf16 leaves within one ulp; float32 leaves within 1e-6 of
  the leaf's largest element (b1*m + (1-b1)*g cancels near zero, where an
  FMA moves an element by many ulps).
* The control that rounds once (p + update in float32, as K3 does) must
  miss the bf16 leaves.
* The knob: ``fused_optimizer: xla`` or ``true`` builds it; ZeRO-1 rows
  take the whole-leaf update's values; FSDP with it is taken, as JAX's
  factory takes it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from genhancer_tpu.tasks import factory as jfactory
from genhancer_tpu.train import config as jconfig
from genhancer_tpu.train import optim as joptim
from genhancer_tpu_torch.core.kernels import adamw as KA
from genhancer_tpu_torch.tasks import factory
from genhancer_tpu_torch.train import optim
from genhancer_tpu_torch.train.config import load_config

from test_torch_parity import t

torch.set_num_threads(1)

HYPER = dict(learning_rate=1e-3, adam_beta1=0.9, adam_beta2=0.999, adam_epsilon=1e-8,
             adam_weight_decay=0.01, max_grad_norm=1.0, lr_scheduler="linear",
             lr_warmup_steps=2, max_train_steps=10, fused_optimizer="xla")
SPEC = {"dit.a.weight": ((64, 32), jnp.bfloat16), "dit.a.bias": ((64,), jnp.bfloat16),
        "clip.project_t5.0.weight": ((32, 24), np.float32),
        "dit.odd": ((7, 5), jnp.bfloat16)}


def _params(rng):
    return {k: rng.standard_normal(s, dtype=np.float32).astype(d)
            for k, (s, d) in SPEC.items()}


def _exact_grads(rng, params, scale):
    """Multiples of 1/16 in [-1, 1] times a power of two: every partial sum
    of their squares is a float32 number."""
    return {k: rng.integers(-16, 17, v.shape).astype(np.float32) / 16 * np.float32(scale)
            for k, v in params.items()}


def _run(jit, once=False):
    """Three steps of JAX's ``fused_adamw_clip`` and of the port's on the
    same leaves (``once``: the single-rounding control in place of the
    port's); (JAX (params, mu, nu), port (params, mu, nu))."""
    rng = np.random.default_rng(0)
    params = _params(rng)
    jopt = joptim.make_optimizer(dict(HYPER))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    update = jax.jit(jopt.update) if jit else jopt.update
    opt = optim.make_optimizer(dict(HYPER))
    assert isinstance(opt, optim.SinglePassAdamW)
    tp = {k: t(np.asarray(v)) for k, v in jp.items()}
    state = opt.init(tp)
    for scale in (2 ** -7, 0.5, 0.25):      # unclipped, then clipped
        grads = _exact_grads(rng, params, scale)
        u, jstate = update({k: jnp.asarray(g) for k, g in grads.items()}, jstate, jp)
        jp = optax.apply_updates(jp, u)
        tg = {k: torch.from_numpy(g) for k, g in grads.items()}
        state = _single_rounding(opt, tp, tg, state) if once else opt.apply(tp, tg, state)[0]
    return (jp, jstate.mu, jstate.nu), (tp, state["mu"], state["nu"])


@torch.no_grad()
def _single_rounding(opt, params, grads, state):
    """``SinglePassAdamW.apply`` with the float32 update added to the
    parameter before one rounding (K3's rounding point)."""
    f32 = torch.float32
    g_norm = KA.global_norm(grads)
    scale = torch.clamp(opt.max_grad_norm / (g_norm + 1e-6), max=1.0)
    c = state["count"] + 1
    lr = float(np.float32(opt.schedule(state["count"])))
    bc1 = torch.tensor(1 - np.float32(opt.b1) ** np.float32(c))
    bc2 = torch.tensor(1 - np.float32(opt.b2) ** np.float32(c))
    for k, p in params.items():
        g = grads[k].to(f32) * scale
        m = opt.b1 * state["mu"][k].to(f32) + (1 - opt.b1) * g
        v = opt.b2 * state["nu"][k].to(f32) + (1 - opt.b2) * g * g
        upd = -lr * (m / bc1 / (torch.sqrt(v / bc2) + opt.eps) + opt.weight_decay * p.to(f32))
        state["mu"][k], state["nu"][k] = m.to(p.dtype), v.to(p.dtype)
        p.copy_((p.to(f32) + upd).to(p.dtype))
    return {**state, "count": c}


def _equal(ours, ref) -> bool:
    return torch.equal(ours, t(np.asarray(ref)))


def test_three_steps_match_jax_bit_for_bit():
    (jp, jm, jv), (tp, tm, tv) = _run(jit=False)
    for k in SPEC:
        for ours, ref in ((tp[k], jp[k]), (tm[k], jm[k]), (tv[k], jv[k])):
            assert ours.dtype == t(np.asarray(ref)).dtype, k
            assert _equal(ours, ref), k


def test_three_steps_within_one_ulp_of_jitted_jax():
    (jp, jm, jv), (tp, tm, tv) = _run(jit=True)
    for k in SPEC:
        for ours, ref in ((tp[k], jp[k]), (tm[k], jm[k]), (tv[k], jv[k])):
            ref = t(np.asarray(ref))
            if ref.dtype == torch.float32:
                d = (ours - ref).abs().max().item() / ref.abs().max().item()
                assert d <= 1e-6, (k, d)
            else:
                assert KA.ulp_distance(ours, ref).max().item() <= 1.0, k


def test_single_rounding_control_misses():
    (jp, _, _), (tp, _, _) = _run(jit=False, once=True)
    differ = {k: int((tp[k] != t(np.asarray(jp[k]))).sum()) for k in SPEC}
    assert differ["dit.a.weight"] > 0, differ


def test_global_norm_and_scale_on_random_grads():
    rng = np.random.default_rng(1)
    params = _params(rng)
    grads = {k: rng.standard_normal(v.shape, dtype=np.float32) for k, v in params.items()}
    opt = optim.make_optimizer(dict(HYPER))
    tp = {k: t(np.asarray(v)) for k, v in params.items()}
    _, gnorm = opt.apply(tp, {k: torch.from_numpy(g) for k, g in grads.items()}, opt.init(tp))
    np.testing.assert_allclose(gnorm.item(), float(optax.global_norm(grads)), rtol=1e-6)


def test_knob_and_zero1_rows():
    assert isinstance(optim.make_optimizer(dict(HYPER, fused_optimizer=True)),
                      optim.SinglePassAdamW)
    # the rows a ZeRO-1 rank updates take the whole-leaf update's values
    rng = np.random.default_rng(2)
    params = _params(rng)
    grads = {k: torch.from_numpy(g) for k, g in _exact_grads(rng, params, 0.5).items()}
    whole = {k: t(np.asarray(v)) for k, v in params.items()}
    rows = {k: t(np.asarray(v)) for k, v in params.items()}
    opt = optim.make_optimizer(dict(HYPER))
    opt.apply(whole, grads, opt.init(whole))
    state = opt.init(rows)
    state["rows"] = {"dit.a.weight": (16, 48)}
    state["mu"]["dit.a.weight"] = state["mu"]["dit.a.weight"][16:48].clone()
    state["nu"]["dit.a.weight"] = state["nu"]["dit.a.weight"][16:48].clone()
    before = rows["dit.a.weight"].clone()
    opt.apply(rows, grads, state)
    assert torch.equal(rows["dit.a.weight"][16:48], whole["dit.a.weight"][16:48])
    assert torch.equal(rows["dit.a.weight"][:16], before[:16])


def test_fsdp_takes_it_as_jax_does():
    over = {"fused_optimizer": "xla", "fsdp": True, "num_devices": None}
    ours = factory.build_spec(load_config("configs/MetaCLIP_large_stage1.yaml")
                              .merged_with(over))[0]
    ref = jfactory.build_spec(jconfig.load_config("configs/MetaCLIP_large_stage1.yaml")
                              .merged_with(over))[0]
    assert ours.dit_quant_cache == ref.dit_quant_cache is False
