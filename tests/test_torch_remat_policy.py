"""Remat in the image task and the DiT's remat policies (``full``,
``save_attn``, ``dots``) of the port against the JAX package, on the CPU.

* The image stage-1 loss with ``remat`` under each policy against JAX
  ``tasks.image.make_loss_fn`` with the same spec and draws: the float32
  loss within 1e-5 relative, every gradient leaf within 1e-4 of its
  largest element (1e-3 for the two layers fed by the 1000·t sinusoids),
  the bounds of ``tests/test_torch_train_step.py``; and the port's
  gradients under remat equal to its gradients without, bit for bit (the
  recompute runs the same float32 operations: JAX's own
  ``tests/test_dit.py::TestDiT::test_remat_policy_grads_match_full``).
* What each policy keeps, against ``jax.ad_checkpoint.
  print_saved_residuals`` of the JAX DiT (attention through its Pallas
  kernel in interpret mode): the residuals a policy keeps beyond ``full``,
  as (element count, dtype), equal the outputs the port's selective
  policy keeps; the control — a block that tags its attention output under
  another name — must keep a different set.
* Whether the attention forward runs again in the backward: the Pallas
  forward calls in JAX's gradient jaxpr against the port's attention calls
  in a forward and backward, under each policy and without remat.
* ``dit_quant`` under each selective policy: every SwitchBack call of the
  forward against ``jax.vjp`` of the JAX layer function on the same
  inputs (y, dx, dW within 1e-5 of max|JAX|: exact codes and int32 sums,
  float32 dequantization in another order), each recomputed call's input
  and output equal to its forward call's bit for bit, the parameters'
  gradients equal to the run without remat bit for bit, and ``dots``
  keeping SwitchBack's int32 products as JAX keeps them.
* The pipelined DiT (``parallel.pp``, 2 gloo ranks) under each selective
  policy: output and gradients within 2e-5 of the port's plain forward
  (``tests/test_torch_pp.py``'s bound).
"""

import contextlib
import dataclasses
import io
import re
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.ad_checkpoint import print_saved_residuals
from torch.utils.checkpoint import CheckpointPolicy

from genhancer_tpu.core import attention as jattention
from genhancer_tpu.core import nn as jnn
from genhancer_tpu.core import quant as jq
from genhancer_tpu.core.rope import spatial_ids
from genhancer_tpu.models import dit as jdit
from genhancer_tpu.tasks import image as jimage
from genhancer_tpu.train import optim as joptim
from genhancer_tpu_torch.core import nn as tnn_port
from genhancer_tpu_torch.core import quant as tq
from genhancer_tpu_torch.models import dit as tdit
from genhancer_tpu_torch.tasks import image as timage
from genhancer_tpu_torch.train import optim
from genhancer_tpu_torch.weights.convert import dit_state_dict

from test_torch_int8_step import _spy_switchback
from test_torch_parallel import _launch
from test_torch_parity import f32, port_cfg, t
from test_torch_train_step import (HYPER, _jax_draws, _jax_state, _port_name, _port_state,
                                   _specs, jax_init)  # noqa: F401 (fixture)

torch.set_num_threads(1)

POLICIES = ("full", "save_attn", "dots")
SINCOS = ("dit.time_in.in_layer.weight", "dit.guidance_in.in_layer.weight")
# a DiT of one block of each kind (tests/test_dit.py's TINY, cut)
CFG = jdit.DiTConfig(in_channels=16, vec_in_dim=24, context_in_dim=32, hidden_size=64,
                     mlp_ratio=4.0, num_heads=4, depth=1, depth_single_blocks=1,
                     axes_dim=(4, 6, 6))
LAYER_REL = 1e-5


@pytest.fixture(scope="module")
def dit_setup():
    """JAX's tiny DiT, the port's DiT holding its weights, and the inputs of
    ``tests/test_dit.py``'s ``make_inputs``."""
    params = jdit.init_dit(jax.random.key(4), CFG)
    b, l_img, l_txt = 2, 8, 3
    rng = np.random.default_rng(0)
    inp = dict(img=rng.standard_normal((b, l_img, CFG.in_channels)).astype(np.float32),
               img_ids=np.broadcast_to(np.asarray(spatial_ids(2, 4))[None], (b, l_img, 3))
               .astype(np.float32),
               txt=rng.standard_normal((b, l_txt, CFG.context_in_dim)).astype(np.float32),
               txt_ids=np.zeros((b, l_txt, 3), np.float32),
               timesteps=rng.random(b).astype(np.float32),
               y=rng.standard_normal((b, CFG.vec_in_dim)).astype(np.float32),
               guidance=np.full((b,), 4.0, np.float32))
    return params, inp


def _port_dit(params):
    dit = tdit.DiT(port_cfg(CFG), dtype=torch.float32)
    dit.load_state_dict({k: t(np.asarray(v)) for k, v in dit_state_dict(params).items()})
    return dit


@contextlib.contextmanager
def _jax_pallas(monkeypatch):
    """The JAX DiT's attention through its Pallas kernel, interpreted."""
    monkeypatch.setattr(jattention, "_USE_PALLAS", "1")
    monkeypatch.setenv("GENHANCER_PALLAS_INTERPRET", "1")
    yield


# ------------------------------------------------------------ image task

@pytest.mark.parametrize("policy", POLICIES)
def test_image_remat_matches_jax(jax_init, policy):  # noqa: F811
    js, ps = _specs("float32")
    js = dataclasses.replace(js, remat=True, remat_policy=policy)
    ps = dataclasses.replace(ps, remat=True, remat_policy=policy)
    jst = _jax_state(jax_init, "float32", joptim.make_optimizer(dict(HYPER)))
    key = jax.random.key(7)
    imgs = np.random.default_rng(3).random((2, 32, 32, 3), dtype=np.float32)
    jloss = jimage.make_loss_fn(js)
    ref, jgrads = jax.value_and_grad(
        lambda tp: jloss(tp, jst.frozen, {"image": jnp.asarray(imgs)}, key))(jst.trainable)
    grads = {}
    for remat in (True, False):
        state = _port_state(jax_init, "float32", optim.make_optimizer(dict(HYPER)))
        loss = timage.make_loss_fn(dataclasses.replace(ps, remat=remat))(
            state.modules, {"image": t(imgs)}, None, _jax_draws(js, key, 2))
        loss.backward()
        grads[remat] = {k: p.grad.clone() for k, p in state.trainable.items()}
        if remat:
            assert loss.item() == pytest.approx(float(ref), rel=1e-5)
    for k, g in jgrads.items():
        ours, want = grads[True][_port_name(k)], np.asarray(g, np.float32)
        assert torch.equal(ours, grads[False][_port_name(k)]), k
        bound = 1e-3 if _port_name(k) in SINCOS else 1e-4
        assert np.abs(f32(ours) - want).max() <= bound * max(np.abs(want).max(), 1e-30), k


def test_unknown_remat_policy_is_refused():
    with pytest.raises(ValueError, match="remat_policy"):
        tdit.block_fns(True, "save_everything")
    assert tdit.block_fns(False, "save_everything") == (tdit._double_block,
                                                        tdit._single_block)


# ------------------------------------------------------------ what is kept

def _jax_kept(params, inp, policy, int8=None) -> Counter:
    """(element count, dtype) of the residuals JAX's DiT keeps under
    ``policy`` beyond those it keeps under ``full``.  JAX caches a
    checkpointed block's trace without the SwitchBack context it ran in, so
    the caches are cleared first."""
    jax.clear_caches()

    def residuals(pol):
        def loss(p):
            ctx = (jnn.int8_training_ctx(min_dim=64, full=int8 == "int8_full") if int8
                   else contextlib.nullcontext())
            with ctx:
                return jnp.mean(jdit.dit_forward(p, CFG, **{k: jnp.asarray(v)
                                                            for k, v in inp.items()},
                                                 remat=True, remat_policy=pol) ** 2)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            print_saved_residuals(loss, params)
        out = Counter()
        for line in buf.getvalue().splitlines():
            m = re.match(r"(\w+)\[([\d,]*)\]", line)
            if m and "from the argument" not in line:
                shape = [int(d) for d in m.group(2).split(",") if d]
                out[(int(np.prod(shape)), m.group(1))] += 1
        return out
    return residuals(policy) - residuals("full")


_DTYPES = {torch.float32: "f32", torch.int32: "i32", torch.bfloat16: "bf16"}


def _port_kept(monkeypatch, dit, inp, policy, int8=None) -> Counter:
    """(element count, dtype) of the outputs the port's selective policy
    keeps in one forward, read by wrapping its decision function."""
    kept = Counter()
    orig = tdit.create_selective_checkpoint_contexts

    def wrapped(decide, *a, **kw):
        def rec(ctx, op, *args, **kwargs):
            d = decide(ctx, op, *args, **kwargs)
            if d == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
                if op == torch.ops.genhancer.checkpoint_name.default:
                    shape, dt = args[0].shape, args[0].dtype
                else:   # mm / addmm / _int_mm: [M, K] x [K, N]
                    a_, b_ = args[-2], args[-1]
                    shape = (a_.shape[0], b_.shape[1])
                    dt = torch.int32 if op == torch.ops.aten._int_mm.default else a_.dtype
                kept[(int(np.prod(shape)), _DTYPES[dt])] += 1
            return d
        return orig(rec, *a, **kw)

    monkeypatch.setattr(tdit, "create_selective_checkpoint_contexts", wrapped)
    ctx = tnn_port.int8_training_ctx(full=int8 == "int8_full") if int8 else \
        contextlib.nullcontext()
    with ctx:
        out = tdit.dit_forward(dit, port_cfg(CFG), **{k: t(v) for k, v in inp.items()},
                               remat=True, remat_policy=policy)
    out.square().mean().backward()
    return kept


@pytest.mark.parametrize("policy", ["save_attn", "dots"])
def test_kept_set_matches_jax(dit_setup, monkeypatch, policy):
    params, inp = dit_setup
    with _jax_pallas(monkeypatch):
        want = _jax_kept(params, inp, policy)
    # save_attn: each block's attention output; dots: the 13 linear products
    assert sum(want.values()) == (2 if policy == "save_attn" else 13), want
    assert _port_kept(monkeypatch, _port_dit(params), inp, policy) == want


def test_kept_set_control_misses(dit_setup, monkeypatch):
    """A block whose attention output is tagged under another name than the
    policy keeps: nothing is kept, against JAX's two attention outputs."""
    params, inp = dit_setup
    with _jax_pallas(monkeypatch):
        want = _jax_kept(params, inp, "save_attn")
    orig = tdit._tagging
    monkeypatch.setattr(tdit, "_tagging", lambda fn, names: orig(fn, ("attn",)))
    got = _port_kept(monkeypatch, _port_dit(params), inp, "save_attn")
    assert got != want and sum(got.values()) == 0


def _pallas_calls(jaxpr, acc):
    for e in jaxpr.eqns:
        if e.primitive.name == "pallas_call":
            acc["fwd" if len(e.outvars) == 1 else "bwd"] += 1
        for v in e.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    _pallas_calls(inner, acc)
    return acc


@pytest.mark.parametrize("policy", [None, *POLICIES])
def test_attention_forward_reruns_in_the_backward_as_in_jax(dit_setup, monkeypatch, policy):
    """JAX keeps no residual of its Pallas forward (o, the row lse) under
    any policy, so the backward runs the forward again; the port's K1 runs
    again as well: 2 calls per block with remat, 1 without."""
    params, inp = dit_setup
    with _jax_pallas(monkeypatch):
        jb = {k: jnp.asarray(v) for k, v in inp.items()}
        jaxpr = jax.make_jaxpr(jax.grad(lambda p: jnp.mean(jdit.dit_forward(
            p, CFG, **jb, remat=policy is not None, remat_policy=policy) ** 2)))(params)
    want = _pallas_calls(jaxpr.jaxpr, Counter())
    calls = []
    orig = tdit.attention
    monkeypatch.setattr(tdit, "attention", lambda *a: calls.append(1) or orig(*a))
    out = tdit.dit_forward(_port_dit(params), port_cfg(CFG),
                           **{k: t(v) for k, v in inp.items()},
                           remat=policy is not None, remat_policy=policy)
    out.square().mean().backward()
    blocks = CFG.depth + CFG.depth_single_blocks
    assert want == Counter(fwd=len(calls), bwd=blocks)
    assert len(calls) == blocks * (1 if policy is None else 2)


# ------------------------------------------------------------ dit_quant

JAX_LAYER = {"int8": jq.switchback_linear, "int8_full": jq.switchback_linear_full}


def _rel(ours, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(f32(ours) - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("dit_quant", ["int8", "int8_full"])
@pytest.mark.parametrize("policy", ["save_attn", "dots"])
def test_dit_quant_policy_per_switchback_call(dit_setup, monkeypatch, dit_quant, policy):
    params, inp = dit_setup
    monkeypatch.setattr(tq, "SWITCHBACK_MIN_DIM", 64)    # JAX's min_dim=64 below
    grads = {}
    for remat in (False, True):
        dit = _port_dit(params)
        names = {p.data_ptr(): k for k, p in dit.named_parameters()}
        calls = _spy_switchback(monkeypatch, names)
        with tnn_port.int8_training_ctx(full=dit_quant == "int8_full"):
            out = tdit.dit_forward(dit, port_cfg(CFG), **{k: t(v) for k, v in inp.items()},
                                   remat=remat, remat_policy=policy)
        n_fwd = len(calls)
        out.square().mean().backward()
        grads[remat] = {k: p.grad.clone() for k, p in dit.named_parameters()}
        fwd, again = calls[:n_fwd], calls[n_fwd:]
        monkeypatch.undo()
        monkeypatch.setattr(tq, "SWITCHBACK_MIN_DIM", 64)
    # the forward's calls: every linear with min(out, in) >= 64, held to JAX
    assert {c["path"] for c in fwd} == {k for k, p in dit.named_parameters()
                                        if p.dim() == 2 and min(p.shape) >= 64}
    for c in fwd:
        x, w, g = (jnp.asarray(c[k].numpy()) for k in ("x", "w", "g"))
        y, vjp = jax.vjp(JAX_LAYER[dit_quant], x, w)
        jdx, jdw = vjp(g)
        for name, ref in (("y", y), ("dx", jdx), ("dW", jdw)):
            if name in c:       # no dx where the input takes no gradient
                assert _rel(c[name], ref) <= LAYER_REL, (c["path"], name, _rel(c[name], ref))
    # the recompute reran every call of the blocks on the same input, to the
    # same output
    # (the backward recomputes the single block first)
    in_blocks = {c["path"]: c for c in fwd
                 if c["path"].startswith(("double_blocks", "single_blocks"))}
    assert sorted(a["path"] for a in again) == sorted(in_blocks)
    for a in again:
        c = in_blocks[a["path"]]
        assert torch.equal(a["x"], c["x"]) and torch.equal(a["y"], c["y"]), c["path"]
    for k, g in grads[True].items():
        assert torch.equal(g, grads[False][k]), k
    if policy == "dots":        # SwitchBack's int32 products kept as JAX keeps them
        with _jax_pallas(monkeypatch):
            want = _jax_kept(params, inp, policy, int8=dit_quant)
        got = _port_kept(monkeypatch, _port_dit(params), inp, policy, int8=dit_quant)
        assert got == want and sum(v for (n, d), v in want.items() if d == "i32") == len(in_blocks)


# ------------------------------------------------------------ pipeline

@pytest.mark.parametrize("policy", ["save_attn", "dots"])
def test_pipeline_policies_match_plain_forward(tmp_path, policy):
    from test_torch_pp import CFG as PP_CFG, _port_plain, _payload
    params = jdit.init_dit(jax.random.key(0), PP_CFG)
    rng = np.random.default_rng(0)
    b, l_img = 4, 16
    batch = dict(
        img=rng.standard_normal((b, l_img, PP_CFG.in_channels)).astype(np.float32),
        img_ids=np.broadcast_to(np.asarray(spatial_ids(4, 4))[None], (b, l_img, 3))
        .astype(np.float32),
        txt=rng.standard_normal((b, 3, PP_CFG.context_in_dim)).astype(np.float32),
        txt_ids=np.zeros((b, 3, 3), np.float32),
        timesteps=np.full((b,), 0.5, np.float32),
        y=rng.standard_normal((b, PP_CFG.vec_in_dim)).astype(np.float32),
        guidance=np.full((b,), 4.0, np.float32))
    outs = _launch(tmp_path, policy, {**_payload(params, batch, 2, True),
                                      "remat_policy": policy}, 2)
    plain, pgrads = _port_plain(params, batch)
    assert np.abs(f32(outs[0]["out"]) - plain).max() <= 2e-5
    for o in outs:
        for k, g in pgrads.items():
            assert np.abs(f32(o["grads"][k]) - g).max() <= 2e-5, k
