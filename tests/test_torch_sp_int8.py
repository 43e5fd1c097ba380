"""The int8 DiT where the token rows are split over ranks: K8 and the
per-column int8 dW under data parallelism, and the SwitchBack step under
sequence parallelism, against one process on the global batch and against
the JAX package.

JAX's GSPMD hands K8's Pallas call the all-gathered operands and sums the
per-column int8 product's int32 partials over every axis that splits the
tokens before its dequantization; the port gathers K8's rows in the global
order (``core.quant.global_rows``: the seq ranks' chunks of each sample,
their pad rows dropped, then the data ranks' samples) and sums the int32
products over those axes (``_int8_dw_cols``), and every rank holds the
global dW, which ``train.state.reduce_gradients`` leaves out of the data
and seq sums (``state.whole``).

Bounds: each SwitchBack call's y, dx and dW within 1e-5 of their largest
element against one process on the global inputs (exact codes and int32
sums; float32 dequantization in another order), K8's operands and the
per-column codes and scales bit for bit.  The composed SP step: every
SwitchBack call at 1e-5 against the JAX layer function on the global
inputs, the loss within 3e-3 and the gradients within 5e-2 of JAX's int8
step on the unsharded batch (ROADMAP's int8 bounds: a whole int8 network
is chaotic between two implementations).  Each control must miss its
bound by more than 10x.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genhancer_tpu.core import quant as jq
from genhancer_tpu.core.pallas import adamw as jadamw
from genhancer_tpu.core.pallas import int8_dw as jdw
from genhancer_tpu.tasks import image as jimage
from genhancer_tpu.train import optim as joptim
from genhancer_tpu.train import state as jstate
from genhancer_tpu_torch.core import nn as tnn_
from genhancer_tpu_torch.core import quant as tq
from genhancer_tpu_torch.core.kernels import int8_dw as K8
from genhancer_tpu_torch.parallel import ring as tring
from genhancer_tpu_torch.parallel import testing as ptest
from genhancer_tpu_torch.tasks import factory
from genhancer_tpu_torch.tasks import image as timage
from genhancer_tpu_torch.weights.convert import load_jax_params

from test_torch_int8_step import _cfg, _specs as int8_specs
from test_torch_parallel import _launch
from test_torch_parity import f32, t
from test_torch_train_step import _jax_draws, _port_name

torch.set_num_threads(1)

H, M = 512, 1024
REL = 1e-5
# token linears [out, in] and one "vector" linear (a [B, C] input whole on
# every seq rank: the modulation)
LINEARS = {"dit.double_blocks.0.img_attn.qkv": (3 * H, H),
           "dit.single_blocks.0.linear2": (H, H + M)}
VECTOR = {"dit.double_blocks.0.img_mod.lin": (2 * H, H)}
DW_KINDS = {"int8_full": "cols", "int8_dw": "int8_dw", "int8": "bf16"}


def _inputs(shapes, rows, seed):
    """Weights and whole inputs: x, g [B, L, C] (``rows`` = (B, L)) for the
    token linears, [B, C] for the vector ones."""
    gen = torch.Generator().manual_seed(seed)
    weights, xs, gs = {}, {}, {}
    for path, (o, i) in shapes.items():
        lead = rows if path not in VECTOR else rows[:1]
        weights[path] = (torch.randn(o, i, generator=gen) / i ** 0.5,
                         torch.randn(o, generator=gen) * 0.1)
        xs[path] = torch.randn(*lead, i, generator=gen)
        gs[path] = torch.randn(*lead, o, generator=gen)
        xs[path][0, ..., 3] *= 30.0           # a column amax in data rank 0's rows
    return weights, xs, gs


def _one_process(weights, xs, gs, dw):
    """Each linear once on the whole inputs: y, dx, dW, db."""
    out = {}
    for path, (w, b) in weights.items():
        lin = tnn_.Linear(w.shape[1], w.shape[0])
        with torch.no_grad():
            lin.weight.copy_(w)
            lin.bias.copy_(b)
        x = xs[path].clone().requires_grad_(True)
        with tnn_.int8_training_ctx(full=dw == "cols", dw_int8=dw == "int8_dw"):
            y = tnn_.linear(lin, x)
        y.backward(gs[path])
        out[path] = {"y": y.detach(), "dx": x.grad, "dw": lin.weight.grad, "db": lin.bias.grad}
    return out


def _miss(got, ref) -> float:
    return float((got - ref).abs().max() / (REL * ref.abs().max()))


def _payload(weights, xs, gs, dw, **kw):
    return {"scenario": "linears", "tp": 1, "hidden": H, "weights": weights, "x": xs,
            "g": gs, "dw": dw, **kw}


# ----------------------------------------------------------- data parallel

DP_QUANTS = ("int8_full", "int8_dw")


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """2 data ranks holding 640 token rows each (not a multiple of K8's
    512-row blocks): every dW kind in one launch, then the controls."""
    tmp = tmp_path_factory.mktemp("dp")
    weights, xs, gs = _inputs(LINEARS, (4, 320), 3)
    kinds = [DW_KINDS[q] for q in DP_QUANTS]
    outs = _launch(tmp, "dp", _payload(weights, xs, gs, kinds), 2)
    bad = {"per_rank_blocks": _launch(tmp, "blocks", _payload(
               weights, xs, gs, "int8_dw", control="per_rank_blocks"), 2)[0],
           "sum_whole_again": _launch(tmp, "again", _payload(
               weights, xs, gs, ["cols", "int8_dw"], control="sum_whole_again"), 2)[0]}
    return weights, xs, gs, outs, bad


@pytest.mark.parametrize("quant", DP_QUANTS)
def test_dp_switchback_dw_is_the_global_batch_dw(dp_runs, quant):
    """Each SwitchBack call on 2 data ranks equals one process on the
    global batch: K8's operands are the global rows in order and the
    per-column codes and scales are one process's, bit for bit; y, dx, dW
    and db at 1e-5, and every rank holds the global dW before any sum.
    Controls: K8 on each rank's own rows summed over data (the port before
    this repair), and the global dW summed over data again."""
    weights, xs, gs, outs, bad = dp_runs
    dw = DW_KINDS[quant]
    one = _one_process(weights, xs, gs, dw)
    for r, o in enumerate(outs):
        for path in weights:
            got = o[dw][path]
            for k, ref in one[path].items():
                assert _miss(got[k], ref) <= 1.0, (r, path, k, _miss(got[k], ref))
            g2 = gs[path].reshape(-1, gs[path].shape[-1])
            x2 = xs[path].reshape(-1, xs[path].shape[-1])
            if dw == "int8_dw":
                assert torch.equal(got["k8"][0], g2) and torch.equal(got["k8"][1], x2)
            else:
                (gq, sg), (xq, sx) = got["cols"]
                wq_g, ws_g = tq._quantize_cols(g2)
                wq_x, ws_x = tq._quantize_cols(x2)
                rows = slice(r * 640, (r + 1) * 640)
                assert torch.equal(gq, wq_g[rows]) and torch.equal(sg, ws_g)
                assert torch.equal(xq, wq_x[rows]) and torch.equal(sx, ws_x)
            assert _miss(got["dw_local"], one[path]["dw"]) <= 1.0, path
    controls = [bad["sum_whole_again"][dw]] + ([bad["per_rank_blocks"]] if dw == "int8_dw" else [])
    for b in controls:
        worst = max(_miss(b[p]["dw"], one[p]["dw"]) for p in weights)
        assert worst > 10.0, worst


# ----------------------------------------------------------- seq parallel

SP_QUANTS = ("int8_full", "int8_dw", "int8")


@pytest.fixture(scope="module")
def sp_runs(tmp_path_factory):
    """2 seq ranks at L = 197 (chunks of 99 and 98 tokens, one pad row):
    every dW kind in one launch; the pad rows left in K8's rows and the
    per-column amax of each rank's tokens (each fault touches one kind
    only) in another; the global dW summed over seq again in a third."""
    tmp = tmp_path_factory.mktemp("sp")
    weights, xs, gs = _inputs({**LINEARS, **VECTOR}, (4, 197), 5)
    outs = _launch(tmp, "sp", _payload(weights, xs, gs, [DW_KINDS[q] for q in SP_QUANTS],
                                       sp=2), 2)
    faults = _launch(tmp, "faults", _payload(weights, xs, gs, ["int8_dw", "cols"], sp=2,
                                             control=["keep_pad", "per_rank_amax"]), 2)[0]
    again = _launch(tmp, "again", _payload(weights, xs, gs, "int8_dw", sp=2,
                                           control="sum_whole_again"), 2)[0]
    bad = {"int8_dw": [faults["int8_dw"], again], "cols": [faults["cols"]], "bf16": []}
    return weights, xs, gs, outs, bad


@pytest.mark.parametrize("quant", SP_QUANTS)
def test_sp_switchback_calls_are_one_process(sp_runs, quant):
    """Token linears and a vector linear (its input whole on each seq rank,
    its gradient the rank's share) on 2 seq ranks equal one process on the
    whole inputs, after the step's sums: y, dx, dW and db at 1e-5; K8's
    operands are the whole rows in order, bit for bit.  Controls: the pad
    rows left in K8's rows (788 rows: the 512-row blocks shift), the
    per-column amax of each rank's tokens, the global dW summed over seq
    again."""
    weights, xs, gs, outs, bad = sp_runs
    dw = DW_KINDS[quant]
    one = _one_process(weights, xs, gs, dw)
    for r, o in enumerate(outs):
        for path in weights:
            got = o[dw][path]
            assert got["split"] == ("vector" if path in VECTOR else "tokens")
            for k, ref in one[path].items():
                assert _miss(got[k], ref) <= 1.0, (r, path, k, _miss(got[k], ref))
            if dw == "int8_dw" and path not in VECTOR:
                assert torch.equal(got["k8"][0], gs[path].reshape(-1, gs[path].shape[-1]))
                assert torch.equal(got["k8"][1], xs[path].reshape(-1, xs[path].shape[-1]))
    for b in bad[dw]:
        worst = max(_miss(b[p]["dw"], one[p]["dw"]) for p in LINEARS)
        assert worst > 10.0, worst


def test_sp_static_int8_base_is_one_process(tmp_path):
    """The frozen static int8 DiT of ``stage2_only`` (``quantize_lora_base``:
    no dW, an int8 dx) on 2 seq ranks: a vector call's dx is quantized from
    its gradient summed over seq, as one process quantizes it; y, dx and
    db at 1e-5.  The control quantizes each rank's share and misses."""
    from genhancer_tpu_torch.core import quant as tq_
    weights, xs, gs = _inputs({**LINEARS, **VECTOR}, (4, 197), 9)
    one = {}
    for path, (w, b) in weights.items():
        lin = tnn_.Linear(w.shape[1], w.shape[0])
        with torch.no_grad():
            lin.weight.copy_(w)
            lin.bias.copy_(b)
        tq_.quantize_lora_base(lin, min_features=1)
        x = xs[path].clone().requires_grad_(True)
        y = tnn_.linear(lin, x)
        y.backward(gs[path])
        one[path] = {"y": y.detach(), "dx": x.grad, "db": lin.bias.grad}
    outs = _launch(tmp_path, "static", _payload(weights, xs, gs, "bf16", sp=2, static=True), 2)
    for r, o in enumerate(outs):
        for path in weights:
            assert o[path]["dw"] is None
            for k, ref in one[path].items():
                assert _miss(o[path][k], ref) <= 1.0, (r, path, k, _miss(o[path][k], ref))
    bad = _launch(tmp_path, "static-share", _payload(weights, xs, gs, "bf16", sp=2, static=True,
                                                    control="share_quantized"), 2)[0]
    path = next(iter(VECTOR))
    assert _miss(bad[path]["dx"], one[path]["dx"]) > 10.0


def test_sp_with_dit_quant_builds():
    """SP with ``dit_quant`` builds, as in JAX (``validate_parallelism``
    does not reject it)."""
    from test_torch_parallel import _cfg as base_cfg
    for quant in ("int8", "int8_dw", "int8_full"):
        spec, _, _ = factory.build_spec(base_cfg(sequence_parallel=2, dit_quant=quant))
        assert spec.sequence_parallel == 2 and spec.dit_quant == quant


# ----------------------------------------------------------- the SP step

SWITCHBACK = {"int8_full": ("cols", jq.switchback_linear_full_cached),
              "int8_dw": ("int8_dw", jq.switchback_linear_cached_dw)}


def _whole_calls(outs):
    """The SwitchBack calls of 2 seq ranks joined into one process's: token
    calls' x, g, y and dx concatenated along the tokens in seq order (a
    chunk may hold no tokens of a stream), a vector call's gradient shares
    summed; dW is rank 0's, which every rank must hold."""
    a, b = outs[0]["calls"], outs[1]["calls"]
    assert [c["path"] for c in a] == [c["path"] for c in b] and a
    joined = []
    for c0, c1 in zip(a, b):
        assert c0["split"] == c1["split"] and torch.equal(c0["dW"], c1["dW"]), c0["path"]
        c = dict(c0)
        if c0["split"] == "tokens":
            for k in ("x", "g", "y", "dx"):
                c[k] = torch.cat([c0[k], c1[k]], dim=1)
        else:
            c["g"], c["dx"] = c0["g"] + c1["g"], c0["dx"] + c1["dx"]
        joined.append(c)
    return joined


def _hold_calls(calls, dit_quant):
    """Each joined call against the JAX function of its layer on the same
    whole inputs, at 1e-5 of its largest element."""
    kind, jfn = SWITCHBACK[dit_quant]
    for c in calls:
        assert c["dw_kind"] == kind, c["path"]
        x, w, g = (jnp.asarray(c[k].numpy()) for k in ("x", "w", "g"))
        jwq, jws = jnp.asarray(c["wq"].numpy()), jnp.asarray(c["ws"].numpy())
        y, vjp = jax.vjp(lambda a, b_: jfn(a, b_, jwq, jws), x, w)
        jdx, jdw_ = vjp(g)
        for name, ours, ref in (("y", c["y"], y), ("dx", c["dx"], jdx), ("dW", c["dW"], jdw_)):
            ref = np.asarray(ref, np.float32)
            err = np.abs(f32(ours) - ref).max() / max(np.abs(ref).max(), 1e-30)
            assert err <= REL, (c["path"], c["split"], name, err)
    return {c["split"] for c in calls}


@pytest.fixture(scope="module")
def jax_int8():
    inits = {q: jimage.init_modules(jax.random.key(0), int8_specs(q)[0])
             for q in SWITCHBACK}
    return inits


@pytest.mark.parametrize("dit_quant,bits", [("int8_full", 16), ("int8_dw", 8)])
def test_sp_int8_step_matches_jax(jax_int8, tmp_path, monkeypatch, dit_quant, bits):
    """The int8 image stage-1 step (K4's cache; ``int8_dw`` with 8-bit
    moments) on 2 seq ranks at the joint L = 1 + 16: chunks of 9 and 8
    tokens, rank 1 holding no text token and calling the text stream's
    SwitchBack linears with zero rows.  Every SwitchBack call, joined over
    the ranks, is JAX's layer function on the unsharded inputs at 1e-5;
    the loss is JAX's unsharded int8 step's within 3e-3 and the gradients
    within 5e-2 of each leaf's largest."""
    for mod in (jadamw, jdw):
        monkeypatch.setattr(mod, "_INTERPRET", True)
    monkeypatch.setenv("GENHANCER_PALLAS_INTERPRET", "1")
    js, ps = int8_specs(dit_quant)
    modules = jax_int8[dit_quant]
    jopt = joptim.make_optimizer(_cfg(bits), emit_quant=True)
    jst = jstate.with_quant_cache(jstate.create_state(
        modules, jimage.trainable_predicate(js, modules), jopt))
    imgs = np.random.default_rng(3).random((4, 32, 32, 3), dtype=np.float32)
    key = jax.random.key(11)
    jloss = jimage.make_loss_fn(js)
    loss, jgrads = jax.value_and_grad(
        lambda tp: jloss(tp, jst.frozen, {"image": jnp.asarray(imgs)}, key, jst.quant)
    )(jst.trainable)
    mods = timage.build_modules(ps)
    load_jax_params(mods, jax.device_get({k: modules[k] for k in ("dit", "vae", "clip")}))
    payload = {"scenario": "step", "task": "image", "record": True, "emit_quant": True,
               "spec": dataclasses.replace(ps, sequence_parallel=2),
               "opt_cfg": _cfg(bits), "state_dict": mods.state_dict(),
               "batch": {"image": t(imgs)}, "draws": [_jax_draws(js, key, 4)]}
    outs = _launch(tmp_path, dit_quant, payload, 2)
    calls = _whole_calls(outs)
    assert _hold_calls(calls, dit_quant) == {"tokens", "vector"}
    # rank 1's chunk holds no text token: its text-stream calls ran on zero rows
    assert any(c["x"].shape[1] == 0 for c in outs[1]["calls"] if c["split"] == "tokens")
    assert abs(outs[0]["loss"] - float(loss)) <= 3e-3 * abs(float(loss))
    assert outs[1]["loss"] == outs[0]["loss"]
    for k, g in jgrads.items():
        ours, ref = f32(outs[0]["grads"][_port_name(k)]), np.asarray(g, np.float32)
        assert np.abs(ours - ref).max() <= 5e-2 * max(np.abs(ref).max(), 1e-30), k


def test_sp_int8_video_step_is_one_process(tmp_path):
    """A sliding-window video stage-1 step with ``int8_full`` (the tiny
    DiT at hidden 512, a padded window) on 2 seq ranks: each SwitchBack
    call, joined over the ranks, is JAX's layer function on the joined
    inputs at 1e-5, and the loss is the port's one-process step's within
    3e-3."""
    import test_torch_video as tv
    from genhancer_tpu_torch.tasks import video as tvideo
    js = dataclasses.replace(tv.jax_spec("sliding"), img_size=32)
    ps = dataclasses.replace(tv.port_spec(js), dit_cfg=int8_specs("int8_full")[1].dit_cfg,
                             dit_quant="int8_full", dit_quant_cache=True)
    mods = tvideo.init_modules(ps, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(6)
    batch = {"cond": t(rng.random((2, 3, 32, 32, 3), dtype=np.float32)),
             "target": t(rng.random((2, 32, 32, 3), dtype=np.float32)),
             "valid": t(np.array([True, False]))}
    payload = {"scenario": "step", "task": "video", "record": True, "emit_quant": True,
               "spec": dataclasses.replace(ps, sequence_parallel=2), "seed": 4,
               "opt_cfg": _cfg(16), "state_dict": mods.state_dict(), "batch": batch}
    outs = _launch(tmp_path, "video", payload, 2)
    assert _hold_calls(_whole_calls(outs), "int8_full") == {"tokens", "vector"}
    one = ptest.scenario_step({**payload, "spec": ps, "record": False})
    assert abs(outs[0]["loss"] - one["loss"]) <= 3e-3 * abs(one["loss"])


