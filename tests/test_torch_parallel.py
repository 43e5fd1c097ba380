"""Data parallelism and ZeRO-1 of the port (``genhancer_tpu_torch/parallel``)
against the JAX package on the CPU, and the stage-2 checkpoint cadence.

The ranks are processes of ``genhancer_tpu_torch.parallel.testing`` (torch
and the port only), joined in a gloo group through a ``file://`` store under
the test's tmp_path; each launch has its own timeout, so a hung collective
fails one test.  The JAX oracle runs in this process on the global batch,
its draws handed to the ranks, each of which keeps its rows.

Bounds: the loss within 1e-4 relative; each gradient leaf within 1e-4 of
its largest element (1e-3 for the two layers fed by the 1000·t sinusoids,
tests/test_torch_train_step.py); the parameters after the step within 1e-4
of the leaf's largest where the gradient's sign stands clear of that bound,
and within 2·lr everywhere (AdamW's first update is lr·sign(g)).  ZeRO-1
against replicated, and rank against rank, bit for bit.
"""

import dataclasses
import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genhancer_tpu.tasks import factory as jfactory
from genhancer_tpu.tasks import video as jvideo
from genhancer_tpu.train import config as jconfig
from genhancer_tpu.train import optim as joptim
from genhancer_tpu.train import state as jstate
from genhancer_tpu.train.trainer import Trainer as JaxTrainer
from genhancer_tpu.tasks import image as jimage
from genhancer_tpu_torch.core.kernels import adamw as KA
from genhancer_tpu_torch.data import testing as dtesting
from genhancer_tpu_torch.data.wds import ShardStream
from genhancer_tpu_torch.parallel import mesh
from genhancer_tpu_torch.parallel import testing as ptest
from genhancer_tpu_torch.tasks import factory
from genhancer_tpu_torch.tasks import image as timage
from genhancer_tpu_torch.train import checkpoint as ckpt
from genhancer_tpu_torch.train import optim
from genhancer_tpu_torch.train.config import TRAIN_DEFAULTS, Config, load_config
from genhancer_tpu_torch.train.trainer import STAGE2_EARLY_SAVES, Trainer, hf_export_name
from genhancer_tpu_torch.weights import hf_io

import test_torch_video as tv
from test_parallel_combos import INVALID, VALID
from test_torch_int8_step import INT8_DIT
from test_torch_parity import TINY_DIT, TINY_TOWER, TINY_VAE, f32, port_cfg, t
from test_torch_train_e2e import shards, tiny_models, write_cfg  # noqa: F401 (fixtures)
from test_torch_train_step import _jax_draws, _port_name, _specs
from test_torch_train_step import jax_init  # noqa: F401 (fixture)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
HYPER = dict(learning_rate=LR, lr_scheduler="constant", max_train_steps=10)
SINCOS = ("dit.time_in.in_layer.weight", "dit.guidance_in.in_layer.weight")
LAUNCH_TIMEOUT = 240.0


def _launch(tmp_path, name, payload, world):
    payload = {**payload, "init_file": str(tmp_path / f"{name}.store")}
    return ptest.launch(payload, world, tmp_path / name, timeout=LAUNCH_TIMEOUT)


def _grad_bound(key):
    return 1e-3 if key in SINCOS else 1e-4


def _check_grads(ours, jgrads):
    for k, g in jgrads.items():
        o, r = f32(ours[_port_name(k)]), np.asarray(g, np.float32)
        assert np.abs(o - r).max() <= _grad_bound(k) * max(np.abs(r).max(), 1e-30), k


def _grad_misses(ours, jgrads) -> float:
    """The largest gradient error over its bound, across the leaves."""
    return max(np.abs(f32(ours[_port_name(k)]) - np.asarray(g, np.float32)).max()
               / (_grad_bound(k) * max(np.abs(np.asarray(g, np.float32)).max(), 1e-30))
               for k, g in jgrads.items())


def _check_params(ours, jparams, jgrads, lr=LR):
    for k, v in jparams.items():
        o, r = f32(ours[_port_name(k)]), np.asarray(v, np.float32)
        g = np.abs(np.asarray(jgrads[k], np.float32))
        clear = g > 2 * _grad_bound(k) * max(g.max(), 1e-30)
        d = np.abs(o - r)
        assert d[clear].max(initial=0.0) <= 1e-4 * max(np.abs(r).max(), 1e-30), k
        assert d.max() <= 2 * lr * (1 + 1e-3), k


def _same_across_ranks(outs, keys=("grads", "params")):
    for o in outs[1:]:
        assert o["loss"] == outs[0]["loss"]
        for name in keys:
            for k, v in outs[0][name].items():
                assert torch.equal(o[name][k], v), (name, k)


def _jax_accum(jst, jloss, jopt, batch, key):
    """JAX's accumulation-2 step on ``batch`` (the global micro-batches),
    eagerly as ``make_accum_train_step`` composes it: (loss, summed micro
    grads, new trainable params)."""
    keys = jax.random.split(key, 2)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda tp, frozen, micro, k: jloss(tp, frozen, micro, k) * 0.5))
    jgrads, jl = None, 0.0
    for i in range(2):
        micro = {k: jnp.asarray(v[i]) for k, v in batch.items()}
        loss, g = grad_fn(jst.trainable, jst.frozen, micro, keys[i])
        jgrads = g if jgrads is None else jax.tree_util.tree_map(jnp.add, jgrads, g)
        jl += float(loss)
    new = jax.jit(jstate.apply_gradients, static_argnums=2)(jst, jgrads, jopt)
    return jl, jgrads, new.trainable


# ----------------------------------------------------------- the DP step

@pytest.mark.parametrize("world, fused", [(2, None), (4, "pallas")])
def test_dp_step_matches_jax_on_the_global_batch(jax_init, tmp_path, world, fused):
    """One float32 image stage-1 step (accumulation 2, 4 rows per
    micro-batch in all) on ``world`` ranks against JAX's step on the whole
    batch with JAX's draws: the reduced loss and gradients and the updated
    parameters, the same on every rank."""
    js, ps = _specs("float32")
    cfg = dict(HYPER, fused_optimizer=fused)
    jopt = joptim.make_optimizer(cfg)
    modules, params = jax_init
    jst = jstate.create_state(modules, jimage.trainable_predicate(js, modules), jopt)
    imgs = np.random.default_rng(5).random((2, 4, 32, 32, 3), dtype=np.float32)
    key = jax.random.key(11)
    jl, jgrads, jnew = _jax_accum(jst, jimage.make_loss_fn(js), jopt, {"image": imgs}, key)
    keys = jax.random.split(key, 2)

    mods = timage.build_modules(ps)
    from genhancer_tpu_torch.weights.convert import load_jax_params
    load_jax_params(mods, params)
    outs = _launch(tmp_path, "dp", {
        "scenario": "step", "task": "image", "spec": ps, "accum": 2, "opt_cfg": cfg,
        "state_dict": mods.state_dict(), "batch": {"image": t(imgs)},
        "draws": [_jax_draws(js, keys[i], 4) for i in range(2)]}, world)
    _same_across_ranks(outs)
    np.testing.assert_allclose(outs[0]["loss"], jl, rtol=1e-4)
    _check_grads(outs[0]["grads"], jgrads)
    _check_params(outs[0]["params"], jnew, jgrads)


def _stage2_state_dict(ps):
    """A stage2_all init with every LoRA B planted (a zero B hides a wrong
    branch)."""
    mods = timage.init_modules(ps, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in mods.named_parameters():
            if "lora_b" in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    return mods.state_dict()


def test_dp_draws_are_the_global_batch_rows(tmp_path):
    """With the trainer's seeded generator (no injected draws), a 2-rank
    float32 stage2_all step (LoRA dropout 0.1: 2 x 13 masks, the VAE noise,
    t, x0) equals the one-process step on the global batch with the same
    seed: each rank draws the global batch's values and keeps its rows."""
    _, base = _specs("float32")
    ps = dataclasses.replace(base, stage="stage2_all", lora_r=4, lora_alpha=16.0,
                             lora_dropout=0.1)
    payload = {"scenario": "step", "task": "image", "spec": ps, "accum": 2,
               "opt_cfg": dict(HYPER), "state_dict": _stage2_state_dict(ps), "seed": 9,
               "batch": {"image": torch.rand(2, 4, 32, 32, 3,
                                             generator=torch.Generator().manual_seed(4))}}
    outs = _launch(tmp_path, "draws", payload, 2)
    _same_across_ranks(outs)
    one = ptest.scenario_step(payload)          # this process: no group, world 1
    np.testing.assert_allclose(outs[0]["loss"], one["loss"], rtol=1e-5)
    # a key projection's bias has a zero gradient in exact arithmetic: its
    # roundoff is held against the tower's largest gradient (ROADMAP)
    tower = max(np.abs(f32(g)).max() for k, g in one["grads"].items() if ".vision_model." in k)
    for k, g in one["grads"].items():
        scale = max(np.abs(f32(g)).max(), tower if k.endswith("k_proj.bias") else 1e-30)
        assert np.abs(f32(outs[0]["grads"][k]) - f32(g)).max() <= 1e-4 * scale, k
    for k, p in one["params"].items():
        assert np.abs(f32(outs[0]["params"][k]) - f32(p)).max() <= 2 * LR * (1 + 1e-3), k


def _sliding_spec():
    """The tiny sliding-window spec at 32 px (the target's latent 2 x 2)."""
    return dataclasses.replace(tv.jax_spec("sliding"), img_size=32)


def test_int8_dp_step_is_the_global_batch_step(tmp_path):
    """A tiny float32 ``int8_full`` step with the int8 tower and VAE encoder
    (accumulation 2, generator draws) on 2 ranks equals the one-process
    step on the global batch up to the order of the reduction: the int8
    scales that span a batch (a VAE conv's per-tensor amax, the dW's
    per-column amax over the tokens) are the global batch's, as XLA takes
    them over the data axis."""
    from test_torch_int8_step import _specs as int8_specs
    ps = dataclasses.replace(int8_specs("int8_full")[1], dit_quant_cache=False)
    payload = {"scenario": "step", "task": "image", "spec": ps, "accum": 2, "seed": 3,
               "opt_cfg": dict(HYPER, fused_optimizer="pallas"),
               "state_dict": timage.init_modules(ps, torch.Generator().manual_seed(0))
               .state_dict(),
               "batch": {"image": torch.rand(2, 4, 32, 32, 3,
                                             generator=torch.Generator().manual_seed(5))}}
    outs = _launch(tmp_path, "int8", payload, 2)
    _same_across_ranks(outs)
    one = ptest.scenario_step(payload)
    # a float product's rounding depends on the batch's rows on the CPU, and
    # an int8 code next to a rounding boundary amplifies it: JAX's own
    # bound for int8 under data parallelism (tests/test_quant_parallel.py:
    # 134) on the loss, the int8 step's noise bound on the gradients
    # (tests/test_torch_int8_step.py)
    np.testing.assert_allclose(outs[0]["loss"], one["loss"], rtol=3e-3)
    for k, g in one["grads"].items():
        ours, ref = f32(outs[0]["grads"][k]), f32(g)
        assert np.abs(ours - ref).max() <= 5e-2 * max(np.abs(ref).max(), 1e-30), k
        assert np.linalg.norm(ours - ref) <= 5e-2 * max(np.linalg.norm(ref), 1e-30), k


def test_int8_batch_scales_are_the_global_batch_scales(tmp_path):
    """The int8 scales that span a batch, on 2 ranks: a conv input's
    per-tensor quantization and the per-column quantization of the int8 dW
    give each rank the global batch's codes for its rows, bit for bit, and
    the ranks' summed per-column dW is the global one up to the sum's
    rounding."""
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(4, 8, 6, 6, generator=gen)
    x[3, 2, 1, 1] = 9.0                     # the amax sits in rank 1's rows
    g2, x2 = torch.randn(40, 24, generator=gen), torch.randn(40, 16, generator=gen)
    g2[5] *= 20.0                           # and the columns' in rank 0's
    outs = _launch(tmp_path, "scales", {"scenario": "int8_scales", "x": x, "g2": g2,
                                        "x2": x2}, 2)
    from genhancer_tpu_torch.core import quant as tq
    xq, sx = tq.quantize_activation_tensor(x)
    gq, sg = tq._quantize_cols(g2)
    dw = tq._int8_dw_cols(g2, x2, torch.float32)
    for r, o in enumerate(outs):
        assert torch.equal(o["x"][0], xq[2 * r:2 * r + 2]) and torch.equal(o["x"][1], sx)
        assert torch.equal(o["g"][0], gq[20 * r:20 * r + 20]) and torch.equal(o["g"][1], sg)
        assert (o["dw"] - dw).abs().max() <= 1e-6 * dw.abs().max()
    # the control: one rank's rows alone quantize against their own amax
    assert not torch.equal(tq.quantize_activation_tensor(x[:2])[1], sx)


@pytest.fixture(scope="module")
def sliding_init():
    modules = jvideo.init_modules(jax.random.key(0), _sliding_spec())
    return modules, jax.device_get(modules)


# rank 0 holds rows 0-1 and rank 1 rows 2-3 of each micro-batch: 2 and 1
# valid rows in the first, 1 and 0 in the second
VALID_ROWS = np.array([[True, True, True, False], [True, False, False, False]])


def test_uneven_valid_rows_take_the_global_denominator(sliding_init, tmp_path):
    """A tiny float32 sliding-window video step (accumulation 2) on 2 ranks
    holding different numbers of valid rows against JAX's masked mean over
    the global batch; the mean of the ranks' own masked means (each rank
    its rows alone) must miss the bound."""
    js = _sliding_spec()
    ps = tv.port_spec(js)
    modules, params = sliding_init
    jopt = joptim.make_optimizer(dict(HYPER))
    jst = jstate.create_state(modules, jvideo.trainable_predicate(js, modules), jopt)
    rng = np.random.default_rng(6)
    batch = {"cond": rng.random((2, 4, 3, 32, 32, 3), dtype=np.float32),
             "target": rng.random((2, 4, 32, 32, 3), dtype=np.float32),
             "valid": VALID_ROWS}
    key = jax.random.key(13)
    jl, jgrads, _ = _jax_accum(jst, jvideo.make_loss_fn(js), jopt, batch, key)
    keys = jax.random.split(key, 2)
    draws = [tv._jax_draws(js, keys[i], 4) for i in range(2)]

    mods = tv.tvideo.build_modules(ps)
    from genhancer_tpu_torch.weights.convert import load_jax_params
    load_jax_params(mods, params)
    payload = {"scenario": "step", "task": "video", "spec": ps, "accum": 2,
               "opt_cfg": dict(HYPER), "state_dict": mods.state_dict(),
               "batch": {k: t(v) for k, v in batch.items()}, "draws": draws}
    outs = _launch(tmp_path, "valid", payload, 2)
    _same_across_ranks(outs)
    np.testing.assert_allclose(outs[0]["loss"], jl, rtol=1e-4)
    _check_grads(outs[0]["grads"], jgrads)

    # the control: each rank's rows alone, with their own denominators,
    # then the ranks' gradients averaged
    means = []
    for r in range(2):
        rows = slice(2 * r, 2 * r + 2)
        means.append(ptest.scenario_step({
            **payload, "batch": {k: t(v[:, rows]) for k, v in batch.items()},
            "draws": [{k: v[rows] for k, v in d.items()} for d in draws]})["grads"])
    control = {k: (means[0][k] + means[1][k]) / 2 for k in means[0]}
    assert _grad_misses(control, jgrads) > 10.0


# ----------------------------------------------------------- ZeRO-1

ZERO_VARIANTS = {
    "chain": dict(gradient_accumulation_steps=2),
    "k3": dict(gradient_accumulation_steps=2, fused_optimizer="pallas"),
    "k4_int8_full": dict(fused_optimizer="pallas", dit_quant="int8_full"),
    "k6_int8_dw": dict(fused_optimizer="pallas", dit_quant="int8_dw",
                       optimizer_moment_bits=8),
}


def _zero_cfg(tmp_path, shards_dir, **over):
    cfg = {**TRAIN_DEFAULTS, "task": "image_stage1", "tower": "openai_clip",
           "data_config": {"train_batch_size": 2, "num_workers": 1, "img_size": 32,
                           "img_dir": shards_dir, "seed": 0},
           # t5_dim 33: the T5 projector's leaves split over no even world
           "clip_config": {"clip_image_size": 32, "clip_dim": 24, "t5_dim": 33},
           "output_dir": str(tmp_path / "out"), "max_train_steps": 10,
           "learning_rate": 1e-3, "mixed_precision": "bf16", "report_to": "none",
           "log_interval": 1}
    cfg.update(over)
    return cfg


@pytest.fixture(scope="module")
def zero_runs(tmp_path_factory):
    """Every ZeRO-1 variant, replicated and sharded, in one 2-rank launch:
    3 bf16 steps of each (the chain and K3 on the tiny DiT, K4 and K6 on
    a DiT of hidden 512, whose large linears take the int8 cache and the
    8-bit moments)."""
    tmp = tmp_path_factory.mktemp("zero")
    for i in range(2):
        dtesting.make_image_shard(str(tmp / "shards" / f"s{i}.tar"), 4, 48, seed=i)
    runs = {}
    for big in (False, True):
        names = [n for n in ZERO_VARIANTS if ("dit_quant" in ZERO_VARIANTS[n]) == big]
        dit = dataclasses.replace(INT8_DIT if big else TINY_DIT, context_in_dim=33)
        variants = {}
        for n in names:
            variants[n] = ZERO_VARIANTS[n]
            variants[n + "+zero"] = {**ZERO_VARIANTS[n], "shard_optimizer_state": True}
        outs = _launch(tmp, f"zero{int(big)}", {
            "scenario": "steps", "device": "cpu", "steps": 3, "keep_tensors": True,
            "cfg": _zero_cfg(tmp, str(tmp / "shards")),
            "registry": {"dit": port_cfg(dit), "vae": port_cfg(TINY_VAE),
                         "tower": port_cfg(TINY_TOWER)},
            "variants": variants}, 2)
        for n in names:
            runs[n] = [(o["runs"][n], o["runs"][n + "+zero"]) for o in outs]
    return runs


@pytest.mark.parametrize("variant", sorted(ZERO_VARIANTS))
def test_zero1_equals_replicated_bit_for_bit(zero_runs, variant):
    """3 bf16 steps on 2 ranks, replicated and with ``shard_optimizer_state``
    (the chain; K3's, K4's and K6's plain versions, the int8 cache emitted):
    parameters, gathered moments and caches equal bit for bit, every rank
    equal to the other; each rank's moments hold its rows only."""
    over = ZERO_VARIANTS[variant]
    for rep, zero in zero_runs[variant]:
        assert rep["loss"] == zero["loss"] and np.isfinite(rep["loss"]).all()
        for step in range(3):
            assert rep["params"][step] == zero["params"][step]
            assert rep["caches"][step] == zero["caches"][step]
        assert rep["moments"] == zero["moments"]
        for part in ("params", "moments", "caches"):
            a, b = rep["tensors"][part], zero["tensors"][part]
            assert a.keys() == b.keys()
            for k in a:
                pair = zip(a[k], b[k]) if part == "caches" else [(a[k], b[k])]
                assert all(torch.equal(x, y) for x, y in pair), (part, k)
        # the rank's rows only, and at least one leaf left whole
        assert not rep["rows"] and zero["rows"]
        assert 0 < len(zero["rows"]) < zero["leaves"]
        whole = set(zero["tensors"]["params"]) - set(zero["rows"])
        assert any(k.startswith("clip.project_t5.") for k in whole)
        assert zero["moment_bytes"] == zero["moment_bytes_expected"]
        assert rep["moment_bytes"] == rep["moment_bytes_expected"]
        assert zero["moment_bytes"] < 0.6 * rep["moment_bytes"]
        if "dit_quant" in over:
            assert zero["caches"][0]        # the cache is there, and emitted
    r0, r1 = (zero for _, zero in zero_runs[variant])
    assert r0["rows"] != r1["rows"]
    for name in ("loss", "params", "caches", "moments"):
        assert r0[name] == r1[name], name
    if over.get("optimizer_moment_bits") == 8:
        assert any(k.endswith(".q") for k in r0["moments"])     # K6's leaves


@pytest.mark.parametrize("rows", [(0, 3), (3, 6), (2, 5)])
def test_fused_update_of_rows_equals_the_whole_leaf_rows(rows):
    """``fused_adamw_apply`` on row ranges (K3, K4 and K6's plain versions,
    the views at offsets no 16-byte boundary meets) gives the rows of the
    whole-leaf update bit for bit; the norm spans the whole gradients."""
    r0, r1 = rows
    gen = torch.Generator().manual_seed(3)
    shapes = {"a": (6, 7), "b": (6,), "q": (6, 5), "m8": (192, 512)}
    params = {k: torch.randn(s, generator=gen).to(torch.bfloat16) for k, s in shapes.items()}
    grads = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    scale = {"m8": 32}         # the Moment8 leaf: rows in units of 32
    sched = optim.make_lr_schedule("constant", 1e-3)
    whole = {k: p.clone() for k, p in params.items()}
    wq = {k: torch.zeros(shapes[k], dtype=torch.int8) for k in ("q", "m8")}
    ws = {k: torch.zeros(shapes[k][0]) for k in ("q", "m8")}

    def moments(k, p):
        if k == "m8":
            return KA.moment8_zeros_m(p), KA.moment8_zeros_v(p)
        return torch.zeros_like(p), torch.zeros_like(p)

    mw = {k: moments(k, p) for k, p in whole.items()}
    qw = {k: (wq[k].clone(), ws[k].clone()) for k in wq}
    KA.fused_adamw_apply(whole, {k: m for k, (m, _) in mw.items()},
                         {k: v for k, (_, v) in mw.items()}, grads, 1, sched, quant=qw)
    rr = {k: (r0 * scale.get(k, 1), r1 * scale.get(k, 1)) for k in shapes}
    part = {k: p.clone() for k, p in params.items()}
    mp = {k: moments(k, p[a:b]) for k, p in part.items() for a, b in [rr[k]]}
    qp = {k: (wq[k].clone(), ws[k].clone()) for k in wq}
    before = dict(KA.LAUNCHES)
    KA.fused_adamw_apply(part, {k: m for k, (m, _) in mp.items()},
                         {k: v for k, (_, v) in mp.items()}, grads, 1, sched, quant=qp,
                         rows=rr)
    assert KA.LAUNCHES == before                # CPU tensors: the plain versions
    for k, (a, b) in rr.items():
        assert torch.equal(part[k][a:b], whole[k][a:b]), k
        assert torch.equal(part[k][:a], params[k][:a]) and torch.equal(part[k][b:], params[k][b:])
        mine, ref = mp[k], mw[k]
        for x, y in zip(mine, ref):
            for u, w in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
                assert torch.equal(u, w[a:b]), k
        if k in qp:
            assert torch.equal(qp[k][0][a:b], qw[k][0][a:b]) and torch.equal(
                qp[k][1][a:b], qw[k][1][a:b]), k


# ----------------------------------------------------------- checkpoints

def _ckpt_cfg(tmp_path, shards_dir, out, **over):
    dit = dataclasses.replace(TINY_DIT, context_in_dim=33)
    over.setdefault("output_dir", str(tmp_path / out))
    cfg = _zero_cfg(tmp_path, shards_dir, fused_optimizer="pallas",
                    shard_optimizer_state=True, mixed_precision="no", checkpointing_steps=2,
                    resume_from_checkpoint="latest", **over)
    return cfg, {"dit": port_cfg(dit), "vae": port_cfg(TINY_VAE), "tower": port_cfg(TINY_TOWER)}


def _global_batches(n, start=0):
    return [ptest.global_images(s, 4, 32, 1, seed=1) for s in range(start, start + n)]


def _in_process(cfg, reg, batches, monkeypatch):
    from genhancer_tpu_torch import registry
    monkeypatch.setattr(registry, "build_dit_config", lambda name: reg["dit"])
    monkeypatch.setattr(registry, "build_vae_config", lambda name, ae_path=None: reg["vae"])
    monkeypatch.setattr(registry, "tower_family_and_config",
                        lambda tower, size, clip_type=None: ("clip", reg["tower"]))
    trainer = Trainer(Config._wrap(cfg), device="cpu")
    trainer.loader.close()
    trainer.loader = ptest.RowsLoader(batches)
    return trainer


def test_zero1_checkpoint_is_world_size_free_and_resumes(tmp_path, shards,  # noqa: F811
                                                        monkeypatch):
    """A 2-rank ZeRO-1 run saves at steps 2 and 4.  Its step-2 optimizer
    state has the layout of a one-process run's, key by key; a 2-rank
    resume from step 2 reaches the uninterrupted step-4 state bit for bit;
    a one-process resume loads the gathered moments bit for bit and
    continues on the same global batches to the same state."""
    cfg, reg = _ckpt_cfg(tmp_path, shards, "w2", max_train_steps=4)
    full = _launch(tmp_path, "w2", {"scenario": "train", "device": "cpu", "cfg": cfg,
                                    "registry": reg, "batches": _global_batches(4)}, 2)
    assert [o["saved_steps"] for o in full] == [[2, 4], [2, 4]]
    assert full[0]["rows"] != full[1]["rows"]
    out = cfg["output_dir"]
    sd2 = hf_io.load_state_dict(os.path.join(out, "optimizer-state-2.bin"))
    for o in full:
        for k, v in o["moments"].items():
            assert torch.equal(v, full[0]["moments"][k]), k

    cfg1, _ = _ckpt_cfg(tmp_path, shards, "w1", max_train_steps=2)
    one = _in_process(cfg1, reg, _global_batches(2), monkeypatch)
    one.train()
    sd1 = hf_io.load_state_dict(os.path.join(cfg1["output_dir"], "optimizer-state-2.bin"))
    assert sd1.keys() == sd2.keys()
    for k in sd1:
        assert (sd1[k].shape, sd1[k].dtype) == (sd2[k].shape, sd2[k].dtype), k

    def step2_copy(name):
        d = tmp_path / name
        shutil.copytree(out, d)
        for f in os.listdir(d):
            if f.endswith("-4.bin"):
                os.remove(d / f)
        return str(d)

    cfg_r, _ = _ckpt_cfg(tmp_path, shards, "unused", max_train_steps=4,
                         output_dir=step2_copy("resume2"))
    res = _launch(tmp_path, "resume2", {"scenario": "train", "device": "cpu", "cfg": cfg_r,
                                        "registry": reg, "batches": _global_batches(2, 2)}, 2)
    for r in range(2):
        assert res[r]["step"] == 4 and res[r]["saved_steps"] == [4]
        for name in ("params", "moments"):
            for k, v in full[r][name].items():
                assert torch.equal(res[r][name][k], v), (name, k)

    cfg_1, _ = _ckpt_cfg(tmp_path, shards, "unused", max_train_steps=4,
                         output_dir=step2_copy("resume1"))
    one = _in_process(cfg_1, reg, _global_batches(2, 2), monkeypatch)
    assert one.state.step == 2 and one.state.opt_state["count"] == 2
    got = ckpt.optimizer_state_dict(one.state)
    for k, v in sd2.items():
        assert torch.equal(got[k], v), k
    one.train()
    assert [h["step"] for h in one.history] == [3, 4]
    np.testing.assert_allclose([h["loss"] for h in one.history],
                               [h["loss"] for h in full[0]["history"][2:]], rtol=1e-4)
    for k, v in full[0]["params"].items():
        assert np.abs(f32(one.state.trainable[k]) - f32(v)).max() <= 4 * LR * (1 + 1e-3), k


# ----------------------------------------------------------- stopping

def _stopper(preempted, log_interval=10):
    t_ = types.SimpleNamespace(_preempted=preempted, log_interval=log_interval, device="cpu")
    return lambda step: Trainer._preempt_stop(t_, step)


class TestPreemptStop:
    """tests/test_preempt_sync.py's three cases, on the port's trainer."""

    def test_single_process_uses_local_flag_any_step(self):
        assert _stopper(True)(7) is True
        assert _stopper(False)(7) is False

    def test_multirank_local_flag_never_breaks_directly(self, monkeypatch):
        monkeypatch.setattr(mesh, "world_size", lambda: 2)
        calls = []

        def fake_broadcast(flag, device):
            calls.append(int(flag))
            return False             # rank 0 has not flagged

        monkeypatch.setattr(mesh, "broadcast_flag", fake_broadcast)
        stop = _stopper(True)        # THIS rank saw SIGTERM early
        assert stop(7) is False and not calls
        assert stop(20) is False and calls == [1]

    def test_multirank_breaks_uniformly_on_broadcast_flag(self, monkeypatch):
        monkeypatch.setattr(mesh, "world_size", lambda: 2)
        monkeypatch.setattr(mesh, "broadcast_flag", lambda flag, device: True)
        stop = _stopper(False)       # this rank never saw the signal itself
        assert stop(30) is True
        assert stop(31) is False


def test_rank0_sigterm_stops_both_ranks_at_one_boundary(tmp_path, shards):  # noqa: F811
    """Rank 0 raises its SIGTERM flag after step 1; with ``log_interval:
    2`` both ranks stop at the step-2 boundary and write one checkpoint."""
    cfg = _zero_cfg(tmp_path, shards, max_train_steps=6, log_interval=2,
                    checkpointing_steps=0)
    reg = _ckpt_cfg(tmp_path, shards, "unused")[1]
    outs = _launch(tmp_path, "stop", {"scenario": "train", "device": "cpu", "cfg": cfg,
                                      "registry": reg, "sigterm_after": 1}, 2)
    assert [(o["step"], o["saved_steps"]) for o in outs] == [(2, [2]), (2, [2])]
    assert ckpt.all_steps(cfg["output_dir"]) == [2]


# ----------------------------------------------------------- validation

def _cfg(**over):
    c = dict(TRAIN_DEFAULTS)
    c.update({"task": "image_stage1", "tower": "openai_clip", "model_name": "flux-debug",
              "data_config": {"train_batch_size": 4, "img_size": 224,
                              "img_dir": "/nonexistent-never-touched"},
              "clip_config": {"clip_image_size": 224, "clip_dim": 768, "t5_dim": 4096}})
    c.update(over)
    return Config(c)


@pytest.mark.parametrize("task", ["image_stage1", "video_middle_stage1"])
@pytest.mark.parametrize("knobs,msg", INVALID,
                         ids=lambda k: "+".join(sorted(map(str, k))) if isinstance(k, dict)
                         else "")
def test_invalid_combos_raise_jax_messages(task, knobs, msg):
    with pytest.raises(ValueError, match=msg):
        factory.build_spec(_cfg(task=task, **knobs))


@pytest.mark.parametrize("knobs", VALID, ids=lambda k: "+".join(sorted(map(str, k))) or "dp")
def test_valid_combos_build_or_name_part_2(knobs):
    """Every composition JAX takes builds: data parallelism, TP, FSDP,
    sequence and pipeline parallelism and their compositions, the spec
    carrying the seq and pipe sizes (JAX factory.py:191-195)."""
    spec, _, kind = factory.build_spec(_cfg(**knobs))
    assert kind == "image"
    assert (spec.sequence_parallel, spec.pipeline_parallel, spec.pipeline_microbatches) == (
        knobs.get("sequence_parallel", 1), knobs.get("pipeline_parallel", 1), 0)


@pytest.mark.parametrize("axis", ["sequence_parallel", "pipeline_parallel"])
@pytest.mark.parametrize("task, size", [("video_sliding_stage2_all", 224),
                                        ("video_middle_stage2_all", 336),
                                        ("video_sliding_stage1", 336)])
def test_remat_gates_take_jax_s_decision_on_a_mesh(axis, task, size):
    """On a 4-rank world with ``axis`` 2 (two data indices), the port's
    DiT and tower remat gates over the rank's ``train_batch_size`` rows
    decide as JAX's over its host's batch of both data indices' rows
    (``factory.py:233-258``: n_data = n_dev // (tp * sp * pp), seq / sp),
    at batches on both sides of the thresholds."""
    decisions = set()
    for bs in (1, 2, 4, 8, 16, 32):
        knobs = {axis: 2, "task": task, "model_name": "flux-debug",
                 "data_config": {"train_batch_size": bs, "img_size": size,
                                 "video_dir": "/nonexistent-never-touched"},
                 "clip_config": {"clip_image_size": size, "clip_dim": 768, "t5_dim": 4096}}
        ours = factory.build_spec(_cfg(**knobs))[0]
        jcfg = jconfig.Config({**_cfg(**knobs), "num_devices": 4, "data_config": {
            **knobs["data_config"], "train_batch_size": 2 * bs}})
        ref = jfactory.build_spec(jcfg)[0]
        assert (ours.remat, ours.tower_remat) == (ref.remat, ref.tower_remat), (bs, ours, ref)
        decisions.add((ours.remat, ours.tower_remat))
    assert len(decisions) > 1          # the batches straddle a threshold


@pytest.mark.parametrize("knobs", [dict(shard_optimizer_state=True), dict(num_devices=1),
                                   dict(shard_optimizer_state=True, num_devices=1)])
def test_dp_and_zero1_build(knobs):
    assert factory.build_spec(_cfg(**knobs))[2] == "image"
    assert optim.make_optimizer(_cfg(**knobs)).init(
        {"w": torch.zeros(4, 2)}).get("rows", {}) == ({"w": (0, 4)} if knobs.get(
            "shard_optimizer_state") else {})


def test_num_devices_must_equal_the_world_size():
    with pytest.raises(ValueError, match="num_devices: 2 but this run has 1 rank"):
        factory.build_spec(_cfg(num_devices=2))


def test_a_rank_without_a_shard_raises(tmp_path):
    shard = dtesting.make_image_shard(str(tmp_path / "s0.tar"), 2, 32)
    assert ShardStream(shard, node_index=0, node_count=2).shards == [shard]
    with pytest.raises(ValueError, match="rank 1 of 2 gets no shard"):
        ShardStream(shard, node_index=1, node_count=2)


@pytest.mark.parametrize("env, want", [
    ({"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1", "MASTER_ADDR": "127.0.0.1",
      "MASTER_PORT": "29500"}, ("gloo", "env://", 2, 1)),
    ({"GENHANCER_COORDINATOR": "10.0.0.1:1234", "GENHANCER_NUM_PROCS": "4",
      "GENHANCER_PROC_ID": "3"}, ("gloo", "tcp://10.0.0.1:1234", 4, 3)),
    ({}, None)], ids=["torchrun", "manual", "one-process"])
def test_launch_contracts(monkeypatch, env, want):
    """torchrun's environment and JAX's manual contract name the group
    (gloo on the CPU); without either the run is one process."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
              "GENHANCER_COORDINATOR", "GENHANCER_NUM_PROCS", "GENHANCER_PROC_ID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, init_method, world_size, rank:
                        calls.append((backend, init_method, world_size, rank)))
    mesh.maybe_initialize_distributed(torch.device("cpu"))
    assert calls == ([want] if want else [])
    assert mesh.rank_device(torch.device("cuda")).index == int(env.get("LOCAL_RANK", 0))


def test_one_process_helpers_are_the_identity():
    x = torch.arange(12.0).reshape(6, 2)
    assert mesh.world_size() == 1 and mesh.rank() == 0 and not mesh.is_distributed()
    assert mesh.row_range((6, 2)) == (0, 6) and mesh.row_range(()) is None
    assert mesh.local_rows(x) is x
    assert mesh.host_local_batch_slice(6) == slice(0, 6)
    mesh.all_reduce_sum([x])
    assert torch.equal(x, torch.arange(12.0).reshape(6, 2))
    (g,) = mesh.all_gather_rows([x])
    assert torch.equal(g, x) and g.data_ptr() != x.data_ptr()
    assert mesh.broadcast_flag(True, "cpu") is True
    assert mesh.rank_device(torch.device("cuda")) == torch.device("cuda", 0)


# ----------------------------------------------------------- early saves

@pytest.mark.parametrize("config, every", [
    ("configs/MetaCLIP_large_stage1.yaml", None),
    ("configs/MetaCLIP_large_stage2_all.yaml", 1000),
    ("configs/OpenAICLIP_224_sliding_stage2_all.yaml", None)])
def test_checkpoint_cadence_matches_jax(config, every):
    """The port's ``_should_checkpoint`` against the JAX trainer's over steps
    1..3000: every ``checkpointing_steps``, and in stage 2 the early saves."""
    path = os.path.join(ROOT, config)
    ours_cfg, jax_cfg = load_config(path), jconfig.load_config(path)
    if every is not None:
        ours_cfg["checkpointing_steps"] = jax_cfg["checkpointing_steps"] = every
    stage = factory.build_spec(ours_cfg)[0].stage
    ours = types.SimpleNamespace(cfg=ours_cfg, spec=types.SimpleNamespace(stage=stage))
    ref = types.SimpleNamespace(cfg=jax_cfg, spec=types.SimpleNamespace(stage=stage))
    got = [s for s in range(1, 3001) if Trainer._should_checkpoint(ours, s)]
    want = [s for s in range(1, 3001) if JaxTrainer._should_checkpoint(ref, s)]
    assert got == want
    if stage.startswith("stage2"):
        assert STAGE2_EARLY_SAVES <= set(got)


def test_stage2_run_writes_the_step_50_checkpoint_and_export(tiny_models, tmp_path,  # noqa: F811
                                                             shards):
    cfg = write_cfg(tmp_path, shards, task="image_stage2_all", max_train_steps=51,
                    checkpointing_steps=0, gradient_accumulation_steps=1,
                    lora_config={"r": 4, "lora_alpha": 16, "lora_dropout": 0.1},
                    resume_from_checkpoint=None)
    trainer = Trainer(cfg, device="cpu")
    trainer.train()
    assert trainer.saved_steps == [50, 51]
    out = cfg["output_dir"]
    for name in ("checkpoint-dit", "checkpoint-project-clip", "checkpoint-project-t5",
                 "optimizer-state"):
        assert os.path.exists(os.path.join(out, f"{name}-50.bin")), name
    assert os.path.exists(os.path.join(out, hf_export_name(cfg, 50), "pytorch_model.bin"))
