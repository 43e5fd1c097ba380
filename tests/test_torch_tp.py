"""Tensor parallelism of the port (``genhancer_tpu_torch/parallel/tp.py``)
against the JAX package on the CPU.

The ranks are processes of ``genhancer_tpu_torch.parallel.testing`` (torch
and the port only) in a gloo group through a ``file://`` store under the
test's tmp_path, each launch with its own timeout.  The oracle is the JAX
single-device step on the global batch with JAX's draws, handed to the
ranks; the ranks' gradients and parameters are gathered to the reference
layout first.  Bounds are the data-parallel tests'
(``tests/test_torch_parallel.py``): the loss within 1e-4 relative, each
gradient leaf within 1e-4 of its largest element (1e-3 for the two layers
fed by the 1000·t sinusoids), the parameters by the sign rule; the int8 step per SwitchBack call at 1e-5 and
the int8 cache bit for bit.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from genhancer_tpu.models import dit as jdit
from genhancer_tpu.models import vae as jvae
from genhancer_tpu.parallel import fsdp as jfsdp
from genhancer_tpu.parallel import tp as jtp
from genhancer_tpu.models.towers import clip as jclip
from genhancer_tpu.tasks import image as jimage
from genhancer_tpu.tasks import video as jvideo
from genhancer_tpu.train import optim as joptim
from genhancer_tpu.train import state as jstate
from genhancer_tpu_torch.core import quant as tq
from genhancer_tpu_torch.parallel import fsdp as tfsdp
from genhancer_tpu_torch.parallel import tp as ttp
from genhancer_tpu_torch.tasks import image as timage
from genhancer_tpu_torch.weights.convert import _dit_name, flatten_tree, load_jax_params

import test_torch_video as tv
from test_torch_parallel import (HYPER, LR, _check_grads, _check_params, _grad_bound,
                                 _jax_accum, _launch, _same_across_ranks, _stage2_state_dict)
from test_torch_parity import f32, t
from test_torch_train_step import _jax_draws, _port_name, _specs
from test_torch_train_step import jax_init  # noqa: F401 (fixture)

torch.set_num_threads(1)


def _tp_step(jax_init, tmp_path, name, world, tp, cfg, fsdp=False):   # noqa: F811
    """One float32 image stage-1 step (accumulation 2, 4 rows per
    micro-batch) on ``world`` ranks, ``tp`` of them on the model axis,
    against JAX's step on the whole batch: (ranks' outputs, JAX's loss,
    grads, new params)."""
    js, ps = _specs("float32")
    jopt = joptim.make_optimizer(cfg)
    modules, params = jax_init
    jst = jstate.create_state(modules, jimage.trainable_predicate(js, modules), jopt)
    imgs = np.random.default_rng(5).random((2, 4, 32, 32, 3), dtype=np.float32)
    key = jax.random.key(11)
    jl, jgrads, jnew = _jax_accum(jst, jimage.make_loss_fn(js), jopt, {"image": imgs}, key)
    keys = jax.random.split(key, 2)
    mods = timage.build_modules(ps)
    load_jax_params(mods, params)
    outs = _launch(tmp_path, name, {
        "scenario": "step", "task": "image", "spec": ps, "accum": 2, "opt_cfg": cfg,
        "state_dict": mods.state_dict(), "batch": {"image": t(imgs)},
        "model_parallel": tp, "fsdp": fsdp, "fsdp_min_size": 0,
        "draws": [_jax_draws(js, keys[i], 4) for i in range(2)]}, world)
    return outs, jl, jgrads, jnew


# ----------------------------------------------------------- the specs

def _trees():
    """Shape trees of the flux-dev DiT, the MetaCLIP-L/14 tower and the FLUX
    VAE (JAX's init, abstract: no weights are made)."""
    dit = jax.eval_shape(lambda k: jdit.init_dit(k, jdit.DIT_CONFIGS["flux-dev"]),
                         jax.random.key(0))
    vae = jax.eval_shape(lambda k: jvae.init_vae(k, jvae.VAE_CONFIGS["flux-dev"]),
                         jax.random.key(0))
    tower = jax.eval_shape(lambda k: jclip.init_clip(
        k, jclip.CLIP_VARIANTS["metaclip-l14-fullcc2.5b"]), jax.random.key(0))
    return dit, vae, tower


@pytest.fixture(scope="module")
def trees():
    return _trees()


def test_dit_param_spec_equals_jax_for_every_leaf(trees):
    """The port's spec of each flux-dev leaf (under the reference's names,
    through the path translation) equals JAX's of the grouped leaf, and the
    TP-sharded total is 0.906 B parameters (the double blocks' leaves
    included: copied verbatim without the translation, the rules would
    shard only the single blocks' 0.453 B)."""
    dit, _, _ = trees
    n_sharded = n_untranslated = 0
    for path, leaf in flatten_tree(dit).items():
        want = tuple(jtp.dit_param_spec(path, leaf))
        port = _dit_name(path)
        assert ttp.port_spec(port, leaf) == want, path
        assert ttp.jax_path(port) == path
        if want:
            n_sharded += math.prod(leaf.shape)
        if ttp.dit_param_spec(port, leaf):
            n_untranslated += math.prod(leaf.shape)
    assert round(n_sharded / 1e9, 3) == 0.906
    assert round(n_untranslated / 1e9, 3) == 0.453


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("with_tp", [False, True], ids=["dp", "tp_base"])
def test_fsdp_spec_equals_jax_for_every_leaf(trees, n, with_tp):
    """``fsdp_spec`` of every flux-dev, MetaCLIP-L/14 and VAE leaf at
    n = 2, 4, 8, with and without the DiT's TP spec as its base, equals
    JAX's (shapes only)."""
    for prefix, tree in zip(("dit", "vae", "tower"), trees):
        for path, leaf in flatten_tree(tree).items():
            base = jtp.dit_param_spec(path, leaf) if with_tp and prefix == "dit" else ()
            want = tuple(jfsdp.fsdp_spec(leaf, n, jax.sharding.PartitionSpec(*base)))
            pbase = ttp.port_spec(_dit_name(path), leaf) if with_tp and prefix == "dit" else ()
            assert tfsdp.fsdp_spec(leaf, n, pbase) == want, (prefix, path)


def test_validate_tp_messages():
    cfg = jdit.DIT_CONFIGS["flux-dev"]
    for bad in (5, 7):
        with pytest.raises(ValueError) as ours:
            ttp.validate_tp(cfg, bad)
        with pytest.raises(ValueError) as theirs:
            jtp.validate_tp(cfg, bad)
        assert str(ours.value) == str(theirs.value)
    ttp.validate_tp(cfg, 4)


# ----------------------------------------------------------- the TP step

@pytest.mark.parametrize("tp, fused", [(2, None), (2, "pallas"), (4, None), (4, "pallas")],
                         ids=["tp2-chain", "tp2-k3", "tp4-chain", "tp4-k3"])
def test_tp_step_matches_jax_on_the_global_batch(jax_init, tmp_path, tp, fused):  # noqa: F811
    """TP=2 and TP=4 image stage-1 steps (the chain and K3's plain version)
    against JAX's single-device step: the loss, the gradients and the
    parameters gathered to the reference layout; every rank holds the
    q, k and v rows of its heads and the same whole tensors after the
    gather."""
    outs, jl, jgrads, jnew = _tp_step(jax_init, tmp_path, f"tp{tp}", tp, tp,
                                      dict(HYPER, fused_optimizer=fused))
    _same_across_ranks(outs)
    np.testing.assert_allclose(outs[0]["loss"], jl, rtol=1e-4)
    _check_grads(outs[0]["grads"], jgrads)
    _check_params(outs[0]["params"], jnew, jgrads)
    h = 64
    for r, o in enumerate(outs):
        assert o["groups"]["model_index"] == r and o["groups"]["model_group"] == list(range(tp))
        assert o["local_shapes"]["dit.double_blocks.0.img_attn.qkv.weight"] == (3 * h // tp, h)
        assert o["local_shapes"]["dit.single_blocks.0.linear2.weight"] == (h, 5 * h // tp)
        assert o["local_shapes"]["dit.img_in.weight"] == (h, 16)


# ----------------------------------------------------------- the int8 stack

H, M = 512, 1024
LINEARS = {"dit.double_blocks.0.img_attn.qkv": (3 * H, H),
           "dit.double_blocks.0.img_attn.proj": (H, H),
           "dit.single_blocks.0.linear1": (3 * H + M, H),
           "dit.single_blocks.0.linear2": (H, H + M)}


@pytest.mark.parametrize("dw, cached", [("cols", True), ("int8_dw", False), ("bf16", False)],
                         ids=["int8_full-cache", "int8_dw", "int8"])
def test_switchback_calls_match_one_process(tmp_path, dw, cached):
    """Each kind of DiT linear (column-parallel ``qkv`` and ``linear1``,
    row-parallel ``proj`` and ``linear2``) through SwitchBack on 2 model
    ranks against the one-process call on equal whole inputs: y, dx, dW and
    the bias's gradient within 1e-5 of their largest element, the int8
    cache (the whole rows' scales of a row-parallel weight) bit for bit.
    ``proj``'s local [512, 256] falls under the gate's 512 while its whole
    [512, 512] does not: it runs SwitchBack on the ranks as in one process
    (a plain product would miss the int8 codes' bound by far)."""
    from genhancer_tpu_torch.core import nn as tnn_
    gen = torch.Generator().manual_seed(17)
    weights, xs, gs = {}, {}, {}
    for path, (o, i) in LINEARS.items():
        weights[path] = (torch.randn(o, i, generator=gen) / i ** 0.5,
                         torch.randn(o, generator=gen) * 0.1)
        xs[path] = torch.randn(64, i, generator=gen)
        gs[path] = torch.randn(64, o, generator=gen)
    outs = _launch(tmp_path, f"sb-{dw}", {"scenario": "linears", "tp": 2, "hidden": H,
                                          "weights": weights, "x": xs, "g": gs, "dw": dw,
                                          "cached": cached}, 2)
    for path, (w, b) in weights.items():
        lin = tnn_.Linear(w.shape[1], w.shape[0])
        with torch.no_grad():
            lin.weight.copy_(w)
            lin.bias.copy_(b)
        if cached:
            (wq, ws), = tq.quantize_cache({"w": lin.weight}, ["w"]).values()
            lin.register_buffer("weight_sb_q", wq, persistent=False)
            lin.register_buffer("weight_sb_scale", ws, persistent=False)
        x = xs[path].clone().requires_grad_(True)
        with tnn_.int8_training_ctx(full=dw == "cols", dw_int8=dw == "int8_dw"):
            y = tnn_.linear(lin, x)
        y.backward(gs[path])
        want = {"y": y.detach(), "dx": x.grad, "dw": lin.weight.grad, "db": lin.bias.grad}
        for o in outs:
            for k, ref in want.items():
                err = (o[path][k] - ref).abs().max()
                assert err <= 1e-5 * ref.abs().max(), (path, k, float(err))
            if cached:
                assert torch.equal(o[path]["cache"][0], wq) and torch.equal(
                    o[path]["cache"][1], ws), path
    # the control: the plain product, which proj would run if the gate read
    # its local shape, is far from SwitchBack's
    p = "dit.double_blocks.0.img_attn.proj"
    plain = xs[p] @ weights[p][0].t() + weights[p][1]
    assert (plain - outs[0][p]["y"]).abs().max() > 1e3 * 1e-5 * plain.abs().max()


def _int8_payload(dit_quant, bits):
    from test_torch_int8_step import _specs as int8_specs
    ps = int8_specs(dit_quant)[1]
    return {"scenario": "step", "task": "image", "spec": ps, "accum": 2, "seed": 3,
            "emit_quant": True,
            "opt_cfg": dict(HYPER, fused_optimizer="pallas", optimizer_moment_bits=bits),
            "state_dict": timage.init_modules(ps, torch.Generator().manual_seed(0))
            .state_dict(),
            "batch": {"image": torch.rand(2, 4, 32, 32, 3,
                                          generator=torch.Generator().manual_seed(5))}}


@pytest.mark.parametrize("dit_quant, bits", [("int8_full", 16), ("int8_dw", 8)],
                         ids=["int8_full-k4", "int8_dw-k6"])
def test_int8_tp_step_is_the_one_process_step(tmp_path, dit_quant, bits):
    """A float32 ``int8_full`` step with K4's cache (and an ``int8_dw``
    step with K6's 8-bit moments and cache) on 2 model ranks against the
    one-process step on the same batch and draws: the loss at JAX's int8
    bound (3e-3, ``tests/test_quant_parallel.py:134``), the gradients at
    the int8 step's noise bound, the parameters within 2·lr; the cache the
    update emitted (K4 and K6 on the gathered rows of a row-parallel leaf)
    equal bit for bit to the one-process quantization of the gathered
    masters, and the gathered moments in the reference layout."""
    payload = _int8_payload(dit_quant, bits)
    outs = _launch(tmp_path, f"int8tp-{dit_quant}", {**payload, "model_parallel": 2}, 2)
    one = __import__("genhancer_tpu_torch.parallel.testing",
                     fromlist=["scenario_step"]).scenario_step(payload)
    _same_across_ranks(outs)
    np.testing.assert_allclose(outs[0]["loss"], one["loss"], rtol=3e-3)
    for k, g in one["grads"].items():
        ours, ref = f32(outs[0]["grads"][k]), f32(g)
        assert np.abs(ours - ref).max() <= 5e-2 * max(np.abs(ref).max(), 1e-30), k
    for k, p in one["params"].items():
        assert np.abs(f32(outs[0]["params"][k]) - f32(p)).max() <= 2 * LR * (1 + 1e-3), k
    caches = outs[0]["caches"]
    assert caches.keys() == one["caches"].keys() and len(caches) >= 4
    want = tq.quantize_cache(outs[0]["params"], sorted(caches))
    for k, (wq, ws) in caches.items():
        assert torch.equal(wq, want[k][0]) and torch.equal(ws, want[k][1]), k
    assert any(s == (H, H) for s in [tuple(c[0].shape) for c in caches.values()])


def test_stage2_all_tp_ranks_keep_the_global_rows(tmp_path):
    """A float32 stage2_all step (LoRA on the replicated tower, its B's
    planted, dropout 0.1) on dp2 x tp2 with the trainer's seeded generator
    equals the one-process step on the global batch with the same seed:
    the two model ranks of each data index draw the global batch's values
    and keep that index's rows."""
    _, base = _specs("float32")
    ps = dataclasses.replace(base, stage="stage2_all", lora_r=4, lora_alpha=16.0,
                             lora_dropout=0.1)
    payload = {"scenario": "step", "task": "image", "spec": ps, "accum": 2,
               "opt_cfg": dict(HYPER), "state_dict": _stage2_state_dict(ps), "seed": 9,
               "batch": {"image": torch.rand(2, 4, 32, 32, 3,
                                             generator=torch.Generator().manual_seed(4))}}
    outs = _launch(tmp_path, "s2tp", {**payload, "model_parallel": 2}, 4)
    _same_across_ranks(outs)
    one = __import__("genhancer_tpu_torch.parallel.testing",
                     fromlist=["scenario_step"]).scenario_step(payload)
    np.testing.assert_allclose(outs[0]["loss"], one["loss"], rtol=1e-5)
    tower = max(np.abs(f32(g)).max() for k, g in one["grads"].items() if ".vision_model." in k)
    for k, g in one["grads"].items():
        scale = max(np.abs(f32(g)).max(), tower if k.endswith("k_proj.bias") else 1e-30)
        assert np.abs(f32(outs[0]["grads"][k]) - f32(g)).max() <= 1e-4 * scale, k
    for k, p in one["params"].items():
        assert np.abs(f32(outs[0]["params"][k]) - f32(p)).max() <= 2 * LR * (1 + 1e-3), k
    assert [o["groups"]["data_index"] for o in outs] == [0, 0, 1, 1]


@pytest.fixture(scope="module")
def sliding_init():
    modules = jvideo.init_modules(jax.random.key(0), tv.jax_spec("sliding"))
    return modules, jax.device_get(modules)


def test_video_tp_step_at_a_long_joint_sequence(sliding_init, tmp_path):
    """A float32 sliding-window video stage-1 step (accumulation 2, a
    padded row) at a joint length of 637 tokens (the flash path, K5's
    plain version, on each rank's 2 of 4 heads) on 2 model ranks against
    JAX's single-device step."""
    js = tv.jax_spec("sliding")
    assert (js.latent_hw[0] // 2) ** 2 + js.n_cond * js.patch_grid ** 2 >= 600
    ps = tv.port_spec(js)
    modules, params = sliding_init
    jopt = joptim.make_optimizer(dict(HYPER))
    jst = jstate.create_state(modules, jvideo.trainable_predicate(js, modules), jopt)
    batch = tv._batch("sliding", 2)
    key = jax.random.key(13)
    jl, jgrads, jnew = _jax_accum(jst, jvideo.make_loss_fn(js), jopt, batch, key)
    keys = jax.random.split(key, 2)
    mods = tv.tvideo.build_modules(ps)
    load_jax_params(mods, params)
    outs = _launch(tmp_path, "video", {
        "scenario": "step", "task": "video", "spec": ps, "accum": 2, "opt_cfg": dict(HYPER),
        "state_dict": mods.state_dict(), "batch": {k: t(v) for k, v in batch.items()},
        "model_parallel": 2, "draws": [tv._jax_draws(js, keys[i], 2) for i in range(2)]}, 2)
    _same_across_ranks(outs)
    np.testing.assert_allclose(outs[0]["loss"], jl, rtol=1e-4)
    _check_grads(outs[0]["grads"], jgrads)
    _check_params(outs[0]["params"], jnew, jgrads)


def test_a_binding_clip_counts_each_leaf_once(jax_init, tmp_path):  # noqa: F811
    """With ``max_grad_norm`` 1e-6 the clip binds and the first update is
    linear in the clip factor (the clipped gradients sit far below Adam's
    eps): a TP=2 step reports JAX's global norm and makes JAX's update;
    the control, a norm that counts each replicated leaf once per model
    rank (as summing every rank's squares would), moves the update off
    JAX's by far more than the bound."""
    import optax
    from genhancer_tpu_torch.train import optim as toptim
    cfg = dict(HYPER, max_grad_norm=1e-6)
    outs, jl, jgrads, jnew = _tp_step(jax_init, tmp_path, "clip", 2, 2, cfg)
    jnorm = float(optax.global_norm(jgrads))
    assert abs(outs[0]["grad_norm"] - jnorm) <= 1e-5 * jnorm
    _, params = jax_init
    old = {k: np.asarray(v, np.float32) for k, v in
           flatten_tree({"dit": params["dit"], "clip": params["clip"]}).items() if k in jnew}

    def misses(new):
        """The largest update error over its bound: 30x the leaf's gradient
        bound times its largest update (the update is linear in the small
        gradients and saturates at the large ones, which sets the scale)."""
        worst = 0.0
        for k, v in jnew.items():
            d_ref = np.asarray(v, np.float32) - old[k]
            d = f32(new[_port_name(k)]) - old[k]
            bound = 30 * _grad_bound(k) * max(np.abs(d_ref).max(), 1e-30)
            worst = max(worst, np.abs(d - d_ref).max() / bound)
        return worst

    assert misses(outs[0]["params"]) <= 1.0
    sharded = {k for k in jgrads if tuple(outs[0]["local_shapes"][_port_name(k)])
               != tuple(np.shape(jgrads[k]))}
    assert sharded
    sq = {k: float(np.sum(np.square(np.asarray(g, np.float64)))) for k, g in jgrads.items()}
    wrong = np.sqrt(sum(v * (1 if k in sharded else 2) for k, v in sq.items()))
    grads = {_port_name(k): t(np.asarray(g, np.float32)) for k, g in jgrads.items()}
    control = {k: t(v.copy()) for k, v in old.items()}
    control = {_port_name(k): v for k, v in control.items()}
    chain = toptim.make_optimizer(cfg)
    state = chain.init(control)
    real = toptim.global_norm
    toptim.global_norm = lambda g, axes=None: torch.tensor(wrong, dtype=torch.float32)
    try:
        chain.apply(control, grads, state)
    finally:
        toptim.global_norm = real
    assert misses(control) > 10.0


def test_converted_weights_land_on_the_ranks_blocks(jax_init):  # noqa: F811
    """``load_jax_params`` into modules placed for model rank r of 2 (the
    mesh's rank stubbed) gives each DiT leaf the rank's block of the
    converted whole leaf: the q, k and v rows of its heads, its MLP slice,
    its input columns of a row-parallel weight."""
    from genhancer_tpu_torch.parallel import layout as L
    from genhancer_tpu_torch.parallel import mesh as M
    _, ps = _specs("float32")
    _, params = jax_init
    whole = timage.build_modules(ps)
    load_jax_params(whole, params)
    h = ps.dit_cfg.hidden_size
    for r in range(2):
        mods = timage.build_modules(ps)
        old = M._MESH
        M._MESH = M.Mesh(2, None, None, (r,), (0, 1))
        orig = M.rank
        M.rank = lambda: r
        try:
            layout = L.place(mods, 2, hidden=h)
            load_jax_params(mods, params, layout)
            got = dict(mods.named_parameters())
            for k, w in whole.named_parameters():
                pl = layout.get(k)
                assert torch.equal(got[k], L.shard(w.detach(), pl)), k
            q = got["dit.double_blocks.0.img_attn.qkv.weight"]
            qw = dict(whole.named_parameters())["dit.double_blocks.0.img_attn.qkv.weight"]
            half = h // 2
            assert torch.equal(q[:half], qw[r * half:(r + 1) * half])          # q of its heads
            assert torch.equal(q[half:2 * half], qw[h + r * half:h + (r + 1) * half])   # k
        finally:
            M._MESH, M.rank = old, orig
