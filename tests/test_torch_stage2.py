"""Image stage 2 of the port (LoRA on the whole CLIP tower) against the JAX
package: the accumulated training step of ``stage2_all`` and
``stage2_only``, the trainable set, the LoRA-merged HF export, the HF tower
loaders of both packages on each other's exports, and the stage-2 trainer
from a stage-1 checkpoint through export and resume.

The JAX tree is the JAX ``init_modules`` of a tiny stage-2 spec with a
nonzero ``lora_B`` planted in every wrapped linear (at B = 0 the branch adds
nothing and dA is 0), carried into the port by ``weights/convert.py``.  The
port's loss takes the JAX step's own draws: t, the noise, the VAE sample and
the LoRA dropout masks (``fold_in(k_drop, call)`` + ``bernoulli``, call
order q, k, v, out_proj, fc1, fc2 per layer, then visual_projection).
Bounds as the stage-1 tests (tests/test_torch_train_step.py): float32 loss
1e-5 relative, each leaf's gradient within 1e-4 of its largest entry
(1e-3 for the two layers fed by the sinusoidal embeddings), params after
one step within 2*lr*(1 + 1e-3).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genhancer_tpu import registry as jregistry
from genhancer_tpu.tasks import conditioning as jcond
from genhancer_tpu.tasks import image as jimage
from genhancer_tpu.train import checkpoint as jckpt
from genhancer_tpu.train import flow as jflow
from genhancer_tpu.train import lora as jlora
from genhancer_tpu.train import optim as joptim
from genhancer_tpu.train import state as jstate
from genhancer_tpu.train import step_utils as jstep
from genhancer_tpu.train.trainer import hf_export_name as jax_export_name
from genhancer_tpu.weights import hf_convert
from genhancer_tpu_torch import registry
from genhancer_tpu_torch.core import nn as tnn
from genhancer_tpu_torch.data import testing
from genhancer_tpu_torch.tasks import conditioning as tcond
from genhancer_tpu_torch.tasks import image as timage
from genhancer_tpu_torch.train import checkpoint as ckpt
from genhancer_tpu_torch.train import lora
from genhancer_tpu_torch.train import optim
from genhancer_tpu_torch.train.step_utils import make_accum_train_step
from genhancer_tpu_torch.train.trainer import Trainer, hf_export_name
from genhancer_tpu_torch.weights.convert import _dit_name, load_jax_params

from test_torch_parity import TINY_TOWER, f32, jax_spec, port_cfg, port_spec, t
from test_torch_train_e2e import shards, tiny_models, write_cfg  # noqa: F401 (fixtures)

torch.set_num_threads(1)

LR = 1e-3
HYPER = dict(learning_rate=LR, lr_scheduler="constant", max_train_steps=10)
LORA = dict(lora_r=3, lora_alpha=16.0, lora_dropout=0.1)      # scale 16/3
STAGES = ("stage2_all", "stage2_only")


def _specs(stage):
    js = dataclasses.replace(jax_spec(compute_dtype=jnp.float32, dit_param_dtype=jnp.float32),
                             stage=stage, vae_dtype=jnp.float32, **LORA)
    ps = dataclasses.replace(port_spec(js), stage=stage, vae_dtype=torch.float32, **LORA)
    return js, ps


def _node(tree, path):
    for part in path.split("."):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


@pytest.fixture(scope="module")
def jax_init():
    """One float32 JAX stage-2 init for the file, a nonzero B planted in
    every wrapped linear (both stages build the same tree)."""
    js, _ = _specs("stage2_all")
    modules = jax.device_get(jimage.init_modules(jax.random.key(0), js))
    rng = np.random.default_rng(4)
    tower = modules["clip"]["model"]
    wrapped = [p[: -len(".lora_A")] for p in jlora.lora_trainable_paths(tower)
               if p.endswith(".lora_A")]
    for path in wrapped:
        node = _node(tower, path)
        node["lora_B"] = 0.1 * rng.standard_normal(node["lora_B"].shape).astype(np.float32)
    return modules, wrapped


def _port_name(path: str) -> str:
    return "dit." + _dit_name(path[4:]) if path.startswith("dit.") else path


def _jax_state(jax_init, stage, optimizer):
    js, _ = _specs(stage)
    modules = jax.tree_util.tree_map(jnp.asarray, jax_init[0])
    return jstate.create_state(modules, jimage.trainable_predicate(js, modules), optimizer)


def _port_state(jax_init, stage, optimizer):
    _, ps = _specs(stage)
    mods = timage.init_modules(ps, torch.Generator().manual_seed(0))
    load_jax_params(mods, {k: jax_init[0][k] for k in ("dit", "vae", "clip")})
    return timage.create_state(mods, timage.trainable_predicate(ps, mods), optimizer)


def _mask_shapes(cfg, b):
    """The input shape of each LoRA-wrapped call of the vision forward, in
    call order."""
    v = cfg.vision
    l = v.grid ** 2 + 1
    per_layer = [(b, l, v.hidden_size)] * 5 + [(b, l, v.intermediate_size)]
    return per_layer * v.num_layers + [(b, v.hidden_size)]


def _jax_draws(js, key, b):
    """The draws JAX's stage-2 loss makes from ``key``, as torch tensors."""
    k_vae, k_t, k_noise, k_drop = jax.random.split(key, 4)
    h, w = js.latent_hw
    z = js.vae_cfg.z_channels
    keep = 1.0 - js.lora_dropout
    return {"t": t(np.asarray(jflow.sample_timesteps(k_t, b, js.scale_factor))),
            "x0": t(np.asarray(jax.random.normal(k_noise, (b, (h // 2) * (w // 2), 4 * z)))),
            "vae_noise": t(np.asarray(jax.random.normal(k_vae, (b, h, w, z)))),
            "lora_masks": [t(np.asarray(jax.random.bernoulli(jax.random.fold_in(k_drop, i + 1),
                                                             keep, s)))
                           for i, s in enumerate(_mask_shapes(js.tower_cfg, b))]}


def _images(n, b=2):
    return np.random.default_rng(3).random((n, b, 32, 32, 3), dtype=np.float32)


class _Recorder:
    """Delegates to an optimizer and keeps the grads it was given."""

    def __init__(self, inner):
        self.inner, self.grads = inner, None

    def init(self, params):
        return self.inner.init(params)

    def apply(self, params, grads, state):
        self.grads = {k: g.detach().clone() for k, g in grads.items()}
        return self.inner.apply(params, grads, state)


@pytest.mark.parametrize("stage", STAGES)
def test_trainable_set_matches_jax(jax_init, stage):
    """stage2_only: the LoRA factors and the wrapped biases take
    ``requires_grad``, nothing else; stage2_all adds the DiT and projectors."""
    js, _ = _specs(stage)
    jst = _jax_state(jax_init, stage, joptim.make_optimizer(dict(HYPER)))
    state = _port_state(jax_init, stage, optim.make_optimizer(dict(HYPER)))
    assert {_port_name(k) for k in jst.trainable} == set(state.trainable)
    grad_on = {k for k, p in state.modules.named_parameters() if p.requires_grad}
    assert grad_on == set(state.trainable)
    tower_train = {k for k in state.trainable if k.startswith("clip.model.")}
    assert tower_train == {"clip.model." + p for p in
                           lora.lora_trainable_paths(state.modules["clip"]["model"])}
    assert len(tower_train) == 2 * 14 + 12      # 14 wrapped linears, 12 with a bias
    if stage == "stage2_only":
        assert tower_train == set(state.trainable)
    else:
        assert any(k.startswith("dit.") for k in state.trainable)
        assert any(".project_t5." in k for k in state.trainable)


@pytest.mark.parametrize("stage", STAGES)
def test_accumulation_step_matches_jax(jax_init, stage):
    """Loss, grads (the text side's zero) of one accumulation-2 step, then
    the params after the chain's update: the text side's LoRA leaves only
    decay."""
    js, ps = _specs(stage)
    jopt = joptim.make_optimizer(dict(HYPER))
    jst = _jax_state(jax_init, stage, jopt)
    jloss = jimage.make_loss_fn(js)
    imgs = _images(2)
    key = jax.random.key(11)
    keys = jax.random.split(key, 2)
    jgrads = None
    for i in range(2):             # make_accum_train_step's micro_grads, eagerly
        _, g = jax.value_and_grad(
            lambda tp: jloss(tp, jst.frozen, {"image": jnp.asarray(imgs[i])}, keys[i]) * 0.5
        )(jst.trainable)
        jgrads = g if jgrads is None else jax.tree_util.tree_map(jnp.add, jgrads, g)
    before = {k: np.asarray(v) for k, v in jst.trainable.items()}
    new_jst, jm = jstep.make_accum_train_step(jloss, jopt, 2)(
        jst, {"image": jnp.asarray(imgs)}, key)

    rec = _Recorder(optim.make_optimizer(dict(HYPER)))
    state = _port_state(jax_init, stage, rec)
    step = make_accum_train_step(timage.make_loss_fn(ps), rec, 2)
    state, m = step(state, {"image": t(imgs)}, None, [_jax_draws(js, keys[i], 2)
                                                        for i in range(2)])

    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
    text = [k for k in jgrads if k.startswith(("clip.model.text_model.",
                                               "clip.model.text_projection."))]
    assert len(text) == 2 * 7 + 6
    # a key bias adds q.b_k to a whole softmax row, which the softmax
    # ignores: its gradient is 0 but for roundoff in both packages, held
    # against the largest gradient of the tower instead of its own
    tower_max = max(np.abs(np.asarray(g)).max() for k, g in jgrads.items()
                    if k.startswith("clip.model."))
    for k, g in jgrads.items():
        ours, ref = f32(rec.grads[_port_name(k)]), np.asarray(g, np.float32)
        if k in text:
            assert not ref.any() and not ours.any(), k
            continue
        if k.endswith("self_attn.k_proj.bias"):
            assert max(np.abs(ours).max(), np.abs(ref).max()) <= 1e-4 * tower_max, k
            continue
        assert np.abs(ref).max() > 0, k             # B != 0: every factor is seen
        rel = 1e-3 if k in ("dit.time_in.in_layer.weight", "dit.guidance_in.in_layer.weight") \
            else 1e-4
        assert np.abs(ours - ref).max() <= rel * np.abs(ref).max(), k
    bound = 2 * LR * (1 + 1e-3)
    for k, v in new_jst.trainable.items():
        ours, ref = f32(state.trainable[_port_name(k)]), np.asarray(v, np.float32)
        assert np.abs(ours - ref).max() <= bound, k
        if k in text:                               # AdamW's decay alone
            np.testing.assert_allclose(ours, before[k] * (1 - LR * 0.01), rtol=1e-6,
                                       atol=1e-9, err_msg=k)
    assert state.step == 1


def test_export_matches_jax(jax_init, tmp_path):
    """``export_hf_tower``'s files against ``hf_convert.tower_to_torch`` of
    the JAX ``merge``: the same keys, values at 1e-6, ``config.json`` =
    ``CLIPConfig.to_hf``."""
    js, ps = _specs("stage2_all")
    state = _port_state(jax_init, "stage2_all", optim.make_optimizer(dict(HYPER)))
    out = ckpt.export_hf_tower(state, str(tmp_path / "export"),
                               base_config=ps.tower_cfg.to_hf())
    got = torch.load(os.path.join(out, "pytorch_model.bin"), weights_only=True)
    ref = hf_convert.tower_to_torch(jlora.merge(jax_init[0]["clip"]["model"]))
    assert set(got) == set(ref)
    for k, v in ref.items():
        v = np.asarray(v, np.float32)
        assert tuple(got[k].shape) == v.shape, k
        np.testing.assert_allclose(f32(got[k]), v, rtol=1e-6,
                                   atol=1e-6 * max(np.abs(v).max(), 1e-30), err_msg=k)
    with open(os.path.join(out, "config.json")) as f:
        assert json.load(f) == js.tower_cfg.to_hf() == ps.tower_cfg.to_hf()
    # the training tower keeps its factors
    assert lora.wrapped_paths(state.modules["clip"]["model"])


def _class_tokens_jax(tower, cfg, px):
    return np.asarray(jcond.tower_features("clip", {"model": tower}, jnp.asarray(px), cfg)[0])


def _class_tokens_port(tower, cfg, px):
    with torch.no_grad():
        return tcond.tower_features("clip", {"model": tower}, t(px), cfg)[0].numpy()


def test_each_package_loads_the_others_export(jax_init, tmp_path):
    """JAX ``registry.load_tower`` reads the port's export and the port's
    ``load_tower`` reads JAX's; both give the class tokens of the merged
    tower: the port's bit for bit against its in-memory merge, the two
    packages within 1e-5."""
    js, ps = _specs("stage2_all")
    state = _port_state(jax_init, "stage2_all", optim.make_optimizer(dict(HYPER)))
    port_dir = ckpt.export_hf_tower(state, str(tmp_path / "port"),
                                    base_config=ps.tower_cfg.to_hf())
    jst = _jax_state(jax_init, "stage2_all", joptim.make_optimizer(dict(HYPER)))
    jax_dir = jckpt.export_hf_tower(jst, str(tmp_path / "jax"),
                                    base_config=js.tower_cfg.to_hf())
    px = np.random.default_rng(6).standard_normal((2, 32, 32, 3)).astype(np.float32)

    jtower, jcfg = jregistry.load_tower("clip", js.tower_cfg, port_dir)
    assert jcfg == js.tower_cfg
    ptower, pcfg = registry.load_tower("clip", ps.tower_cfg, jax_dir)
    assert pcfg == ps.tower_cfg
    assert isinstance(ptower, type(state.modules["clip"]["model"]))
    merged = lora.merge(state.modules["clip"]["model"])
    own, _ = registry.load_tower("clip", ps.tower_cfg, port_dir)
    ref = _class_tokens_port(merged, ps.tower_cfg, px)
    np.testing.assert_array_equal(_class_tokens_port(own, ps.tower_cfg, px), ref)
    jref = _class_tokens_jax(jlora.merge(jax_init[0]["clip"]["model"]), js.tower_cfg, px)
    for ours, want in ((_class_tokens_jax(jtower, js.tower_cfg, px), jref),
                       (_class_tokens_port(ptower, ps.tower_cfg, px), jref), (ref, jref)):
        np.testing.assert_allclose(ours, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # a vision-only tower (stage 1, serving) reads the same directory
    vision, _ = registry.load_tower("clip", ps.tower_cfg, jax_dir, text_side=False)
    np.testing.assert_array_equal(_class_tokens_port(vision, ps.tower_cfg, px),
                                  _class_tokens_port(ptower, ps.tower_cfg, px))


def test_load_tower_strips_model_prefix_and_warns_on_a_missing_dir(tmp_path, caplog):
    _, ps = _specs("stage2_all")
    tower, _ = registry.load_tower("clip", ps.tower_cfg, None,
                                   torch.Generator().manual_seed(0))
    sd = {"model." + k: v for k, v in tower.state_dict().items()}
    sd["model.vision_model.embeddings.position_ids"] = torch.arange(5)[None]
    (tmp_path / "d").mkdir()
    torch.save(sd, str(tmp_path / "d" / "pytorch_model.bin"))
    (tmp_path / "d" / "config.json").write_text(json.dumps(ps.tower_cfg.to_hf()))
    loaded, _ = registry.load_tower("clip", ps.tower_cfg, str(tmp_path / "d"))
    for k, v in tower.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    with caplog.at_level("WARNING"):
        rand, cfg = registry.load_tower("clip", ps.tower_cfg, str(tmp_path / "missing"),
                                        torch.Generator().manual_seed(0))
    assert "not found" in caplog.text and cfg == ps.tower_cfg
    assert all(torch.equal(rand.state_dict()[k], v) for k, v in tower.state_dict().items())


def _stage2_cfg(tmp_path, shards_dir, stage1_out, task, **overrides):
    kw = dict(task=task, load_dir=stage1_out, load_step=2,
              output_dir=str(tmp_path / f"out-{task}"), max_train_steps=2,
              lora_config={"r": 4, "lora_alpha": 16, "lora_dropout": 0.1})
    return write_cfg(tmp_path, shards_dir, **{**kw, **overrides})


@pytest.mark.parametrize("task", ["image_stage2_all", "image_stage2_only"])
def test_trainer_from_stage1_through_export_and_resume(tiny_models, tmp_path, shards, task):
    """The stage-1 trainer writes step 2; the stage-2 trainer loads it
    through load_dir, trains 2 steps, writes the stage-1 files and the HF
    export at each checkpoint; a resume reloads the components and the
    optimizer state while the LoRA factors restart from their initial
    values (the JAX package's behaviour, checkpoint.py:192-207)."""
    s1 = Trainer(write_cfg(tmp_path, shards, max_train_steps=2), device="cpu")
    s1.train()
    stage1_out = s1.cfg["output_dir"]
    proj = {k: v.clone() for k, v in s1.state.modules["clip"]["project_t5"].state_dict().items()}

    cfg = _stage2_cfg(tmp_path, shards, stage1_out, task, checkpointing_steps=1)
    trainer = Trainer(cfg, device="cpu")
    assert trainer.state.step == 0
    for k, v in trainer.state.modules["clip"]["project_t5"].state_dict().items():
        assert torch.equal(v, proj[k]), k                  # loaded from load_dir
    init = {k: v.detach().clone() for k, v in trainer.state.trainable.items()}
    assert trainer.train()["step"] == 2
    out = cfg["output_dir"]
    for s in (1, 2):
        for name in ("checkpoint-dit", "checkpoint-project-clip", "checkpoint-project-t5",
                     "optimizer-state"):
            assert os.path.exists(os.path.join(out, f"{name}-{s}.bin"))
        assert hf_export_name(cfg, s) == jax_export_name(cfg, s) \
            == f"clip-vit-large-patch14-336-{s}"           # 32 px, not 224
        export = os.path.join(out, hf_export_name(cfg, s))
        assert sorted(os.listdir(export)) == ["config.json", "pytorch_model.bin"]
    trained = {k: v.detach().clone() for k, v in trainer.state.trainable.items()}
    lora_keys = [k for k in trained if ".lora_" in k]
    assert any(not torch.equal(trained[k], init[k]) for k in lora_keys)
    tower, _ = registry.load_tower("clip", trainer.spec.tower_cfg, export)
    px = np.random.default_rng(8).random((2, 32, 32, 3), dtype=np.float32)
    np.testing.assert_array_equal(
        _class_tokens_port(tower, trainer.spec.tower_cfg, px),
        _class_tokens_port(lora.merge(trainer.state.modules["clip"]["model"]),
                           trainer.spec.tower_cfg, px))
    nu = {k: v.clone() for k, v in trainer.state.opt_state["nu"].items()}

    resumed = Trainer(_stage2_cfg(tmp_path, shards, stage1_out, task, max_train_steps=3),
                      device="cpu")
    rs = resumed.state
    assert rs.step == 2 and rs.opt_state["count"] == 2
    for k, v in nu.items():
        assert torch.equal(rs.opt_state["nu"][k], v), k    # every moment comes back
    for k in lora_keys:
        assert torch.equal(rs.trainable[k].detach(), init[k]), k   # the factors restart
    for k in trained:
        if k.startswith(("dit.", "clip.project_")):
            assert torch.equal(rs.trainable[k].detach(), trained[k]), k
    assert resumed.train()["step"] == 3
    assert os.path.isdir(os.path.join(out, hf_export_name(cfg, 3)))


def test_stage2_refusals():
    """QLoRA and a static int8 DiT in stage2_only, once refused, are ported
    (tests/test_torch_qlora.py): the spec builds its loss, the DiT takes the
    static int8 base beside its kept weights, and the stage-1 DiT files
    still load into it strictly; ``tower_remat`` is ported and taken from
    the config (image stage 2 has no automatic gate)."""
    from genhancer_tpu_torch.tasks.factory import build_spec
    from genhancer_tpu_torch.train.config import load_config
    _, ps = _specs("stage2_all")
    timage.make_loss_fn(dataclasses.replace(ps, tower_quant="int8"))
    mods = timage.init_modules(dataclasses.replace(ps, stage="stage2_only", dit_quant="int8"),
                               torch.Generator())
    static = [p for p, m in mods["dit"].named_modules() if "weight_q" in m._buffers]
    assert static and all("weight" in mods["dit"].get_submodule(p)._parameters
                          for p in static)
    mods["dit"].load_state_dict(mods["dit"].state_dict(), strict=True)
    cfg = load_config("configs/MetaCLIP_large_stage2_all.yaml")
    assert build_spec(cfg.merged_with({"tower_remat": True}))[0].tower_remat
    spec, kind, ckpt_kind = build_spec(cfg)
    assert (spec.stage, spec.lora_r, spec.lora_alpha, spec.lora_dropout,
            spec.lora_targets, spec.tower_remat, ckpt_kind) == (
        "stage2_all", 16, 16.0, 0.1, "all-linear", False, "image")


def test_trainer_names_map_to_stage2():
    from genhancer_tpu.tasks.factory import TRAINER_COMPAT as JAX_COMPAT
    from genhancer_tpu_torch.tasks.factory import TRAINER_COMPAT, build_spec
    from genhancer_tpu_torch.train.config import load_config
    assert TRAINER_COMPAT == JAX_COMPAT
    for name in ("train_MetaCLIP_stage2_only", "train_MetaCLIP_stage2_all"):
        task, tower = TRAINER_COMPAT[name]
        cfg = load_config("configs/MetaCLIP_large_stage2_all.yaml").merged_with(
            {"task": task, "tower": tower})
        assert build_spec(cfg)[0].stage == task[len("image_"):]
