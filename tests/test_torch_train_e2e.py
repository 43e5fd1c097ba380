"""The port's stage-1 trainer end to end on the CPU, and its checkpoints
against the JAX package's.

A tiny model set (the TINY_* configs) is patched into the port's registry,
as tests/test_e2e_train.py patches the JAX one; the trainer then runs on
synthetic shards, writes reference-layout ``.bin`` files, and resumes from
its own ``optimizer-state-N.bin``.  The ``.bin`` files cross in both
directions: the JAX ``load_stage1_components`` reads the port's and the
port reads those of the JAX ``save_stage1``, value for value.  The data and
checkpoint helpers behave as the JAX ones on the same inputs.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from genhancer_tpu.train import checkpoint as jckpt
from genhancer_tpu.train import step_utils as jstep
from genhancer_tpu.train.state import TrainState as JaxTrainState
from genhancer_tpu.weights import hf_convert
from genhancer_tpu_torch import registry
from genhancer_tpu_torch.data import testing
from genhancer_tpu_torch.tasks import image as timage
from genhancer_tpu_torch.train import checkpoint as ckpt
from genhancer_tpu_torch.train import step_utils
from genhancer_tpu_torch.train.config import load_config
from genhancer_tpu_torch.train.trainer import Trainer

from test_torch_parity import TINY_DIT, TINY_TOWER, TINY_VAE, port_cfg

torch.set_num_threads(1)


@pytest.fixture
def tiny_models(monkeypatch):
    monkeypatch.setattr(registry, "build_dit_config", lambda name: port_cfg(TINY_DIT))
    monkeypatch.setattr(registry, "build_vae_config", lambda name, ae_path=None: port_cfg(TINY_VAE))
    monkeypatch.setattr(registry, "tower_family_and_config",
                        lambda tower, size, clip_type=None: ("clip", port_cfg(TINY_TOWER)))


def write_cfg(tmp_path, shards_dir, **overrides):
    cfg = {"task": "image_stage1", "tower": "openai_clip",
           "data_config": {"train_batch_size": 2, "num_workers": 1, "img_size": 32,
                           "img_dir": shards_dir, "seed": 0},
           "clip_config": {"clip_image_size": 32, "clip_dim": 24, "t5_dim": 32},
           "output_dir": str(tmp_path / "out"), "max_train_steps": 3,
           "checkpointing_steps": 2, "learning_rate": 1e-3,
           "gradient_accumulation_steps": 2, "mixed_precision": "bf16",
           "report_to": "none", "log_interval": 1, "resume_from_checkpoint": "latest"}
    cfg.update(overrides)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return load_config(str(path))


@pytest.fixture
def shards(tmp_path):
    d = tmp_path / "shards"
    for i in range(2):
        testing.make_image_shard(str(d / f"s{i}.tar"), 8, 48, seed=i)
    return str(d)


def _jax_name(port_key: str, prefix: str) -> str:
    """A port module key under ``prefix`` -> the JAX flat path."""
    if prefix == "dit":
        return "dit." + hf_convert._dit_rename_from_torch(port_key)
    return f"{prefix}.{port_key}"


COMPONENTS = (("dit", "dit"), ("project_clip", "clip.project_clip"),
              ("project_t5", "clip.project_t5"))


def _component_sds(modules):
    return {"dit": modules["dit"].state_dict(),
            "project_clip": modules["clip"]["project_clip"].state_dict(),
            "project_t5": modules["clip"]["project_t5"].state_dict()}


@pytest.mark.parametrize("fused", [None, "pallas"])
def test_trainer_trains_checkpoints_and_resumes(tiny_models, tmp_path, shards, fused):
    cfg = write_cfg(tmp_path, shards, fused_optimizer=fused)
    trainer = Trainer(cfg, device="cpu")
    metrics = trainer.train()
    assert metrics["step"] == 3 and np.isfinite(metrics["loss"])
    assert [h["step"] for h in trainer.history] == [1, 2, 3]
    out = cfg["output_dir"]
    assert ckpt.all_steps(out) == [2, 3]
    for s in (2, 3):
        for name in ("checkpoint-dit", "checkpoint-project-clip", "checkpoint-project-t5",
                     "optimizer-state"):
            assert os.path.exists(os.path.join(out, f"{name}-{s}.bin"))
    saved = {k: v.clone() for k, v in trainer.state.opt_state["nu"].items()}
    weights = {k: v.detach().clone() for k, v in trainer.state.trainable.items()}

    cfg2 = write_cfg(tmp_path, shards, fused_optimizer=fused, max_train_steps=4)
    resumed = Trainer(cfg2, device="cpu")
    assert resumed.state.step == 3 and resumed.state.opt_state["count"] == 3
    for k, v in saved.items():
        assert torch.equal(resumed.state.opt_state["nu"][k], v), k
    for k, v in weights.items():
        assert torch.equal(resumed.state.trainable[k].detach(), v), k
    assert resumed.train()["step"] == 4
    assert ckpt.latest_step(out) == 4


def test_port_bins_load_in_jax(tiny_models, tmp_path, shards):
    cfg = write_cfg(tmp_path, shards, max_train_steps=2)
    trainer = Trainer(cfg, device="cpu")
    trainer.train()
    sds = _component_sds(trainer.state.modules)
    flat = {_jax_name(k, prefix): jnp.zeros(tuple(v.shape), jnp.float32)
            for name, prefix in COMPONENTS for k, v in sds[name].items()}
    state = JaxTrainState(trainable=flat, frozen={}, opt_state=(),
                          step=jnp.zeros((), jnp.int32))
    state = jckpt.load_stage1_components(state, cfg["output_dir"], 2)
    for name, prefix in COMPONENTS:
        for k, v in sds[name].items():
            np.testing.assert_array_equal(np.asarray(state.trainable[_jax_name(k, prefix)]),
                                          v.to(torch.float32).numpy(), err_msg=k)


def test_jax_bins_load_in_port(tiny_models, tmp_path):
    spec = timage.TaskSpec(stage="stage1", tower_kind="clip", img_size=32,
                           clip_image_size=32, dit_cfg=port_cfg(TINY_DIT),
                           vae_cfg=port_cfg(TINY_VAE), tower_cfg=port_cfg(TINY_TOWER),
                           clip_dim=24, t5_dim=32)
    src = timage.init_modules(spec, torch.Generator().manual_seed(3))
    sds = _component_sds(src)
    trainable = {}
    for name, prefix in COMPONENTS:
        for k, v in sds[name].items():
            arr = v.to(torch.float32).numpy()
            trainable[_jax_name(k, prefix)] = jnp.asarray(arr).astype(
                jnp.bfloat16 if v.dtype == torch.bfloat16 else jnp.float32)
    state = JaxTrainState(trainable=trainable, frozen={}, opt_state=(),
                          step=jnp.asarray(5, jnp.int32))
    jckpt.save_stage1(state, str(tmp_path), 5)
    dst = timage.init_modules(spec, torch.Generator().manual_seed(4))
    ckpt.load_stage1_components(dst, str(tmp_path), 5)      # strict
    for name, sd in _component_sds(dst).items():
        for k, v in sd.items():
            assert v.dtype == sds[name][k].dtype and torch.equal(v, sds[name][k]), k


STACK_CASES = {
    "equal": [{"image": np.ones((2, 3), np.float32)}, {"image": np.zeros((2, 3), np.float32)}],
    "ragged": [{"image": np.ones((3, 2), np.float32)}, {"image": np.ones((1, 2), np.float32)}],
    "valid": [{"image": np.ones((2, 2), np.float32), "valid": np.array([True, False])},
              {"image": np.ones((2, 2), np.float32)}],
}


@pytest.mark.parametrize("case", sorted(STACK_CASES))
def test_stack_microbatches_matches_jax(case):
    ours = step_utils.stack_microbatches(STACK_CASES[case])
    ref = jstep.stack_microbatches(STACK_CASES[case])
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
    with pytest.raises(ValueError, match="missing keys"):
        step_utils.stack_microbatches([{"image": np.ones(2), "x": np.ones(2)},
                                       {"image": np.ones(2)}])


def test_prune_and_latest_step_match_jax(tmp_path):
    names = ["checkpoint-dit-{}.bin", "checkpoint-project-clip-{}.bin",
             "checkpoint-project-t5-{}.bin", "optimizer-state-{}.bin"]
    for d in ("ours", "ref"):
        os.makedirs(tmp_path / d)
        for s in (10, 2, 30, 7):
            for n in names:
                (tmp_path / d / n.format(s)).write_bytes(b"x")
        (tmp_path / d / "checkpoint-dit-x.bin").write_bytes(b"x")   # not a step
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    assert ckpt.latest_step(ours) == jckpt.latest_step(ref) == 30
    assert ckpt.prune_checkpoints(ours, 2) == jckpt.prune_checkpoints(ref, 2) == [2, 7]
    assert sorted(os.listdir(ours)) == sorted(os.listdir(ref))
    assert ckpt.all_steps(ours) == [10, 30]
    assert ckpt.latest_step(str(tmp_path / "missing")) is None
