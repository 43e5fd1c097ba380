"""The shape-only planner of the port (``genhancer_tpu_torch/train/plan.py``,
``genhancer-plan-torch``) against JAX's (``genhancer_tpu/train/plan.py``).

The port builds the task state on the meta device and applies its own
placement rules; JAX builds it with ``jax.eval_shape``.  On the same config
and budget the two reports name the same candidates and the same
recommendation, and each entry's GiB agree to 1e-9 where the trees agree:
the trainable leaves, the gradients and the activation heuristic (JAX's
``train_batch_size`` is each process's, the port's each data rank's: JAX
is given the same global batch).  Where the trees differ, the difference
is exactly the leaves one tree holds and the other does not: JAX's stage-1
tower keeps its text side and ``logit_scale`` as frozen leaves (the port's
stage-1 tower has no text side), JAX's LoRA wrappers keep ``lora_scale``
as a frozen leaf (a buffer in the port), and JAX's optimizer state holds
two int32 step counts (a Python int in the port).
"""

import builtins
import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from genhancer_tpu.train import plan as jplan
from genhancer_tpu.train.config import Config as JConfig, TRAIN_DEFAULTS as JDEFAULTS
from genhancer_tpu.train.state import flatten_params
from genhancer_tpu_torch import registry
from genhancer_tpu_torch.core.kernels.adamw import Moment8
from genhancer_tpu_torch.tasks import image as timage
from genhancer_tpu_torch.train import plan as tplan
from genhancer_tpu_torch.train.config import Config, TRAIN_DEFAULTS
from genhancer_tpu_torch.weights import hf_io

from test_torch_train_e2e import shards  # noqa: F401 (fixture)

torch.set_num_threads(1)

GIB = 1024.0 ** 3


def _raw(**over):
    c = {"task": "image_stage1", "tower": "openai_clip", "model_name": "flux-debug",
         "data_config": {"train_batch_size": 4, "img_size": 224,
                         "img_dir": "/nonexistent-never-touched"},
         "clip_config": {"clip_image_size": 224, "clip_dim": 768, "t5_dim": 4096},
         "max_train_steps": 10}
    c.update(over)
    return c


def debug_cfg(**over):
    return Config({**TRAIN_DEFAULTS, **_raw(**over)})


def jax_cfg(dp, **over):
    """JAX's config of the same global batch: its batch is the process's
    (one process holds every data index here)."""
    raw = _raw(**over)
    raw["data_config"] = dict(raw["data_config"],
                              train_batch_size=raw["data_config"]["train_batch_size"] * dp)
    return JConfig({**JDEFAULTS, **raw})


def _jax_only_bytes(cfg_over) -> tuple:
    """(frozen, optimizer) bytes JAX's tree holds and the port's does not."""
    _, _, state = jplan.shape_state(jax_cfg(1, **cfg_over))
    _, _, tstate, _ = tplan.shape_state(debug_cfg(**cfg_over))
    _, tfrozen = tplan.static_leaves(tstate)
    jfrozen = flatten_params(state.frozen)
    extra = sum(int(np.prod(v.shape)) * v.dtype.itemsize for k, v in jfrozen.items()
                if k not in tfrozen)
    counts = sum(v.dtype.itemsize for v in jax.tree_util.tree_leaves(state.opt_state)
                 if v.ndim == 0)
    return extra, counts


# name -> (config overrides, num_devices, budget in GiB: None = 0.45 of the
# configured total, forcing the ladder)
CASES = {
    "stage1-fits": ({}, 8, 512.0),
    "stage1-ladder": ({"fsdp_min_size": 0}, 8, None),
    "video-stage2-exhausted": ({"task": "video_middle_stage2_all", "fsdp_min_size": 0}, 8, 1e-6),
    "video-stage1-exhausted": ({"task": "video_middle_stage1", "fsdp_min_size": 0}, 8, 1e-6),
    "sp2": ({"sequence_parallel": 2}, 8, 1e-6),
    "fused-optimizer": ({"fused_optimizer": "pallas"}, 8, 1e-6),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_report_matches_jax(name):
    over, n, budget = CASES[name]
    if budget is None:
        budget = tplan.plan(debug_cfg(**over), num_devices=n, hbm_gb=512.0)[
            "configured"]["total_gib"] * 0.45
    ours = tplan.plan(debug_cfg(**over), num_devices=n, hbm_gb=budget)
    dp0 = ours["configured"]["dp"]
    theirs = jplan.plan(jax_cfg(dp0, **over), num_devices=n, hbm_gb=budget)
    assert [e["name"] for e in ours["candidates"]] == [e["name"] for e in theirs["candidates"]]
    assert ours["recommendation"] == theirs["recommendation"]
    assert ours["num_devices"] == theirs["num_devices"] == n
    extra, counts = _jax_only_bytes(over)
    for a, b in zip(ours["candidates"], theirs["candidates"]):
        assert (a["dp"], a["tp"], a["knobs"]) == (b["dp"], b["tp"], b["knobs"])
        for k in ("trainable_gib", "grads_gib"):
            assert abs(a[k] - b[k]) <= 1e-9, (a["name"], k, a[k] - b[k])
        if a["tp"] == ours["configured"]["tp"]:      # the same data axis: the same batch
            assert abs(a["activations_gib_est"] - b["activations_gib_est"]) <= 1e-9, a["name"]
        if not a["knobs"]["fsdp"]:                   # JAX's extra leaves stay whole
            assert abs((b["frozen_gib"] - a["frozen_gib"]) - extra / GIB) <= 1e-12, a["name"]
            assert abs((b["opt_state_gib"] - a["opt_state_gib"]) - counts / GIB) <= 1e-12
        assert a["fits"] == b["fits"], a["name"]


def test_ladder_rules():
    """``tests/test_parallel_combos.py:75-95``: the planner rejects an
    invalid combination with the trainer's message, and never recommends
    FSDP under SP or with the fused optimizer."""
    with pytest.raises(ValueError, match="fsdp does not compose"):
        tplan.plan(debug_cfg(fsdp=True, sequence_parallel=2), num_devices=8)
    for over in ({"sequence_parallel": 2}, {"fused_optimizer": "pallas"},
                 {"pipeline_parallel": 2, "pipeline_microbatches": 2}):
        rep = tplan.plan(debug_cfg(**over), num_devices=8, hbm_gb=1e-6)
        assert rep["candidates"]
        for c in rep["candidates"]:
            assert not c["knobs"]["fsdp"], (over, c["name"])
    rep = tplan.plan(debug_cfg(task="video_middle_stage2_all", fsdp_min_size=0),
                     num_devices=8, hbm_gb=1e-6)
    assert any("tower_remat" in c["name"] for c in rep["candidates"])
    rep1 = tplan.plan(debug_cfg(task="video_middle_stage1", fsdp_min_size=0), num_devices=8,
                      hbm_gb=1e-6)
    assert not any("tower_remat" in c["name"] for c in rep1["candidates"])


def test_no_file_opened_and_the_state_is_a_real_init(monkeypatch):
    """The planner opens no file (no data shard, no tower directory, no
    stage-1 file): ``open`` and the weight loaders raise while it runs; its
    meta state has a real CPU init's leaves, shapes and dtypes, the
    moments included, and its static bytes at one rank are that state's."""
    cfg = debug_cfg(tower_quant="int8", dit_quant="int8_dw", fused_optimizer="pallas",
                    optimizer_moment_bits=8, clip_config={"clip_image_size": 224, "clip_dim": 768,
                                                          "t5_dim": 4096, "model_dir": "/nowhere"})

    def refuse(*a, **k):
        raise AssertionError(f"the planner opened {a[:1]}")
    real_open = builtins.open
    for mod, name in ((registry, "load_tower"), (registry, "load_vae"),
                      (hf_io, "load_state_dict")):
        monkeypatch.setattr(mod, name, refuse)
    monkeypatch.setattr(builtins, "open", refuse)
    try:
        spec, kind, state, opt = tplan.shape_state(cfg)
        rep = tplan.plan(cfg, num_devices=1, hbm_gb=512.0)
    finally:
        monkeypatch.setattr(builtins, "open", real_open)
    assert kind == "image" and spec.tower_dir is None
    assert all(v.device.type == "meta" for v in state.trainable.values())
    real = timage.create_task_state(torch.Generator().manual_seed(0), spec, opt)
    for name in ("trainable", "frozen"):
        got, want = getattr(state, name), getattr(real, name)
        assert got.keys() == want.keys()
        for k in want:
            assert (got[k].shape, got[k].dtype) == (want[k].shape, want[k].dtype), k
    live = tplan.live_bytes(real)
    e = rep["configured"]
    assert live["trainable"] == round(e["trainable_gib"] * GIB)
    assert live["frozen"] == round(e["frozen_gib"] * GIB)
    assert live["opt_state"] == round(e["opt_state_gib"] * GIB)
    assert any(isinstance(m, Moment8) for m in real.opt_state["mu"].values())


def test_cli_json(tmp_path, capsys):
    """``genhancer-plan-torch --json`` prints the report on one line; with
    no card visible ``--hbm-gb`` must be given, and ``num_devices`` must
    come from the flag or the config."""
    from genhancer_tpu_torch.cli.plan import main
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(_raw()))
    main(["--config", str(path), "--num_devices", "4", "--hbm-gb", "16", "--json"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["num_devices"] == 4 and rep["hbm_gb"] == 16 and rep["candidates"]
    want = tplan.plan(debug_cfg(), num_devices=4, hbm_gb=16)
    assert rep["recommendation"] == want["recommendation"]
    assert abs(rep["configured"]["total_gib"] - want["configured"]["total_gib"]) <= 1e-12
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="hbm-gb"):
            main(["--config", str(path), "--num_devices", "4"])
        with pytest.raises(ValueError, match="num_devices"):
            main(["--config", str(path), "--hbm-gb", "16"])
    path2 = tmp_path / "cfg2.yaml"
    path2.write_text(yaml.safe_dump(_raw(num_devices=2)))
    main(["--config", str(path2), "--hbm-gb", "16", "--json"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["num_devices"] == 2
    assert not os.path.exists("/nonexistent-never-touched")


def test_plan_bytes_equal_the_live_ranks(tmp_path, shards):  # noqa: F811
    """On 2 gloo ranks, the planner's static bytes per rank (trainable,
    frozen, optimizer state) equal each rank's live state at its
    construction, byte for byte, under ZeRO-1, TP=2, FSDP, SP=2 and PP=2."""
    import dataclasses
    from test_torch_parallel import _ckpt_cfg, _launch
    cfg, reg = _ckpt_cfg(tmp_path, shards, "plan", max_train_steps=2)
    deep = {"dit": dataclasses.replace(reg["dit"], depth=2, depth_single_blocks=2)}
    variants = {"zero1": {},
                "tp2": {"model_parallel": 2, "shard_optimizer_state": False},
                "fsdp": {"fsdp": True, "fsdp_min_size": 0, "fused_optimizer": None},
                "sp2": {"sequence_parallel": 2},
                "pp2": {"pipeline_parallel": 2, "pipeline_microbatches": 2,
                        "__registry__": deep}}
    outs = _launch(tmp_path, "plan", {"scenario": "steps", "device": "cpu", "cfg": cfg,
                                      "registry": reg, "steps": 0, "plan": True,
                                      "variants": variants}, 2)
    for r, o in enumerate(outs):
        for name in variants:
            got = o["runs"][name]["plan"]
            assert got["plan"] == got["live"], (r, name, got)
    assert outs[0]["runs"]["tp2"]["plan"]["live"]["trainable"] < \
        outs[0]["runs"]["sp2"]["plan"]["live"]["trainable"]
