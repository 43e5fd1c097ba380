"""The sharded checkpoint backend (``genhancer_tpu_torch/train/orbax_ckpt.py``,
``checkpoint_backend: orbax``) on ``torch.distributed.checkpoint``: JAX's
three ``tests/test_orbax_ckpt.py`` cases on the port's ZeRO-1, TP and FSDP
states on 2 gloo ranks, a trainer run that resumes from it to the
uninterrupted run's losses, and a control that saves a ZeRO-1 row shard as
a plain tensor and loses rows.

Bounds: every leaf and moment of each rank comes back bit for bit, on the
rank's own block; the save gathers nothing; the resumed run's losses and
parameters equal the uninterrupted run's bit for bit (the same ranks, the
same batches, the same draws).
"""

import os
import shutil

import pytest
import torch

from genhancer_tpu_torch.train import orbax_ckpt
from genhancer_tpu_torch.train.state import TrainState

from test_torch_int8_step import _specs as int8_specs
from test_torch_parallel import HYPER, _ckpt_cfg, _global_batches, _launch
from test_torch_train_e2e import shards  # noqa: F401 (fixture)
from test_torch_train_step import _specs

torch.set_num_threads(1)

# name -> (spec, optimizer config, extra payload): ZeRO-1 on the chain, TP
# on the int8 DiT with K6's 8-bit moments and K4's cache, FSDP on every leaf
KINDS = {
    "zero1": (lambda: _specs("float32")[1], dict(HYPER, shard_optimizer_state=True), {}),
    "tp": (lambda: int8_specs("int8_dw")[1],
           dict(HYPER, fused_optimizer="pallas", optimizer_moment_bits=8),
           {"model_parallel": 2, "emit_quant": True}),
    "fsdp": (lambda: _specs("float32")[1], dict(HYPER), {"fsdp": True, "fsdp_min_size": 0}),
}


@pytest.fixture(scope="module")
def dcp_runs(tmp_path_factory):
    runs = {}
    for name, (spec, opt_cfg, extra) in KINDS.items():
        tmp = tmp_path_factory.mktemp(name)
        runs[name] = _launch(tmp, name, {"scenario": "dcp", "spec": spec(), "opt_cfg": opt_cfg,
                                         "dir": str(tmp / "ckpt"), **extra}, 2)
    return runs


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_sharded_save_restore_bit_parity(dcp_runs, kind):
    """Each rank's leaves and moments come back bit for bit onto its own
    block (they differed before the restore), with the step and the
    optimizer's count; the save gathers nothing, and each rank wrote its
    own blocks."""
    outs = dcp_runs[kind]
    for r, o in enumerate(outs):
        assert all(o["equal"].values()), [k for k, v in o["equal"].items() if not v]
        assert not all(o["before"].values())
        assert (o["step"], o["count"]) == (7, 1) and o["gathers"] == []
        assert o["bytes"] > 0, r
    sharded = [k for k in outs[0]["keys"] if "@" in k]
    assert sharded and set(outs[0]["keys"]) != set(outs[1]["keys"])
    if kind == "zero1":
        assert outs[0]["rows"] and outs[0]["rows"] != outs[1]["rows"]
        assert any("@rows" in k for k in sharded)
    else:
        axis = "model" if kind == "tp" else "data"
        assert outs[0]["layout"] and all(axis in k for k in sharded)
        assert any(k.endswith(f"{axis}1of2") for k in outs[1]["keys"])
    if kind == "tp":
        assert any(k.startswith("opt/mu/") and ".q@" in k for k in sharded)   # 8-bit moments


def test_quant_cache_rebuilt_after_restore(dcp_runs):
    """The int8 SwitchBack cache is never saved: after a restore it is the
    quantization of the restored masters (on each rank's TP block)."""
    for o in dcp_runs["tp"]:
        assert o["cache_ok"] is True
        assert not any("weight_sb" in k for k in o["keys"])


def test_a_row_shard_saved_as_a_plain_tensor_loses_rows(tmp_path):
    """The control: ZeRO-1 row blocks saved under the leaf's bare key are
    taken for a replicated tensor and written once, so one rank restores
    the other's rows."""
    spec, opt_cfg, extra = KINDS["zero1"]
    outs = _launch(tmp_path, "plain", {"scenario": "dcp", "spec": spec(), "opt_cfg": opt_cfg,
                                       "dir": str(tmp_path / "ckpt"), "control": "plain_rows",
                                       **extra}, 2)
    lost = [k for o in outs for k, v in o["equal"].items() if not v]
    assert lost and all(k.startswith("opt/") for k in lost)


def _tiny_state(seed):
    gen = torch.Generator().manual_seed(seed)
    trainable = {"dit.a.weight": torch.nn.Parameter(torch.randn(16, 8, generator=gen)),
                 "dit.b.weight": torch.nn.Parameter(torch.randn(8, 8, generator=gen)
                                                    .bfloat16())}
    opt = {"count": 3, "mu": {k: torch.zeros_like(v) for k, v in trainable.items()},
           "nu": {k: torch.ones_like(v) * 0.5 for k, v in trainable.items()}}
    return TrainState(torch.nn.ModuleDict(), trainable, {}, opt, step=7)


def test_prune_keeps_newest(tmp_path):
    state = _tiny_state(0)
    for s in (1, 2, 3):
        state.step = s
        orbax_ckpt.save_sharded(state, str(tmp_path), s)
    assert orbax_ckpt.latest_step(str(tmp_path)) == 3
    assert orbax_ckpt.prune(str(tmp_path), 2) == [1]
    assert orbax_ckpt.all_steps(str(tmp_path)) == [2, 3]
    assert sorted(os.listdir(tmp_path)) == ["orbax-2", "orbax-3"]


def test_trainer_resumes_from_the_sharded_checkpoint(tmp_path, shards):  # noqa: F811
    """Two ZeRO-1 ranks of the ``Trainer`` with ``checkpoint_backend:
    orbax`` save ``orbax-2`` and ``orbax-4`` (no ``.bin`` files); a resume
    from step 2 continues to the uninterrupted run's step-3 and step-4
    losses and final state, bit for bit."""
    cfg, reg = _ckpt_cfg(tmp_path, shards, "full", max_train_steps=4,
                         checkpoint_backend="orbax")
    full = _launch(tmp_path, "full", {"scenario": "train", "device": "cpu", "cfg": cfg,
                                      "registry": reg, "batches": _global_batches(4)}, 2)
    out = cfg["output_dir"]
    assert [o["saved_steps"] for o in full] == [[2, 4], [2, 4]]
    assert orbax_ckpt.all_steps(out) == [2, 4]
    assert not [f for f in os.listdir(out) if f.endswith(".bin")]
    res_dir = tmp_path / "resumed"
    shutil.copytree(out, res_dir)
    shutil.rmtree(res_dir / "orbax-4")
    cfg_r, _ = _ckpt_cfg(tmp_path, shards, "unused", max_train_steps=4,
                         checkpoint_backend="orbax", output_dir=str(res_dir))
    res = _launch(tmp_path, "resumed", {"scenario": "train", "device": "cpu", "cfg": cfg_r,
                                        "registry": reg, "batches": _global_batches(2, 2)}, 2)
    for r in range(2):
        assert res[r]["step"] == 4 and res[r]["saved_steps"] == [4]
        assert [h["step"] for h in res[r]["history"]] == [3, 4]
        assert ([h["loss"] for h in res[r]["history"]]
                == [h["loss"] for h in full[r]["history"][2:]])
        for name in ("params", "moments"):
            for k, v in full[r][name].items():
                assert torch.equal(res[r][name][k], v), (name, k)


INT8_DW = {"dit_quant": "int8_dw", "optimizer_moment_bits": 8}


def _sp_int8_held(tmp_path):
    """The ``steps`` payload of ``configs/tpu_fast_stage1.yaml`` on 2 seq
    ranks, tiny, with the last step's SwitchBack calls held in-rank."""
    import yaml
    from genhancer_tpu_torch.data import testing as dtesting
    from test_torch_int8_step import INT8_DIT, INT8_TOWER, ROOT
    from test_torch_parity import TINY_VAE, port_cfg
    shards = tmp_path / "shards"
    dtesting.make_image_shard(str(shards / "s0.tar"), 4, 48, seed=0)
    raw = yaml.safe_load(open(f"{ROOT}/configs/tpu_fast_stage1.yaml"))
    raw.update(output_dir=str(tmp_path / "out"), report_to="none", log_interval=1,
               vae_quant_min_ch=8, mixed_precision="no", sequence_parallel=2)
    raw["data_config"].update(img_dir=str(shards), train_batch_size=2, img_size=32,
                              num_workers=1)
    raw["clip_config"].update(clip_image_size=32, clip_dim=24, t5_dim=32)
    from genhancer_tpu_torch.train.config import Config, TRAIN_DEFAULTS
    cfg = dict(Config._wrap(TRAIN_DEFAULTS).merged_with(raw))
    reg = {"dit": port_cfg(INT8_DIT), "vae": port_cfg(TINY_VAE), "tower": port_cfg(INT8_TOWER)}
    return {"scenario": "steps", "device": "cpu", "cfg": cfg, "registry": reg, "steps": 2,
            "hold_calls": True}


def test_trainer_sp_int8_held_per_call_in_rank(tmp_path):
    """``configs/tpu_fast_stage1.yaml`` (int8_full with K4's cache, and
    int8_dw with 8-bit moments) through the ``Trainer`` on 2 seq ranks,
    tiny: the last step's SwitchBack calls held in-rank against one process
    on the joined inputs (``parallel.testing.hold_switchback_calls``, what
    ``chip_smoke.py`` runs at full width), the planner's bytes equal to
    each rank's, and the sharded checkpoint's round trip (restored bit for
    bit, the next step equal to the uninterrupted run's)."""
    outs = _launch(tmp_path, "held", {
        **_sp_int8_held(tmp_path), "plan": True, "dcp": str(tmp_path / "dcp"),
        "dcp_variants": ["int8_dw"], "variants": {"int8_full": {}, "int8_dw": INT8_DW}}, 2)
    for r, o in enumerate(outs):
        for name in ("int8_full", "int8_dw"):
            run = o["runs"][name]
            h = run["held"]
            assert h["calls"] > 0 and h["codes_equal"] == h["calls"], (r, name, h)
            assert max(h["worst"].values()) <= 1e-5, (r, name, h)
            assert h["splits"] == ["tokens", "vector"]
            assert run["plan"]["plan"] == run["plan"]["live"], (r, name)
            assert len(run["loss"]) == 2 and run["loss"] == outs[0]["runs"][name]["loss"]
        d = o["runs"]["int8_dw"]["dcp"]
        assert d["restored_equal"] and d["next_equal"] and d["cache_equal"], (r, d)
        assert d["equal_before"] < d["keys"] and d["bytes"] >= 0


def test_trainer_sp_int8_dw_held_k8_rows_catch_pad_rows(tmp_path):
    """The held check of K8's operands is not the step's own gather: with
    the chunks' pad rows left in K8's rows (the ``keep_pad`` fault, planted
    in the step), the rows K8 received differ from one process's rows
    (built from each rank's real tokens) on the calls whose chunks differ
    in length, so fewer calls than all hold their codes."""
    outs = _launch(tmp_path, "held-pad", {**_sp_int8_held(tmp_path), "control": "keep_pad",
                                          "variants": {"int8_dw": INT8_DW}}, 2)
    for r, o in enumerate(outs):
        h = o["runs"]["int8_dw"]["held"]
        assert 0 < h["codes_equal"] < h["calls"], (r, h)
