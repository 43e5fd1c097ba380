"""FSDP (``genhancer_tpu_torch/parallel/fsdp.py``) and its composition with
tensor parallelism against the JAX package on the CPU.

The ranks are processes of ``genhancer_tpu_torch.parallel.testing`` in a
gloo group, as in ``tests/test_torch_tp.py``; the oracle is the JAX
single-device step on the global batch with JAX's draws.  Bounds are the
data-parallel tests' (``tests/test_torch_parallel.py``): the loss within
1e-4 relative, each gradient leaf gathered to the reference layout within
1e-4 of its largest element (1e-3 for the layers fed by the sinusoids), the parameters by the sign rule; FSDP with inline
``int8_full`` at JAX's 3e-3 loss bound (``tests/test_quant_parallel.py:220``).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from genhancer_tpu_torch.parallel import testing as ptest
from genhancer_tpu_torch.weights import hf_io

from test_torch_parallel import (HYPER, LR, _check_grads, _check_params, _ckpt_cfg,
                                 _in_process, _launch, _same_across_ranks, _zero_cfg)
from test_torch_parity import f32
from test_torch_tp import _tp_step
from test_torch_train_e2e import shards  # noqa: F401 (fixture)
from test_torch_train_step import jax_init  # noqa: F401 (fixture)

torch.set_num_threads(1)


@pytest.mark.parametrize("world, tp", [(2, 1), (4, 1), (4, 2)],
                         ids=["dp2", "dp4", "dp2xtp2"])
def test_fsdp_step_matches_jax_on_the_global_batch(jax_init, tmp_path, world, tp):  # noqa: F811
    """FSDP on dp = 2 and 4 data ranks (``fsdp_min_size: 0``: every leaf
    with a dim that divides the data axis is sharded), and dp2 x tp2 with
    FSDP on four ranks, against JAX's single-device step; the ranks of one
    data index hold the same rows, and the gathered results agree rank
    for rank."""
    outs, jl, jgrads, jnew = _tp_step(jax_init, tmp_path, f"fsdp{world}x{tp}", world, tp,
                                      dict(HYPER), fsdp=True)
    _same_across_ranks(outs)
    np.testing.assert_allclose(outs[0]["loss"], jl, rtol=1e-4)
    _check_grads(outs[0]["grads"], jgrads)
    _check_params(outs[0]["params"], jnew, jgrads)
    dp = world // tp
    for r, o in enumerate(outs):
        g = o["groups"]
        assert (g["data_index"], g["model_index"]) == (r // tp, r % tp)
        assert g["data_group"] == list(range(r % tp, world, tp))
        # the projectors' weights and the DiT's img_in: FSDP blocks of dim 0
        assert o["local_shapes"]["dit.img_in.weight"] == (64 // dp, 16)


def test_fsdp_inline_int8_full_is_the_one_process_step(tmp_path):
    """FSDP on 2 data ranks (``fsdp_min_size: 0``) with inline
    ``int8_full`` (the chain: no cache) against the one-process step on the
    global batch: the loss within JAX's bound for this composition
    (``tests/test_quant_parallel.py:220``, 3e-3)."""
    import dataclasses
    from genhancer_tpu_torch.tasks import image as timage
    from test_torch_int8_step import _specs as int8_specs
    ps = dataclasses.replace(int8_specs("int8_full")[1], dit_quant_cache=False)
    payload = {"scenario": "step", "task": "image", "spec": ps, "accum": 2, "seed": 3,
               "opt_cfg": dict(HYPER),
               "state_dict": timage.init_modules(ps, torch.Generator().manual_seed(0))
               .state_dict(),
               "batch": {"image": torch.rand(2, 4, 32, 32, 3,
                                             generator=torch.Generator().manual_seed(5))}}
    outs = _launch(tmp_path, "fsdp-int8", {**payload, "fsdp": True, "fsdp_min_size": 0}, 2)
    one = ptest.scenario_step(payload)
    _same_across_ranks(outs)
    np.testing.assert_allclose(outs[0]["loss"], one["loss"], rtol=3e-3)
    assert outs[0]["local_shapes"]["dit.double_blocks.0.img_attn.qkv.weight"] == (768, 512)


# ----------------------------------------------------------- checkpoints

def _cfg(tmp_path, shards_dir, out, **over):
    """``tests/test_torch_parallel.py``'s checkpoint config (float32, K3,
    ZeRO-1, saves every 2 steps, resume from the latest) with ``over``."""
    reg = _ckpt_cfg(tmp_path, shards_dir, "unused")[1]
    base = dict(fused_optimizer="pallas", shard_optimizer_state=True, mixed_precision="no",
                checkpointing_steps=2, resume_from_checkpoint="latest",
                output_dir=str(tmp_path / out))
    return _zero_cfg(tmp_path, shards_dir, **{**base, **over}), reg


def _batches(n, rows, start=0):
    return [ptest.global_images(s, rows, 32, 1, seed=1) for s in range(start, start + n)]


MESHES = {"tp2": dict(model_parallel=2),
          "fsdp2": dict(fsdp=True, fsdp_min_size=0, fused_optimizer=None)}


@pytest.mark.parametrize("layout", sorted(MESHES))
def test_checkpoints_are_one_process_files_and_resume_across_world_sizes(
        tmp_path, shards, monkeypatch, layout):  # noqa: F811
    """A 2-rank run (TP=2, or FSDP on 2 data ranks) of the Trainer saves at
    steps 2 and 4; its step-2 files have one process's keys, shapes and
    dtypes and values (the components within 4·lr, the Adam sign rule over
    two steps); one process resumes from them and reaches the 2-rank run's
    step 4, and the 2-rank mesh resumes from one process's step-2 files and
    reaches one process's step 4 (losses 1e-4, parameters 4·lr)."""
    over = MESHES[layout]
    dp = 2 if over.get("fsdp") else 1
    cfg, reg = _cfg(tmp_path, shards, f"{layout}-w2", max_train_steps=4, **over)
    full = _launch(tmp_path, f"{layout}-w2", {"scenario": "train", "device": "cpu",
                                              "cfg": cfg, "registry": reg,
                                              "batches": _batches(4, 2 * dp)}, 2)
    assert [o["saved_steps"] for o in full] == [[2, 4], [2, 4]]
    out2 = cfg["output_dir"]

    one_cfg, _ = _cfg(tmp_path, shards, f"{layout}-w1", max_train_steps=4,
                      fused_optimizer=over.get("fused_optimizer", "pallas"))
    one = _in_process(one_cfg, reg, _batches(4, 2 * dp), monkeypatch)
    one.train()
    out1 = one_cfg["output_dir"]
    for f in ("checkpoint-dit-2.bin", "checkpoint-project-clip-2.bin",
              "checkpoint-project-t5-2.bin", "optimizer-state-2.bin"):
        a = hf_io.load_state_dict(os.path.join(out1, f))
        b = hf_io.load_state_dict(os.path.join(out2, f))
        assert a.keys() == b.keys(), f
        for k in a:
            assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), (f, k)
            if f.startswith("checkpoint-"):
                assert (a[k] - b[k]).abs().max() <= 4 * LR * (1 + 1e-3), (f, k)

    def step2_copy(src, name):
        d = tmp_path / name
        shutil.copytree(src, d)
        for f in os.listdir(d):
            if f.endswith("-4.bin"):
                os.remove(d / f)
        return str(d)

    cfg_r, _ = _cfg(tmp_path, shards, "unused", max_train_steps=4,
                    output_dir=step2_copy(out2, f"{layout}-r1"),
                    fused_optimizer=over.get("fused_optimizer", "pallas"))
    res1 = _in_process(cfg_r, reg, _batches(2, 2 * dp, 2), monkeypatch)
    assert res1.state.step == 2
    res1.train()
    np.testing.assert_allclose([h["loss"] for h in res1.history],
                               [h["loss"] for h in full[0]["history"][2:]], rtol=1e-4)
    for k, v in full[0]["params"].items():
        assert np.abs(f32(res1.state.trainable[k]) - f32(v)).max() <= 4 * LR * (1 + 1e-3), k

    cfg_r2, _ = _cfg(tmp_path, shards, "unused", max_train_steps=4,
                     output_dir=step2_copy(out1, f"{layout}-r2"), **over)
    res2 = _launch(tmp_path, f"{layout}-r2", {"scenario": "train", "device": "cpu",
                                              "cfg": cfg_r2, "registry": reg,
                                              "batches": _batches(2, 2 * dp, 2)}, 2)
    np.testing.assert_allclose([h["loss"] for h in res2[0]["history"]],
                               [h["loss"] for h in one.history[2:]], rtol=1e-4)
    for k, v in res2[0]["params"].items():
        assert np.abs(f32(v) - f32(one.state.trainable[k])).max() <= 4 * LR * (1 + 1e-3), k
