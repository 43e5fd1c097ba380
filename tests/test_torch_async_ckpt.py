"""The background checkpoint writer (``train/async_ckpt.py``) and the
trainer's use of it (``async_checkpointing``, on by default as in JAX).

The port's optimizers update parameters and moments in place, so the
snapshot ``save`` takes must be a copy made before it returns: the files a
delayed writer produces after the next step has run must still hold the
saved step — byte for byte the files of the synchronous path.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from genhancer_tpu_torch.train import async_ckpt, checkpoint as ckpt
from genhancer_tpu_torch.train.trainer import Trainer, hf_export_name

from test_torch_train_e2e import shards, tiny_models, write_cfg  # noqa: F401 (fixtures)

torch.set_num_threads(1)


def _files(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _stage2_cfg(tmp_path, shards, name, **kw):
    (tmp_path / name).mkdir()
    kw = {"checkpointing_steps": 1, **kw}
    return write_cfg(tmp_path / name, shards, task="image_stage2_all", max_train_steps=3,
                     gradient_accumulation_steps=1, output_dir=str(tmp_path / name / "out"),
                     **kw)


def test_snapshot_is_a_copy_taken_before_save_returns():
    """An in-place update after ``save`` returns, and before the writer
    runs, does not reach the written values; CPU tensors are cloned."""
    w = torch.arange(6, dtype=torch.float32)
    gate, seen = threading.Event(), {}
    ck = async_ckpt.AsyncCheckpointer()

    def write(snap):
        gate.wait(5)
        seen.update({k: v.clone() for k, v in snap["p"].items()})

    ck.save({"p": {"w": w, "head": w[:2]}, "step": 7}, write)
    w.add_(100.0)                     # the next step's in-place update
    gate.set()
    ck.close()
    assert torch.equal(seen["w"], torch.arange(6, dtype=torch.float32))
    assert torch.equal(seen["head"], torch.arange(2, dtype=torch.float32))
    assert len(ck.stalls) == len(ck.writes) == 1


def test_one_save_in_flight_and_writer_errors_surface():
    ck = async_ckpt.AsyncCheckpointer()
    order = []

    def slow(_):
        time.sleep(0.2)
        order.append("first")

    ck.save({"x": torch.zeros(1)}, slow)
    ck.save({"x": torch.zeros(1)}, lambda _: order.append("second"))
    ck.wait()
    assert order == ["first", "second"]

    def boom(_):
        raise OSError("disk full")

    ck.save({"x": torch.zeros(1)}, boom)
    with pytest.raises(OSError, match="disk full"):
        ck.save({"x": torch.zeros(1)}, lambda _: None)
    ck.save({"x": torch.zeros(1)}, boom)
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.close()
    sync = async_ckpt.AsyncCheckpointer(enabled=False)
    with pytest.raises(OSError, match="disk full"):
        sync.save({"x": torch.zeros(1)}, boom)


def test_async_files_equal_sync_files_after_the_next_step(tiny_models, shards, tmp_path,
                                                          monkeypatch):
    """Stage 2 with a checkpoint every step: the writer of each save is held
    until the trainer has run the next step (its in-place updates), yet
    every ``.bin`` and the HF export equal the synchronous run's byte for
    byte; ``train()`` returns with every file written."""
    sync = Trainer(_stage2_cfg(tmp_path, shards, "sync", async_checkpointing=False),
                   device="cpu")
    assert not sync.ckpt_writer.enabled
    sync.train()

    cfg = _stage2_cfg(tmp_path, shards, "async")
    trainer = Trainer(cfg, device="cpu")
    assert trainer.ckpt_writer.enabled          # the default, as in JAX
    write_stage1, held = ckpt.write_stage1, []

    def delayed(components, optimizer, out, step, kind):
        # wait for the next step to update the state in place (the last
        # save has no next step)
        t0 = time.time()
        while trainer.state.step <= step < 3 and time.time() - t0 < 30:
            time.sleep(0.01)
        held.append((step, trainer.state.step))
        time.sleep(0.05)
        return write_stage1(components, optimizer, out, step, kind)

    monkeypatch.setattr(ckpt, "write_stage1", delayed)
    trainer.train()
    assert [s for s, _ in held] == [1, 2, 3] == trainer.saved_steps
    assert len(trainer.ckpt_writer.stalls) == len(trainer.ckpt_writer.writes) == 3
    assert all(now > s for s, now in held[:2]), held
    ours, ref = _files(cfg["output_dir"]), _files(str(tmp_path / "sync" / "out"))
    names = sorted(ref)
    assert sorted(ours) == names
    assert any(n.endswith("pytorch_model.bin") for n in names)
    assert any(n.startswith("optimizer-state-") for n in names)
    for n in names:
        assert ours[n] == ref[n], n
    # the three steps' files differ: the snapshots are of different steps
    dits = [ours[f"checkpoint-dit-{s}.bin"] for s in (1, 2, 3)]
    assert len(set(dits)) == 3


def test_train_drains_the_writer_on_return(tiny_models, shards, tmp_path, monkeypatch):
    """A slow writer: when ``train()`` returns, the last checkpoint's files
    (components, optimizer state, export) are all on disk."""
    cfg = _stage2_cfg(tmp_path, shards, "slow", checkpointing_steps=0)
    trainer = Trainer(cfg, device="cpu")
    write_hf = ckpt.write_hf_tower

    def slow(*a, **kw):
        time.sleep(0.5)
        return write_hf(*a, **kw)

    monkeypatch.setattr(ckpt, "write_hf_tower", slow)
    metrics = trainer.train()
    assert metrics["step"] == 3 and np.isfinite(metrics["loss"])
    out = cfg["output_dir"]
    export = hf_export_name(cfg, 3)
    for name in ("checkpoint-dit-3.bin", "checkpoint-project-clip-3.bin",
                 "checkpoint-project-t5-3.bin", "optimizer-state-3.bin",
                 f"{export}/pytorch_model.bin", f"{export}/config.json"):
        assert os.path.exists(os.path.join(out, name)), name
