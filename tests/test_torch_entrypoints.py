"""The port's entry points (``genhancer_tpu_torch/entrypoints/``) against the
JAX package's root entry points, on the CPU.

* ``evaluation/evaluate_mmvp_*.py``: each appends the same preset flags as
  its JAX file to the arguments it is given (read by running both with the
  CLI's ``main`` replaced by a recorder).
* ``trainers/train_*.py``: each passes ``--trainer`` with its JAX file's
  name; the (task, tower) both packages' ``TRAINER_COMPAT`` map it to, and
  the spec each package's ``factory.build_spec`` builds from a published
  config under that mapping, agree.
* ``train_scripts/scripts_train_*.sh``: each runs ``genhancer-train-torch``
  (``genhancer_tpu_torch.cli.train``) on its JAX script's config, one
  process per card under ``torch.distributed.run``; the scripts are
  executable and parse as bash.
"""

import dataclasses
import glob
import importlib
import os
import re
import runpy
import subprocess

import pytest

from genhancer_tpu.tasks import factory as jfactory
from genhancer_tpu.train import config as jconfig
from genhancer_tpu_torch.tasks import factory
from genhancer_tpu_torch.train.config import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "genhancer_tpu_torch", "entrypoints")


def _names(folder, ext, root=ROOT):
    return sorted(os.path.basename(p)[: -len(ext)]
                  for p in glob.glob(os.path.join(root, folder, "*" + ext))
                  if not p.endswith("__init__.py"))


EVALS = _names("evaluation", ".py")
TRAINERS = _names("trainers", ".py")
SCRIPTS = _names("train_scripts", ".sh")


def test_every_entry_point_has_its_counterpart():
    assert len(EVALS) == 6 and len(TRAINERS) == 14 and len(SCRIPTS) == 14
    for folder, names, ext in (("evaluation", EVALS, ".py"), ("trainers", TRAINERS, ".py"),
                               ("train_scripts", SCRIPTS, ".sh")):
        assert _names(folder, ext, PORT) == names, folder


def _argv_of_jax_file(path, module, monkeypatch):
    """The argv the JAX entry file hands its CLI's ``main``."""
    seen = []
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, "main", lambda argv=None: seen.append(argv))
    monkeypatch.setattr("sys.argv", [path, "--benchmark_dir", "b", "--model_dir", "m"])
    runpy.run_path(path, run_name="__main__")
    return seen[0]


@pytest.mark.parametrize("name", EVALS)
def test_eval_presets_equal_jax(name, monkeypatch):
    want = _argv_of_jax_file(os.path.join(ROOT, "evaluation", name + ".py"),
                             "genhancer_tpu.cli.evaluate", monkeypatch)
    ours = importlib.import_module(f"genhancer_tpu_torch.entrypoints.evaluation.{name}")
    seen = []
    monkeypatch.setattr("genhancer_tpu_torch.cli.evaluate.main",
                        lambda argv=None: seen.append(argv))
    ours.main(["--benchmark_dir", "b", "--model_dir", "m"])
    assert seen[0] == want
    assert ours.PRESET == want[4:]


@pytest.mark.parametrize("name", TRAINERS)
def test_trainer_names_and_specs_equal_jax(name, monkeypatch):
    want = _argv_of_jax_file(os.path.join(ROOT, "trainers", name + ".py"),
                             "genhancer_tpu.cli.train", monkeypatch)
    ours = importlib.import_module(f"genhancer_tpu_torch.entrypoints.trainers.{name}")
    seen = []
    monkeypatch.setattr("genhancer_tpu_torch.cli.train.main",
                        lambda argv=None: seen.append(argv))
    ours.main(["--benchmark_dir", "b", "--model_dir", "m"])
    assert seen[0] == want
    task, tower = factory.TRAINER_COMPAT[ours.TRAINER]
    assert (task, tower) == jfactory.TRAINER_COMPAT[want[-1]]
    # the spec of a published config of that family under the mapping
    stage = task.rsplit("_", 1)[-1] if task.startswith("image") else task.split("_")[-1]
    cfg = {"image_stage1": "MetaCLIP_large_stage1", "image_stage2_all":
           "MetaCLIP_large_stage2_all", "image_stage2_only": "MetaCLIP_large_stage2_only"}.get(
        task, "OpenAICLIP_nextpredic_" + ("stage1" if stage == "stage1" else "stage2_all"))
    # one device on both sides: the video gates count each device's tokens
    over = {"task": task, "tower": tower, "num_devices": 1}
    if tower == "siglip":
        cfg = "SigLIP_384_" + task.split("_", 1)[1]
    path = os.path.join(ROOT, "configs", cfg + ".yaml")
    ps, pkind, pckpt = factory.build_spec(load_config(path).merged_with(over))
    js, jkind, jckpt = jfactory.build_spec(jconfig.load_config(path).merged_with(over))
    assert (pkind, pckpt) == (jkind, jckpt)
    for f in ("stage", "tower_kind", "img_size", "clip_image_size", "remat", "remat_policy",
              "tower_remat", "lora_r", "lora_alpha", "lora_dropout"):
        assert getattr(ps, f) == getattr(js, f), f
    assert dataclasses.asdict(ps.dit_cfg) == dataclasses.asdict(js.dit_cfg)


@pytest.mark.parametrize("name", SCRIPTS)
def test_launch_scripts_run_the_jax_config(name):
    jax_src = open(os.path.join(ROOT, "train_scripts", name + ".sh")).read()
    path = os.path.join(PORT, "train_scripts", name + ".sh")
    src = open(path).read()
    want = re.search(r"--config (configs/\S+)", jax_src).group(1)
    assert re.search(r'--config "\$ROOT/(configs/\S+)"', src).group(1) == want
    assert os.path.exists(os.path.join(ROOT, want))
    assert "-m torch.distributed.run" in src and "-m genhancer_tpu_torch.cli.train" in src
    assert os.access(path, os.X_OK)
    subprocess.run(["bash", "-n", path], check=True)
