"""The plain reference against the port at a tiny size, on the CPU: a whole
run of the harness (set-up, the checked steps, a short window, the
reference following the checked steps) in float32, where the two agree to
rounding; the same run with the timed path broken underneath, where
``correct`` must come out false; and the import rules of the benchmark."""

import ast
import pathlib

import pytest
import torch

from benchmark import faults, harness
from benchmark.tests import tiny

torch.set_num_threads(2)

ROOT = pathlib.Path(harness.__file__).resolve().parent
SEED = 2 ** 31 + 12345


def _run(cell, seed=SEED):
    return harness.run(cell, seed, 0.5, False, device="cpu", log=lambda m: None)


@pytest.mark.parametrize("mode", ["image", "video"])
def test_reference_follows_the_port(monkeypatch, mode):
    tiny.patch_registry(monkeypatch)
    res = _run(tiny.cell(mode))
    assert res["correct"], res["checks"]
    for name, c in res["checks"].items():
        assert c["value"] < c["limit"] / 10 or c["value"] == c["limit"] == 0, (name, c)
    assert ("input_rows_off" in res["checks"]) == (mode == "video")
    assert res["attempted"] > 0 and res["metrics"]["train_samples_per_s"]["value"] > 0


BROKEN = [(mode, fault) for fault in sorted(faults.FAULTS)
          for mode in faults.MODES.get(fault, ("image", "video"))]


@pytest.mark.parametrize("mode,fault", BROKEN, ids=[f"{f}-{m}" for m, f in BROKEN])
def test_a_broken_step_is_not_correct(monkeypatch, mode, fault):
    tiny.patch_registry(monkeypatch)
    faults.FAULTS[fault](monkeypatch.setattr)
    res = _run(tiny.cell(mode))
    assert not res["correct"], res["checks"]


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    forbidden = set(harness.FORBIDDEN)
    for path in ROOT.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & forbidden, (path, tops & forbidden)


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "reference").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert tops <= {"__future__", "glob", "hashlib", "io", "math", "os", "tarfile", "zlib",
                        "typing",
                        "numpy", "PIL", "torch"}, (path, tops)


def test_the_run_finds_no_jax_loaded(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "genhancer_tpu_torch_extra", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "genhancer_tpu.core", object())
    assert harness.forbidden_modules() == ["genhancer_tpu"]
