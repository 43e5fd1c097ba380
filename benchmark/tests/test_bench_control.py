"""On the card, at each cell's own size: the control that sets the limits'
upper readings, the program's own int8 stack (``dit_quant: int8_full``,
``tower_quant`` and ``vae_quant: int8``, as ``configs/tpu_fast_stage1.yaml``
sets them; the workload file's ``controls``), comes out not correct.  Run with
``python -m pytest -m cuda benchmark/tests/test_bench_control.py``; each case
takes a set-up, a two-second window and the reference (about a minute)."""

import sys

import pytest

from benchmark import harness

CELLS = [w["name"] for w in harness.load_manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_int8_control_is_not_correct(card, name):
    cell = harness.load_cell(name)
    res = harness.run(cell, 2 ** 31 + 901, 2.0, False, control=cell.workload["controls"]["int8"],
                      log=lambda m: print(m, file=sys.stderr))
    assert not res["correct"], res["checks"]
