"""Run one cell of ``BENCHMARK.json`` once, in this process, on this machine's
card, and print the result as the last line of standard output.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (a short profiled stretch inside the window) and the
breakdown.  Each number that decides ``correct`` is printed beside its
limit, as the last lines of standard error and under ``checks``, the result
line's last key.

``--control <name> --seeds a,b,...`` reads the comparison's numbers of
several seeds in one process, the program run under one of the workload
file's ``controls`` (a lower-precision path of its own) or as configured
(``--control none``), with ``--fault <name>`` one of ``faults.FAULTS``
planted: the readings the limits are set from.  It prints one line per
seed and is no benchmark run.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
# every build and kernel cache at a fixed path inside the checkout; no
# library the port uses may load JAX in this process
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(HERE / ".cache" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(HERE / ".cache" / "triton"))
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def _finite(x):
    """JSON has no infinity: a reading that is not finite prints as 1e300."""
    if isinstance(x, float) and not math.isfinite(x):
        return 1e300
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def _print_checks(checks: dict) -> None:
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None)
    ap.add_argument("--seeds", default=None)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)

    import torch
    from benchmark import harness

    cell = harness.load_cell(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s), this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    seconds = cell.run_seconds if args.seconds is None else args.seconds

    if args.seeds is not None:
        from benchmark import faults
        controls = cell.workload.get("controls", {})
        control = None if args.control in (None, "none") else controls[args.control]
        if args.fault:
            faults.FAULTS[args.fault](faults.Patch())
        for s in [int(x) for x in args.seeds.split(",")]:
            t0 = time.perf_counter()
            res = harness.run(cell, s, seconds, False, control=control,
                              log=lambda m: print(m, file=sys.stderr), detail=True)
            print(json.dumps(_finite({"seed": s, "control": args.control, "fault": args.fault,
                                      "correct": res["correct"], "checks": res["checks"],
                                      "readings": res["readings"],
                                      "metrics": res["metrics"], "seconds":
                                      time.perf_counter() - t0})), flush=True)
        return 0

    res = harness.run(cell, args.seed, seconds, bool(args.trace), t_start=T_START,
                      log=lambda m: print(m, file=sys.stderr))
    found = harness.forbidden_modules()
    if found:
        print(f"no result: JAX or the JAX package was loaded in this process: {found}",
              file=sys.stderr)
        return 3
    _print_checks(res["checks"])
    sys.stderr.flush()
    print(json.dumps(_finite(res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
