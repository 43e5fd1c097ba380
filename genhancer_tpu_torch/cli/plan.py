"""Planning CLI: shape-only memory and parallelism preflight.

Port of ``genhancer_tpu/cli/plan.py`` with the same flags::

    genhancer-plan-torch --config configs/tpu_fast_video_stage2_all.yaml \
        --num_devices 8 --hbm-gb 80 [--json]

It builds the task state on the meta device (no weights, no data, no card:
it runs anywhere), applies the trainer's placement rules and prints each
rank's residency and the cheapest knob escalation that fits
(``train.plan``).  ``--hbm-gb`` defaults to the visible card's memory and
must be given where none is visible; ``--num_devices`` defaults to the
config's ``num_devices``, else to the visible cards, and raises with
neither.
"""

from __future__ import annotations

import argparse
import json


def _fmt(e: dict) -> str:
    k = e["knobs"]
    knobs = ", ".join(f"{n}={v}" for n, v in k.items() if v not in (False, 1))
    return (f"  {e['name']:<42} dp{e['dp']}xtp{e['tp']}  "
            f"params {e['trainable_gib'] + e['frozen_gib']:6.2f}  "
            f"opt {e['opt_state_gib']:5.2f}  grads {e['grads_gib']:5.2f}  "
            f"act~{e['activations_gib_est']:5.2f}  "
            f"total {e['total_gib']:6.2f} GiB  "
            f"{'FITS' if e['fits'] else 'OOM '}"
            + (f"  [{knobs}]" if knobs else ""))


def card_gib() -> float:
    """The visible card's memory in GiB; raises where no card is visible."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("--hbm-gb: no CUDA card is visible to read; give the per-card "
                         "memory budget in GiB")
    return torch.cuda.get_device_properties(0).total_memory / 1024.0 ** 3


def main(argv=None):
    parser = argparse.ArgumentParser(description="genhancer memory planner (PyTorch port)")
    parser.add_argument("--config", required=True)
    parser.add_argument("--num_devices", type=int, default=None,
                        help="cards to plan for (default: the config's, else the visible)")
    parser.add_argument("--hbm-gb", type=float, default=None,
                        help="per-card memory budget in GiB (default: the visible card's)")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable single-line output")
    args = parser.parse_args(argv)

    from ..train.config import load_config
    from ..train.plan import plan

    cfg = load_config(args.config)
    hbm = args.hbm_gb if args.hbm_gb is not None else card_gib()
    report = plan(cfg, num_devices=args.num_devices, hbm_gb=hbm)

    if args.json:
        print(json.dumps(report))
        return report

    print(f"task {report['task']}  devices {report['num_devices']}  "
          f"budget {report['hbm_gb']} GiB/card")
    for e in report["candidates"]:
        print(_fmt(e))
    print(f"activation note: {report['configured']['activation_note']}")
    print(f"recommendation: {report['recommendation']}")
    return report


def cli() -> None:
    main()


if __name__ == "__main__":
    cli()
