"""K8's cost per data rank under data parallelism, on one CUDA card.

The port runs K8 (``core.quant._dw``) on the rows of every data rank
(``core.quant.global_rows``), as GSPMD hands the JAX kernel the gathered
operands; before that repair each rank ran it on its own rows only.  So a
rank's K8 work and the rows it gathers grow with the data axis.  This
probe runs one step of ``configs/tpu_fast_stage1.yaml`` with ``dit_quant:
int8_dw`` at flux-dev width, the DiT cut to 1 + 1 blocks and B=4 (one data
rank of ``chip_smoke.py``'s ``phase_dp`` (b)), records the operand shapes
of every K8 call of that step, and times K8 on each call's shapes at dp x
the rank's rows for dp = 1 (the rank's own rows: the call before the
repair), 2 and 4, with CUDA events (the median of 5 rounds of 10 calls).
It prints, per step and rank, K8's time at each dp, the bytes a rank
receives in the all-gathers of g and x, and the bytes of the gradients of
the leaves whose dW every rank computes whole (``train.state``'s
``whole``: the data all-reduce that ``reduce_gradients`` leaves out) for
this cut and for the full-depth config (``train.plan.shape_state``).

    python3 scripts/torch_k8_dp_probe.py
"""
import dataclasses
import os
import statistics
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "tpu_fast_stage1.yaml")
BATCH = 4           # rows per data rank, as phase_dp (b)
DPS = (1, 2, 4)


def config(work):
    from genhancer_tpu_torch.data.testing import make_image_shard
    from genhancer_tpu_torch.train.config import load_config
    make_image_shard(os.path.join(work, "shards", "s0.tar"), 8, 256, seed=0)
    cfg = load_config(CONFIG)
    cfg["data_config"].update(img_dir=os.path.join(work, "shards"), train_batch_size=BATCH)
    cfg.update(dit_quant="int8_dw", optimizer_moment_bits=8, report_to="none",
               output_dir=os.path.join(work, "out"), log_interval=1)
    return cfg


def k8_calls(cfg):
    """One optimizer step of ``cfg`` with the DiT cut to 1 + 1 blocks:
    (the (T, O, I, out dtype, operand dtype) of every K8 call, the bytes
    of the ``whole`` leaves)."""
    from genhancer_tpu_torch import registry
    from genhancer_tpu_torch.core import quant
    from genhancer_tpu_torch.parallel.testing import run_steps
    from genhancer_tpu_torch.train.trainer import Trainer
    real_cfg, real_dw = registry.build_dit_config, quant._dw
    cut = dataclasses.replace(real_cfg("flux-dev"), depth=1, depth_single_blocks=1)
    calls = []

    def dw(g, x, out_dtype, shape=None, split=None):
        calls.append((g.numel() // g.shape[-1], g.shape[-1], x.shape[-1], out_dtype, g.dtype))
        return real_dw(g, x, out_dtype, shape, split)

    registry.build_dit_config, quant._dw = (lambda name: cut), dw
    try:
        trainer = Trainer(cfg, device="cuda")
        trainer.loader.close()
        run_steps(trainer, 1)
    finally:
        registry.build_dit_config, quant._dw = real_cfg, real_dw
    whole = sum(trainer.state.trainable[k].numel() * trainer.state.trainable[k].element_size()
                for k in trainer.state.whole)
    del trainer
    torch.cuda.empty_cache()
    return calls, whole


def full_depth_whole_bytes(cfg):
    """The bytes of the ``whole`` leaves of ``cfg`` at its own depth, from
    the shapes on the meta device."""
    from genhancer_tpu_torch.core.quant import global_dw_paths
    from genhancer_tpu_torch.train.plan import shape_state
    _, _, state, _ = shape_state(cfg)
    paths = global_dw_paths(state.trainable, cfg["dit_quant"], state.layout)
    return sum(state.trainable[k].numel() * state.trainable[k].element_size() for k in paths)


def k8_ms(t, o, i, out_dtype, dtype, calls=10, rounds=5):
    from genhancer_tpu_torch.core.kernels import int8_dw as K8
    gen = torch.Generator(device="cuda").manual_seed(t + o + i)
    g2 = torch.randn((t, o), generator=gen, device="cuda").to(dtype)
    x2 = torch.randn((t, i), generator=gen, device="cuda").to(dtype)
    for _ in range(3):
        K8.int8_dw(g2, x2, out_dtype)
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(calls):
            K8.int8_dw(g2, x2, out_dtype)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_k8_dp_probe: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    with tempfile.TemporaryDirectory(prefix="k8_dp_probe_") as work:
        cfg = config(work)
        calls, whole_cut = k8_calls(cfg)
        whole_full = full_depth_whole_bytes(cfg)
    shapes = {}
    for c in calls:
        shapes[c] = shapes.get(c, 0) + 1
    print(f"one step at B={BATCH} (the DiT cut to 1 + 1 blocks): {len(calls)} K8 calls, "
          f"{len(shapes)} shapes", flush=True)
    per_dp = {dp: 0.0 for dp in DPS}
    for (t, o, i, out_dtype, dtype), n in sorted(shapes.items(), key=lambda kv: kv[0][:3]):
        ms = {dp: k8_ms(dp * t, o, i, out_dtype, dtype) for dp in DPS}
        for dp in DPS:
            per_dp[dp] += n * ms[dp]
        print(f"  {n} x T={t} O={o} I={i} ({dtype} -> {out_dtype}): K8 ms per call "
              + ", ".join(f"dp={dp} {ms[dp]:.4f}" for dp in DPS), flush=True)
    elem = calls[0][4].itemsize if calls else 2
    for dp in DPS:
        gathered = sum((dp - 1) * t * (o + i) * elem for t, o, i, _, _ in calls)
        ring = 2 * (dp - 1) / dp
        print(f"dp={dp}: K8 per rank per step {per_dp[dp]:.4f} ms "
              f"({per_dp[dp] / per_dp[1]:.3f}x the rank's own rows); the all-gathers of g and "
              f"x bring each rank {gathered / 2**20:.1f} MiB per step; the whole leaves' "
              f"all-reduce that reduce_gradients leaves out would move "
              f"{ring * whole_cut / 2**20:.1f} MiB per rank per step at this cut (ring, leaves "
              f"{whole_cut / 2**20:.1f} MiB), "
              f"{ring * whole_full / 2**20:.1f} MiB at full depth (leaves "
              f"{whole_full / 2**20:.1f} MiB)", flush=True)


if __name__ == "__main__":
    main()
