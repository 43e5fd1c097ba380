"""Serving at B=1 on one CUDA card: the host time to enqueue one K1 call
(B=1, L=197, H=24, D=128 bf16, 1000 calls without a sync), the wall time
of 10 reconstruct requests of the full-width engine
(configs/MetaCLIP_large_stage1.yaml, 20 Euler steps, random weights), and
K1's device time per request under torch.profiler (2 requests).

It imports ``genhancer_tpu_torch`` from the working directory, so two
checkouts compare in turns, each in a fresh process:

    cd <checkout> && python3 <this repo>/scripts/torch_serve_b1_probe.py
"""
import os
import statistics
import sys
import time

sys.path.insert(0, os.getcwd())
import numpy as np  # noqa: E402
import torch  # noqa: E402

from genhancer_tpu_torch.core.kernels import short_attention as K  # noqa: E402
from genhancer_tpu_torch.core.rope import multi_axis_rope  # noqa: E402
from genhancer_tpu_torch.serve.engine import InferenceEngine  # noqa: E402

g = torch.Generator(device="cuda").manual_seed(0)
q, k, v = (torch.randn((1, 197, 24, 128), generator=g, device="cuda").to(torch.bfloat16)
           for _ in range(3))
ids = torch.randint(0, 16, (1, 197, 3), generator=g, device="cuda").float()
cos, sin = multi_axis_rope(ids, (16, 56, 56), 10_000)
with torch.inference_mode():
    for _ in range(50):
        K.fused_rope_attention(q, k, v, cos, sin)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        K.fused_rope_attention(q, k, v, cos, sin)
    host = (time.perf_counter() - t0) / 1000 * 1e6
    torch.cuda.synchronize()
print(f"K1 B=1 L=197: host enqueue {host:.1f} us per call", flush=True)

engine = InferenceEngine.from_config("configs/MetaCLIP_large_stage1.yaml", device="cuda",
                                     buckets=(1,), num_steps=20, wire_dtype="uint8")
engine.warmup()
rng = np.random.default_rng(0)
img = (rng.random((1, 224, 224, 3)) * 255).astype(np.uint8)
for r in range(2):
    engine.reconstruct(img, seed=r)
torch.cuda.synchronize()
walls = []
for r in range(10):
    t0 = time.perf_counter()
    engine.reconstruct(img, seed=r)
    walls.append((time.perf_counter() - t0) * 1e3)
print("reconstruct B=1 ms: median %.1f, runs %s" % (statistics.median(walls),
                                                   [round(w, 1) for w in walls]), flush=True)
from torch.profiler import ProfilerActivity, profile  # noqa: E402
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in range(2):
        engine.reconstruct(img, seed=r)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 2 * 1e3
k1 = 0.0
for evt in prof.key_averages():     # K1's kernels, by name, on either tree
    us = getattr(evt, "self_device_time_total", None)
    us = evt.self_cuda_time_total if us is None else us
    if us > 0 and any(p in evt.key for p in ("short_fwd_kernel", "rope_qk", "tc::kernel")):
        k1 += us
print(f"profiled: wall {wall:.1f} ms per request, K1 device time {k1 / 2 / 1e3:.2f} ms",
      flush=True)
