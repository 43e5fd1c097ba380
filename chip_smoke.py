#!/usr/bin/env python3
"""Smoke run of the PyTorch port (genhancer_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device  — the card's name and ``nvidia-smi`` name/power limit; no CUDA
             device means exit 1 at once;
2. build   — nvcc builds csrc/short_attention.cu, csrc/flash_attention.cu,
             csrc/adamw.cu, csrc/rowquant.cu and csrc/int8_dw.cu (sm_90a)
             from the checkout, one process per source, started together;
3. kernels — K1/K2 (fused attention forward: in bf16 K1's RoPE pass and
             the wgmma/TMA forward, o's rounding point against a control
             that rounds p before normalising it, the device time of 64-
             and 128-row blocks from CUDA graphs, a misaligned view and
             float16 that must raise), K1b/K2b (backward on the wgmma/TMA
             kernels; their dq/dk/dv rounding points against a control that
             keeps p in float32 for dv; K2b at L=257, L=256 and, B=32,
             CLIP-L/14@336's L=577), K2 in float32 at the MMVP-VLM eval's
             B=50, L=257 and L=577 (the split-TF32 wgmma body: max error
             1e-4 and mean error 1e-5 against exact float32, with controls
             that drop a TF32 product and must miss it; timed against SDPA
             float32 and its bound at 495 TFLOP/s TF32), K1/K2/K5 in
             float32 at D = 8, 72, 128 and L = 1, 65, 129, K5/K5b
             (flash attention forward and backward: in bf16 the wgmma/TMA
             kernels, at the video paths' shapes with their TFLOP/s and
             share of the bf16 peak, the SigLIP tower shape, ragged lengths,
             strided views, a misaligned view that must raise, and float32), K3
             (fused AdamW), and the int8 stack's K7 (row quantization: each
             of its bodies bit for bit, ragged, misaligned and half-way
             rows, four shapes timed, the host's enqueue time per call), K8
             (per-block int8 dW: its K-major quantization workspace bit for
             bit, the count of dW elements off the plain version, and two
             yardsticks, torch._int_mm on the same codes and the bf16 dW), K4
             (AdamW with the int8 weight emission) and K6 (AdamW on 8-bit
             moments, both bodies; its register path and its second path
             timed in turns) against their plain PyTorch versions at the
             paths' shapes (K7 also at the static DiT base's and QLoRA's
             widths 64-3072, T = 16 and 3136, bit for bit and timed), with
             kernel, plain and library-call times and
             each kernel's bound (bytes at 3.35 TB/s or operations at 989
             TFLOP/s bf16 / 495 TFLOP/s TF32 / 1,979 TOPS int8); then K1/K1b
             at the SigLIP-384 joint L=577 and K5/K5b at the so400m tower's
             [16, 729, 16, 72], bf16, checked and timed (call, device, bound,
             SDPA);
4. small   — a tiny engine on the card (kernels) against the same weights on
             the CPU (plain versions), then one tiny float32 training step
             of each optimizer, card against CPU: loss, gradients, params;
             then the same for one tiny float32 sliding-window video step
             whose joint length (637) runs K5/K5b, for one tiny float32
             image stage-2 step of each stage (LoRA with a planted nonzero
             B, dropout on injected masks: K2b), for one tiny float32 video
             middle stage2_all step with tower_remat on (the recompute reads
             the injected masks again: K2 twice, K2b once), for a tiny
             MMVP-VLM eval (a tiny CLIPModel, a toy tokenizer: the whole
             result and the embeddings), for one tiny float32 SigLIP stage-1
             and stage2_all step (tower L=625, D=72: K5, K5b) and a tiny
             SigLIP eval (K5; K2 on its 64-token text side), and for one tiny
             float32 int8 step
             of each int8 configuration (int8_full with the cache K4 emits;
             int8_dw with 8-bit moments: K8, K6), and one tiny float32 QLoRA
             step of stage2_all (int8_full, K4's cache) and of stage2_only
             (the static DiT base) on latent-cache batches, each int8 base
             and SwitchBack call held against the CPU's plain path at 1e-5;
             a tiny int8 engine (``quant="int8"``: every int8 linear and VAE
             conv call of a reconstruct and an embed held at 1e-5 against
             the CPU's plain path on its input, codes +-1 below 5e-3, the
             layer set exactly, a control left in float); the extra models
             card against CPU in float32 at 1e-5 (a ControlNet reconstruct
             with planted projections and its CFG sampler, a DiT forward with
             IP k/v in both block kinds, also in bf16 at 1e-4, T5 with and
             without a padding mask, ``prepare`` and ``denoise_euler_cfg``);
5. server  — ``InferenceEngine.from_config(configs/MetaCLIP_large_stage1.yaml)``
             at full width (flux-dev DiT, MetaCLIP-L/14 tower, FLUX VAE;
             random weights from the config's seed), warmup, real HTTP
             requests to /v1/reconstruct and /v1/embed through ServeApp,
             launch counters checked against the batches served, then
             per-bucket images/s; then the same engine with
             ``quant="int8"`` (42 DiT and 145 tower linears on K7 +
             ``_int_mm``, the VAE's >= 256-channel convs): K7/K1/K2 launches
             of a reconstruct and an embed against the layer set, K7 kernels
             of one reconstruct counted by torch.profiler, reconstruct and
             embed per bucket beside the bf16 engine's; then the extra
             models at full width: a depth-2 ControlNet seeded from the
             flux-dev DiT (reconstruct B=4, 20 steps), an IP-Adapter DiT
             forward at B=4, the T5-XXL encoder in bf16 at L=512, B=2
             (initialised on the card) with the CLIP text pooled vector, and
             a 20-step CFG sample on them at joint L=708 (K5), each with its
             time, peak memory and K1/K2/K5 launches held to the models';
6. train   — the port's ``Trainer`` on the same config at full width
             (B=16 x accumulation 2, bf16) on synthetic shards, 8 optimizer
             steps with the default AdamW chain and 8 with
             ``fused_optimizer: pallas`` (K3); launch counts per step,
             checkpoints, a resume from step 8, and an engine serving from
             the written components;
6b. dp    — data parallelism and ZeRO-1 (``parallel/mesh.py``): (a) the
             ``Trainer`` on the same config with ``shard_optimizer_state``
             as one torchrun-style rank over NCCL (world size 1; its
             collectives run) in a subprocess, 8 steps on the batches the
             K3 run read: losses and parameters equal the K3 run's bit for
             bit, K3 112 launches per step, step time and peak memory; (b),
             at once with (a), two gloo ranks sharing the card (both
             ``LOCAL_RANK=0``), configs/tpu_fast_stage1.yaml's settings with
             the DiT cut to 1 + 1 blocks, B=4 per rank, 2 steps of
             ``int8_full`` (K4) and of ``int8_dw`` + 8-bit moments (K6), one
             launch each, at once, each replicated and with
             ``shard_optimizer_state``: ZeRO-1 equal to replicated and the
             ranks equal bit for bit (parameters and int8 caches after
             every step, gathered moments), the loss within 3e-3 of one
             process on the global batch, each rank's moment bytes its row
             ranges', K3/K4/K6 once per leaf per rank per step, the
             host-staged step time; K3/K4/K6 on row ranges at unaligned
             offsets against the whole-leaf update bit for bit; the time to
             draw the global batch's LoRA masks at 1, 2 and 4 ranks;
6c. tp_fsdp — tensor parallelism and FSDP (``parallel/{tp,fsdp,layout}.py``)
             on gloo ranks sharing the card (NCCL refuses two ranks on one
             device), in two waves of launches that run at once: (a)
             ``model_parallel: 2`` on the same config at full width with K3,
             3 steps on the K3 run's batches, the loss within 1e-2 of the
             K3 run's, each rank's parameter, frozen and moment bytes those
             of its blocks' shapes, K1/K1b on 12 heads, K3 once per local
             leaf, the checkpoint loaded strictly in one process; (b)
             ``fsdp: true`` on two data ranks (B=8 each), the chain, the DiT
             cut to 1 + 1 blocks, 3 steps on the chain run's batches against
             one process on them, each rank's
             bytes its blocks'; (c) configs/tpu_fast_stage1.yaml's settings
             under TP=2 with the DiT cut to 1 + 1 blocks, B=4, 3 steps: each
             DiT linear kind through SwitchBack at flux-dev width within
             1e-5 of one process with the cache bit for bit, the loss within
             3e-3 of one process, the gathered int8 cache bit for bit the
             quantization of the gathered masters; (d) dp2 x tp2 with FSDP
             on four ranks, 1 + 1 blocks, B=4 per data index, 2 steps
             against one process, beside sp_pp's (b); each rank's groups and
             the host-staged step time;
7. stage2  — the ``Trainer`` on configs/MetaCLIP_large_stage2_all.yaml at full
             width (LoRA on the whole MetaCLIP-L/14, B=16 x accumulation 2)
             from the K3 run's step-10 files (``load_dir``/``load_step``): 7
             steps, 3-6 timed and 7 under torch.profiler (K2b's device time,
             the busy share), K2b's first call in the step held against its
             plain version, the HF export at the end timed and read back by
             ``registry.load_tower`` to the merged tower's class tokens bit
             for bit; then ``stage2_only`` with ``fused_optimizer: pallas``
             (K3 over the 652 LoRA leaves) for 4 steps; K2b 48 launches per
             optimizer step on both and 0 on every other path;
8. int8    — the ``Trainer`` on configs/tpu_fast_stage1.yaml at full width
             (B=32, int8 tower and VAE encoder, ``dit_quant: int8_full``,
             ``fused_optimizer: pallas``): 8 steps, a resume for steps 9-10
             whose rebuilt int8 cache must equal the one K4 emitted, launch
             counts of every kernel against counts derived from the model;
             then ``dit_quant: int8_dw`` + ``optimizer_moment_bits: 8`` for 5
             steps (K8, K6's two bodies): steps 2-3 timed, 4-5 under
             torch.profiler for the device time by kernel; then the fast
             stage-2 path: ``genhancer-precompute-torch --mode latents
             --augment train --variants 2`` over the int8 run's shards
             (images/s, bytes, a sample's moments against the trainer's own
             encode), configs/tpu_fast_stage2_all.yaml (QLoRA tower,
             int8_full DiT with K4's cache) from the int8_full run's step-10
             files on that cache, 5 steps with background saves at 3 and 5
             (the loop's stall, the writer's seconds, steps 3-4 timed, 5
             profiled, the export read back bit for bit), and
             configs/tpu_fast_stage2_only.yaml (the static int8 DiT base) 4
             steps and a resume whose re-derived int8 factors equal those of
             the load; launch counts of every kernel from the model;
9. video   — the ``Trainer`` on configs/OpenAICLIP_224_sliding_stage1.yaml at
             full width and published batch (2 videos x 8 windows x
             accumulation 2) on synthetic video shards of 256-px JPEGs, some
             videos short enough to leave padded rows: 8 optimizer steps
             with the default chain, a checkpoint at step 8, a resume from
             step 8 that loads the four video ``.bin`` files strictly and
             runs steps 9-10; then next@224, next2@224 and middle@336 (remat
             from the gate; these three and their stage 2 with the DiT cut
             to 1 + 1 blocks) 3 optimizer steps each at their published batch
             (32 x accumulation 2); step time (sliding: steps 3-8, the others
             step 2), rows/s (sliding: valid rows, padding left out), peak
             memory, the launch counts of every kernel, per mode, and device
             time by kernel (K5/K5b's share) in each mode's last step (the
             sliding resume's step 10), run under torch.profiler;
10. video2 — the ``Trainer`` on the four published video stage-2 configs
             (``configs/OpenAICLIP_*_stage2_all.yaml``: LoRA on all 218
             linears of OpenAI CLIP-L/14, the gates' DiT remat and
             tower_remat) at full width and batch x accumulation 2, each
             from its own mode's stage-1 files: 3 steps, 2 timed, 3
             profiled, K2b's first call held against its plain version, the
             export timed and read back; middle@336's peak memory of one step
             with tower_remat on and off; a resume of next; K2b 48 launches per
             optimizer step on every stage-2 path (24 on the fast ones), 0
             elsewhere; then configs/tpu_fast_video_stage2_all.yaml
             (middle@336 at B=4, QLoRA tower, int8_full DiT under remat)
             from middle@336's stage-1 files, 4 steps, 2-3 timed, 4
             profiled, the export read back;
10b. sp_pp — sequence and pipeline parallelism on gloo ranks sharing the
             card (host-staged; says nothing of NCCL): (a) SP=2 on the
             sliding@224 stage-1 config at full width, depth and published
             batch (joint L=964, 482 tokens per rank), 3 steps on the
             sliding run's batches, losses within 1e-2 of that run, K2 48
             per rank per step and no K1/K5, then ring attention at [16,
             964, 24, 128] bf16 against ``sdpa_ref`` at 3e-2; (b) PP=2 with
             2 micro-batches on configs/MetaCLIP_large_stage1.yaml with K3,
             3 steps on the K3 run's batches (launched beside tp_fsdp's
             (d)), losses within 1e-2, per rank per step K1/K1b 12, K2 48,
             K3 112; each rank's peak memory against the bytes its shapes
             give;
11. siglip — the SigLIP-384 paths at full width (so400m: 27 layers, L=729,
             D=72; the flux-dev DiT cut to 1 + 1 blocks at joint L=577;
             B=16 x accumulation 2, bf16) on synthetic 384-px shards: the ``Trainer`` on
             configs/SigLIP_384_stage1.yaml 8 steps (8 profiled), an engine
             on its files (reconstruct B=1, embed [1, 1152]),
             SigLIP_384_stage2_all.yaml 5 steps (K5b's first call held to its
             plain version, the ``siglip-so400m-patch14-384-5/`` export timed
             and read back bit for bit), SigLIP_384_stage2_only.yaml with
             ``fused_optimizer: pallas`` 3 steps; per step K5 54, K5b 54 in
             stage 2, K1 and K1b once per DiT block and micro-batch, K2 and
             K2b 0;
12. eval   — ``evaluate_model_dir`` on image stage 2's export
             (MetaCLIP-L/14, 224 px), on middle@336 stage 2's
             (CLIP-L/14@336) and on SigLIP stage2_all's (so400m, 384 px: K5
             and, on the text side, K2 in float32): a synthetic MMVP-VLM tree
             of 9 x 15 pairs and a toy tokenizer (the card has no
             ``transformers``), seconds, images/s and texts/s, nine
             categories, 135 CSV rows, scores in [0, 100], the first pair's
             embeddings against the CPU's plain path at 1e-4.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import zlib

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "MetaCLIP_large_stage1.yaml")
INT8_CONFIG = os.path.join(ROOT, "configs", "tpu_fast_stage1.yaml")
SOURCES = {"short_attention": "genhancer_tpu_torch/csrc/short_attention.cu",
           "flash_attention": "genhancer_tpu_torch/csrc/flash_attention.cu",
           "adamw": "genhancer_tpu_torch/csrc/adamw.cu",
           "rowquant": "genhancer_tpu_torch/csrc/rowquant.cu",
           "int8_dw": "genhancer_tpu_torch/csrc/int8_dw.cu"}
VIDEO_CONFIGS = {"sliding": "OpenAICLIP_224_sliding_stage1.yaml",
                 "next": "OpenAICLIP_nextpredic_stage1.yaml",
                 "next2": "OpenAICLIP_use2frames_stage1.yaml",
                 "middle": "OpenAICLIP_336_video_stage1.yaml"}
# kernel (LAUNCHES key) -> (ID, source library, the Pallas body it replaces)
KERNELS = {
    "fused_rope_attention": ("K1", "short_attention",
                             "genhancer_tpu/core/pallas/short_attention.py:76"),
    "fused_attention": ("K2", "short_attention",
                        "genhancer_tpu/core/pallas/short_attention.py:84"),
    "fused_rope_attention_bwd": ("K1b", "short_attention",
                                 "genhancer_tpu/core/pallas/short_attention.py:112"),
    "fused_attention_bwd": ("K2b", "short_attention",
                            "genhancer_tpu/core/pallas/short_attention.py:125"),
    "fused_adamw": ("K3", "adamw", "genhancer_tpu/core/pallas/adamw.py:147"),
    "flash_attention": ("K5", "flash_attention",
                        "genhancer_tpu/core/pallas/flash_attention.py:55"),
    "flash_attention_bwd": ("K5b", "flash_attention",
                            "genhancer_tpu/core/pallas/flash_attention.py:156"),
    "fused_adamw_quant": ("K4", "adamw", "genhancer_tpu/core/pallas/adamw.py:163"),
    # K6's two bodies are one record; its launches count both
    "fused_adamw8": ("K6", "adamw", "genhancer_tpu/core/pallas/adamw.py:120"),
    "rowquant": ("K7", "rowquant", "genhancer_tpu/core/pallas/rowquant.py:37"),
    "int8_dw": ("K8", "int8_dw", "genhancer_tpu/core/pallas/int8_dw.py:53"),
}
# the path whose launches a kernel's record reports (the others: train_pallas)
MAIN_PATH = {"flash_attention": "video_sliding", "flash_attention_bwd": "video_sliding",
             "fused_attention_bwd": "train_stage2_all",
             "fused_adamw_quant": "train_int8", "rowquant": "train_int8",
             "fused_adamw8": "train_int8_dw", "int8_dw": "train_int8_dw"}
REQUIRED_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                 "plain_ms", "bound_ms", "bound_by", "library_ms")
BOUND = {"bfloat16": 2e-2, "float32": 1e-4}
# K5/K5b's bf16 rounding points, as mean|kernel - plain| / mean|plain| of o
# and of dv: rounding p at another point moves about half the outputs by one
# bf16 ulp (about 2e-3 of the mean), which the max-based bound above cannot see
ROUNDING_BOUND = 2e-4
HBM_PEAK = 3.35e12   # bytes/s, H100 SXM data sheet
BF16_PEAK = 989e12   # dense bf16 tensor-core FLOP/s, H100 SXM data sheet
INT8_PEAK = 1979e12  # dense int8 tensor-core OP/s, H100 SXM data sheet
FP32_PEAK = 67e12    # float32 FLOP/s outside the tensor cores, H100 SXM data sheet
TF32_PEAK = 495e12   # dense TF32 tensor-core FLOP/s, H100 SXM data sheet
# the float32 forward (split TF32, three products per product) against exact
# float32, as mean|kernel - plain| / mean|plain|: dropping one TF32 product
# moves it to ~2e-4, which the max bound above cannot see
TF32_MEAN_BOUND = 1e-5
# the controls: the plain emulation of the split with products left out
# (short_attention.split_tf32_attention_ref's (qk, pv) terms); at L = 1,
# p = 1 and o = v, so only the one-product control can show there
TF32_CONTROLS = {"one product": (("hh",), ("hh",)),
                 "Q K^T without hi lo": (("hh", "lh"), ("hh", "hl", "lh")),
                 "P V without lo hi": (("hh", "hl", "lh"), ("hh", "hl"))}
NUM_STEPS = 20
VIDEO2_CONFIGS = {"sliding": "OpenAICLIP_224_sliding_stage2_all.yaml",
                  "next": "OpenAICLIP_nextpredic_stage2_all.yaml",
                  "next2": "OpenAICLIP_use2frames_stage2_all.yaml",
                  "middle": "OpenAICLIP_336_video_stage2_all.yaml"}
# optimizer steps of the stage-2 Trainer runs (phase_stage2_train,
# phase_video_stage2): K2b launches 48 times in each
STAGE2_STEPS = {"train_stage2_all": 7, "train_stage2_only": 4,
                **{f"video_{m}_stage2": 3 for m in VIDEO2_CONFIGS}}
EVAL_PAIRS = 15      # pairs per category: MMVP-VLM's 9 x 15 pairs, 270 images
BUCKETS = (1, 4, 8)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


FAILURES = []


def attempt(phase, *args):
    """Run a phase; a failed check is recorded and the run goes on to the
    phases that do not depend on it (every failure shows in one run; the
    script still exits non-zero).  Crashes propagate."""
    t0 = time.perf_counter()
    try:
        return phase(*args)
    except SmokeFailure as e:
        print(f"FAIL [{phase.__name__}]: {e}", flush=True)
        FAILURES.append(f"{phase.__name__}: {e}")
        return None
    finally:
        print(f"[time] {phase.__name__} {time.perf_counter() - t0:.1f} s; {_host_memory()}",
              flush=True)


def _meminfo_gib(key: str) -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) / 2**20
    return float("nan")


def _host_memory() -> str:
    """The host's available memory and this process's resident size."""
    import resource
    return (f"host MemAvailable {_meminfo_gib('MemAvailable'):.1f} of "
            f"{_meminfo_gib('MemTotal'):.1f} GiB (Shmem {_meminfo_gib('Shmem'):.1f}), "
            f"this process's max RSS "
            f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.1f} GiB")


# ---------------------------------------------------------------- phases

def phase_device():
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this smoke run needs a CUDA card",
              flush=True)
        sys.exit(1)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{name}; device_count {torch.cuda.device_count()}")
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else
          f"nvidia-smi: rc {smi.returncode} {smi.stderr.strip()}")
    return name


def phase_build():
    """One nvcc per kernel source, all started together."""
    sys.path.insert(0, ROOT)
    from genhancer_tpu_torch.core.kernels import _build
    t0 = time.perf_counter()
    _build.load_all(list(SOURCES))
    secs = time.perf_counter() - t0
    for name in SOURCES:
        log = _build.BUILD_LOG.get(name)
        print(f"[build] {name}.cu -> {_build.library_path(name).name}"
              + (f" in {log[0]:.2f} s" if log else " (already built in this checkout)"))
        for line in (log[1].splitlines() if log else ()):
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build]   {line.strip()}")
    print(f"[build] all sources in {secs:.2f} s (wall)")
    return secs


def _rand(gen, shape, dtype):
    import torch
    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)


def _tables(gen, b, l, d):
    import torch
    from genhancer_tpu_torch.core.rope import multi_axis_rope
    ids = torch.randint(0, 16, (b, l, 3), generator=gen, device="cuda").to(torch.float32)
    return multi_axis_rope(ids, (16, 56, 56), 10_000)     # flux-dev axes, D = 128


def _median_ms(fn, n: int) -> float:
    import torch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, n: int = 20, rounds: int = 4):
    """Device ms per call of ``fn``: n calls captured in one CUDA graph and
    the graph replayed, so the host's launch work (Python, ctypes, checks)
    drops out; the median of ``rounds`` timed replays.  None where two
    captures of the call fail."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    stream = torch.cuda.current_stream()
    for attempt in range(2):   # a first capture of autograd's backward may fail once
        graph, pool = torch.cuda.CUDAGraph(), torch.cuda.graph_pool_handle()
        try:
            with torch.cuda.graph(graph, pool=pool):
                for _ in range(n):
                    fn()
            break
        except RuntimeError as e:
            # a capture that fails inside leaves the caching allocator
            # capturing into the graph's pool (every later free deferred, so
            # the process keeps all it ever allocated) and the capture stream
            # current: end the pool's capture, release it, restore the stream
            dev = torch.cuda.current_device()
            torch._C._cuda_endAllocateToPool(dev, pool)
            torch._C._cuda_releasePool(dev, pool)
            torch.cuda.set_stream(stream)
            print(f"[kernels] CUDA graph capture {attempt + 1} of 2 failed ({str(e)[:80]})")
    else:
        return None
    graph.replay()
    return statistics.median(_median_ms(graph.replay, 5) for _ in range(rounds)) / n


def profiled_ms(fn, n: int = 10) -> float:
    """Device ms per call of ``fn`` as the sum of its kernels' times under
    torch.profiler (no gaps between them), after a warmup: for a call that a
    CUDA graph cannot capture (PyTorch's default SDPA backward at some shapes
    touches the legacy stream during a capture)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / n / 1e3


def _fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def kernel_vs_plain_ms(kfn, pfn, n: int = 50, rounds: int = 6):
    """Median per-call ms of kernel and plain version, timed in turns
    (plain, kernel, kernel, plain, ...) after a warmup."""
    for fn in (kfn, pfn):
        for _ in range(3):
            fn()
    ks, ps = [], []
    for r in range(rounds):
        order = ((pfn, ps), (kfn, ks)) if r % 2 == 0 else ((kfn, ks), (pfn, ps))
        for fn, acc in order:
            acc.append(_median_ms(fn, n))
    return statistics.median(ks), statistics.median(ps)


def _round_before_normalise(q, k, v):
    """The control for the forward's rounding point: exp(s - max) rounded to
    v's dtype before the float32 PV product and divided by the row sum after
    it, where K1/K2/K5 and the TPU kernels normalise p first."""
    import torch
    s = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) / q.shape[-1] ** 0.5
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bhlm,bmhd->blhd", e.to(v.dtype).float(), v.float())
    return (o / e.sum(dim=-1).permute(0, 2, 1)[..., None]).to(q.dtype)


def _tf32_mean_check(tag, out, ref, q, k, v):
    """The float32 forward's split-TF32 products on their own: mean|out -
    ref| / mean|ref| (ref exact float32, TF32 off) within TF32_MEAN_BOUND,
    and each control of TF32_CONTROLS (the plain emulation on the same q, k,
    v, which K1 has already rotated) above it.  Returns (mean error,
    {control: mean error}) and prints them."""
    import torch
    from genhancer_tpu_torch.core.kernels import short_attention as K
    torch.backends.cuda.matmul.allow_tf32 = False      # exact float32 einsums
    torch.backends.cudnn.allow_tf32 = False
    mean = _mean_rel(out, ref)
    names = TF32_CONTROLS if q.shape[1] > 1 else ["one product"]
    ctl = {n: _mean_rel(K.split_tf32_attention_ref(q, k, v, *TF32_CONTROLS[n]), ref)
           for n in names}
    print(f"[kernels] {tag} float32: mean|kernel-plain|/mean|plain| {mean:.3e} (bound "
          f"{TF32_MEAN_BOUND:.0e}); controls " + ", ".join(f"{n} {x:.3e}" for n, x in ctl.items()),
          flush=True)
    check(mean <= TF32_MEAN_BOUND, f"{tag} float32: mean error {mean} > {TF32_MEAN_BOUND}")
    check(min(ctl.values()) > TF32_MEAN_BOUND, f"{tag} float32: a control passes the mean "
          f"bound ({ctl}), so it cannot tell a dropped TF32 product")
    return mean, ctl


def phase_kernels():
    """K1/K2 against their plain versions, o's rounding point on its own
    (ROUNDING_BOUND, with the round-before-normalise control that must miss
    it), the bf16 forward's 64- and 128-row blocks timed in turns at the
    serving buckets, the float32 forward's mean error (TF32_MEAN_BOUND,
    with the controls of TF32_CONTROLS that must miss it) at D = 8, 64, 72,
    128 and ragged L, and a misaligned view that must raise; returns
    per-kernel records."""
    import torch
    from genhancer_tpu_torch.core.kernels import short_attention as K
    from genhancer_tpu_torch.core.rope import apply_rope

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = (
        # name, B, L, H, D, dtype, main-path shape
        [("fused_rope_attention", b, 197, 24, 128, bf16, True) for b in BUCKETS]
        + [("fused_rope_attention", 2, 197, 24, 128, f32, False),
           ("fused_rope_attention", 1, 1, 4, 128, f32, False),
           ("fused_rope_attention", 2, 65, 4, 128, f32, False),
           ("fused_rope_attention", 2, 129, 4, 128, f32, False),
           ("fused_rope_attention", 2, 13, 24, 128, bf16, False),
           ("fused_rope_attention", 1, 600, 24, 128, bf16, False)]
        + [("fused_attention", b, 257, 16, 64, bf16, True) for b in BUCKETS]
        + [("fused_attention", 2, 257, 16, 64, f32, False),
           ("fused_attention", 2, 1, 4, 8, f32, False),
           ("fused_attention", 2, 65, 4, 72, f32, False),
           ("fused_attention", 2, 129, 4, 8, f32, False),
           ("fused_attention", 2, 129, 4, 128, f32, False),
           ("fused_attention", 50, 64, 16, 72, f32, False),     # SigLIP eval, text side
           ("fused_attention", 2, 256, 16, 72, bf16, False),
           ("fused_attention", 2, 13, 16, 64, bf16, False),
           ("fused_attention", 1, 600, 16, 64, bf16, False)])
    rec = {n: _record(n) for n in ("fused_rope_attention", "fused_attention")}
    for r in rec.values():
        r["ms_by_batch"], r["rounding_mean_rel"], r["ms_by_block_rows"] = {}, 0.0, {}
        r["float32_mean_rel"] = 0.0
    for name, b, l, h, d, dtype, main in cases:
        q, k, v = (_rand(gen, (b, l, h, d), dtype) for _ in range(3))
        if name == "fused_rope_attention":
            cos, sin = _tables(gen, b, l, d)
            tables = (cos, sin)
            kfn = lambda: K.fused_rope_attention(q, k, v, cos, sin)  # noqa: E731
            pfn = lambda: K.fused_rope_attention_ref(q, k, v, cos, sin)  # noqa: E731
        else:
            tables = None
            kfn = lambda: K.fused_attention(q, k, v)  # noqa: E731
            pfn = lambda: K.fused_attention_ref(q, k, v)  # noqa: E731
        out = kfn()
        torch.cuda.synchronize()
        ref = pfn()
        torch.cuda.synchronize()
        check(out.shape == ref.shape and out.dtype == dtype, f"{name}: shape/dtype")
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        err = (out.float() - ref.float()).abs().max().item()
        bound = BOUND[str(dtype).split(".")[-1]]
        rounding = ""
        rq, rk = ((apply_rope(q, *tables), apply_rope(k, *tables)) if tables else (q, k))
        if dtype == f32:
            mean, _ = _tf32_mean_check(f"{name} B={b} L={l} H={h} D={d}", out, ref, rq, rk, v)
            rec[name]["float32_mean_rel"] = max(rec[name]["float32_mean_rel"], mean)
        if dtype == bf16:
            o_mean = _mean_rel(out, ref)
            o_ctl = _mean_rel(_round_before_normalise(rq, rk, v), ref)
            rec[name]["rounding_mean_rel"] = max(rec[name]["rounding_mean_rel"], o_mean)
            rounding = (f"; o mean|kernel-plain|/mean|plain| {o_mean:.3e} (bound "
                        f"{ROUNDING_BOUND:.0e}; p rounded before normalising {o_ctl:.3e})")
            check(o_mean <= ROUNDING_BOUND, f"{name} B={b} L={l} D={d}: o's rounding point "
                  f"moved: mean error {o_mean} > {ROUNDING_BOUND}")
            check(o_ctl > ROUNDING_BOUND, f"{name} B={b} L={l} D={d}: the control passes the "
                  f"rounding bound ({o_ctl}), so it cannot tell the rounding points apart")
        timing = ""
        if main:
            ms, pms = kernel_vs_plain_ms(kfn, pfn)
            rec[name]["ms_by_batch"][b] = (ms, pms)
            rows = K.block_rows(b, l, h, K._sm_count(q.device.index))
            timing = f"; kernel {ms:.4f} ms ({rows}-row blocks), plain {pms:.4f} ms"
            # the call is host-bound at these sizes: the device time of each
            # block height from CUDA graphs, which leave the host out
            dev = {64: [], 128: []}
            for rows in (64, 128, 128, 64):
                dev[rows].append(graph_ms(lambda: K._fwd_kernel(q, k, v, tables, False,
                                                                rows=rows)))
            dev = {r: None if None in m else min(m) for r, m in dev.items()}
            rec[name]["ms_by_block_rows"][b] = {str(r): m for r, m in dev.items()}
            timing += "; device " + ", ".join(f"{r}-row blocks {_fmt(m)} ms"
                                              for r, m in dev.items())
            if b == max(BUCKETS):
                _set_bound(rec[name], _nbytes(q, k, v, out, *(tables or ())),
                           4.0 * b * h * l * l * d)
                lib_f = _sdpa_fwd_bwd(q, k, v, q)[0]
                rec[name]["device_ms"] = graph_ms(kfn)
                rec[name]["library_device_ms"] = graph_ms(lib_f)
                timing += (f"; device: kernel {_fmt(rec[name]['device_ms'])} ms, SDPA "
                           f"{_fmt(rec[name]['library_device_ms'])} ms")
                rec[name]["library_ms"] = _library_ms(_sdpa_fwd_bwd(q, k, v, q)[0])
                timing += (f"; bound {rec[name]['bound_ms']:.4f} ms ({rec[name]['bound_by']}),"
                           f" SDPA {rec[name]['library_ms']:.4f} ms")
        print(f"[kernels] {name} B={b} L={l} H={h} D={d} {str(dtype)[6:]}: "
              f"max|kernel-plain| {err:.3e} (bound {bound:.0e}){rounding}{timing}", flush=True)
        check(err <= bound, f"{name} B={b} L={l} D={d} {dtype}: error {err} > {bound}")
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)

    # the DiT's single blocks hand K1 strided views of one fused projection
    b, l, h, d = 2, 197, 24, 128
    fused = _rand(gen, (b, l, 3 * h * d + 64), bf16)
    q, k, v = (x.reshape(b, l, h, d) for x in fused[..., : 3 * h * d].split(h * d, dim=-1))
    cos, sin = _tables(gen, b, l, d)
    out = K.fused_rope_attention(q, k, v, cos, sin)
    ref = K.fused_rope_attention_ref(q.contiguous(), k.contiguous(), v.contiguous(), cos, sin)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    print(f"[kernels] fused_rope_attention strided q/k/v views (row stride "
          f"{q.stride(1)}): max|kernel-plain| {err:.3e} (bound 2e-02)")
    check(err <= BOUND["bfloat16"], f"strided K1: error {err}")
    rec["fused_rope_attention"]["max_abs_err"] = max(
        rec["fused_rope_attention"]["max_abs_err"], err)

    # the TMA reads 16-byte-aligned views only: one misaligned by an element
    # must raise (and launch nothing), never fall back
    bad = fused[..., 1: 1 + h * d].reshape(b, l, h, d)
    before = dict(K.LAUNCHES)
    raised = []
    for fn in (lambda: K.fused_rope_attention(bad, k, v, cos, sin),
               lambda: K.fused_attention(q, k, bad)):
        try:
            fn()
        except ValueError as e:
            raised.append(str(e))
    print(f"[kernels] K1/K2 misaligned view (1 element past 16 bytes): raises "
          f"{len(raised)} of 2: {raised}", flush=True)
    check(len(raised) == 2 and K.LAUNCHES == before, "K1/K2: a misaligned bf16 view did not raise")

    # no kernel takes float16 (a float16 tower directory loads as float16):
    # K2 refuses it at its dtype check, before any launch, never the plain path
    h16 = _rand(gen, (2, 257, 16, 64), torch.float16)
    try:
        K.fused_attention(h16, h16, h16)
        raised16 = ""
    except TypeError as e:
        raised16 = str(e)
    print(f"[kernels] fused_attention float16 q/k/v: "
          f"{'raises: ' + raised16 if raised16 else 'did not raise'}", flush=True)
    check(raised16 and K.LAUNCHES == before, "K2: float16 q/k/v did not raise")

    for r in rec.values():
        r["ms"], r["plain_ms"] = r.pop("ms_by_batch")[max(BUCKETS)]
    rec["fused_attention"]["float32_eval"] = _k2_float32_eval(gen)
    return rec


def _k2_float32_eval(gen):
    """K2 in float32 (the split-TF32 wgmma body) at the MMVP-VLM eval's
    batch of 50: MetaCLIP-L/14 at 224 px (L=257) and CLIP-L/14@336 (L=577),
    H=16, D=64; against the plain version in exact float32 (TF32 off): max
    1e-4 and mean TF32_MEAN_BOUND, with the controls of TF32_CONTROLS that
    must miss the latter; timed, call and device, with SDPA in float32 and
    its bound: the three TF32 products of each of its two products at 495
    TFLOP/s (the scalar cores' 67 TFLOP/s line printed beside it)."""
    import torch
    from genhancer_tpu_torch.core.kernels import short_attention as K

    out_rec = {}
    for l in (257, 577):
        q, k, v = (_rand(gen, (50, l, 16, 64), torch.float32) for _ in range(3))
        kfn = lambda: K.fused_attention(q, k, v)  # noqa: E731
        pfn = lambda: K.fused_attention_ref(q, k, v)  # noqa: E731
        out = kfn()
        torch.cuda.synchronize()
        ref = pfn()
        err = (out - ref).abs().max().item()
        check(bool(torch.isfinite(out).all()) and err <= BOUND["float32"],
              f"fused_attention float32 B=50 L={l}: error {err} > {BOUND['float32']}")
        mean, ctl = _tf32_mean_check(f"fused_attention B=50 L={l} H=16 D=64", out, ref, q, k, v)
        del ref
        _free()
        ms, pms = kernel_vs_plain_ms(kfn, pfn, n=5, rounds=4)
        lib_f = _sdpa_fwd_bwd(q, k, v, q)[0]
        times = {"ms": ms, "plain_ms": pms, "max_abs_err": err, "mean_rel": mean,
                 "controls_mean_rel": ctl, "device_ms": graph_ms(kfn, n=5),
                 "library_ms": _library_ms(lib_f, n=5), "library_device_ms": graph_ms(lib_f, n=5)}
        flops = 4.0 * 50 * 16 * l * l * 64            # the function: two products
        _set_bound(times, _nbytes(q, k, v, out), 3 * flops, peak=TF32_PEAK)
        times["scalar_bound_ms"] = flops / FP32_PEAK * 1e3
        out_rec[l] = times
        print(f"[kernels] fused_attention B=50 L={l} H=16 D=64 float32 (the eval's tower): "
              f"max|kernel-plain| {err:.3e} (bound 1e-04); kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms, device (CUDA graph) {_fmt(times['device_ms'])} ms; bound "
              f"{times['bound_ms']:.4f} ms ({times['bound_by']}: 3 TF32 products per product at "
              f"495 TFLOP/s; the scalar cores' line {times['scalar_bound_ms']:.4f} ms at 67 "
              f"TFLOP/s); SDPA float32 {times['library_ms']:.4f} ms, device "
              f"{_fmt(times['library_device_ms'])} ms", flush=True)
        del q, k, v, out, lib_f
        _free()
    return out_rec


def _record(name):
    kid, lib, replaces = KERNELS[name]
    return {"name": name, "id": kid, "route": "cuda", "source": SOURCES[lib],
            "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
            "ms": None, "plain_ms": None, "bound_ms": None, "bound_by": None,
            "library_ms": None}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _set_bound(rec, n_bytes: float, n_ops: float = 0.0, peak: float = BF16_PEAK) -> None:
    """The least time the card could take for the timed call: the larger of
    its bytes (each input read once, each output written once) over the HBM
    rate and its operations over the peak rate of their type."""
    t_bytes, t_ops = n_bytes / HBM_PEAK * 1e3, n_ops / peak * 1e3
    rec["bound_ms"], rec["bound_by"] = ((t_bytes, "bytes") if t_bytes >= t_ops
                                        else (t_ops, "operations"))


def _library_ms(fn, n: int = 20, rounds: int = 4) -> float:
    """Median per-call ms of a PyTorch library call, after a warmup."""
    for _ in range(3):
        fn()
    return statistics.median(_median_ms(fn, n) for _ in range(rounds))


def _sdpa_fwd_bwd(q, k, v, do):
    """(forward, backward) callables of ``scaled_dot_product_attention`` on
    [B, H, L, D] copies of q, k, v: the library call that computes the same
    attention (without K1's RoPE), timed beside the kernels and used nowhere
    in the port."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    out = F.scaled_dot_product_attention(qt, kt, vt)

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt)

    def bwd():
        torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
    return fwd, bwd


def _grad_errors(got, want):
    """(max abs error, max abs error / max(1, max|plain|)) over dq, dk, dv."""
    abs_err = rel_err = 0.0
    for g, w in zip(got, want):
        e = (g.float() - w.float()).abs().max().item()
        abs_err = max(abs_err, e)
        rel_err = max(rel_err, e / max(1.0, w.float().abs().max().item()))
    return abs_err, rel_err


def _mean_rel(got, want):
    """mean|got - want| / mean|want|."""
    got, want = got.float(), want.float()
    return ((got - want).abs().mean() / want.abs().mean()).item()


def phase_kernels_bwd():
    """K1b/K2b against their plain backward versions on dq, dk, dv; the
    bound is relative to max(1, max|plain|).  In bf16, the rounding points
    of both on their own: dq, dk and dv to ROUNDING_BOUND of the plain
    version, with a control that keeps p in float32 for dv (K5b's point) and
    must miss it.  K2b is timed at the tower's L = 257, at L = 256 (what
    the ragged last tile costs) and at CLIP-L/14@336's L = 577 (B = 32, the
    frames of one middle@336 stage-2 micro-batch); both run on strided views
    of one fused projection, and a misaligned view must raise before any
    launch.
    Returns per-kernel records."""
    import torch
    from genhancer_tpu_torch.core.kernels import flash_attention as F
    from genhancer_tpu_torch.core.kernels import short_attention as K

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    bf16, f32 = torch.bfloat16, torch.float32
    rope, norope = "fused_rope_attention_bwd", "fused_attention_bwd"
    cases = (  # name, B, L, H, D, dtype, timed (the training shape)
        (rope, 16, 197, 24, 128, bf16, True), (rope, 2, 197, 24, 128, f32, False),
        (rope, 2, 13, 24, 128, bf16, False), (rope, 1, 600, 24, 128, bf16, False),
        (rope, 1, 13, 24, 128, f32, False),
        (norope, 16, 257, 16, 64, bf16, True), (norope, 16, 256, 16, 64, bf16, True),
        (norope, 32, 577, 16, 64, bf16, True),       # CLIP-L/14@336, video stage 2
        (norope, 2, 256, 16, 72, bf16, False), (norope, 2, 257, 16, 64, f32, False),
        (norope, 2, 13, 16, 64, bf16, False), (norope, 1, 600, 16, 64, bf16, False))
    rec = {n: _record(n) for n in (rope, norope)}
    for r in rec.values():
        r["rounding_mean_rel"], r["ms_by_length"] = 0.0, {}

    def run(name, q, k, v, do, tables):
        """(kernel, plain, (rq, rk, o, lse)): K1b reads the rotated pair and
        the lse that K1 wrote, as under autograd."""
        o, lse, rq, rk = K._fwd_kernel(q, k, v, tables, want_lse=True)
        kfn = lambda: K._bwd_kernel(rq, rk, v, o, lse, do, tables)  # noqa: E731
        if tables is None:
            pfn = lambda: K.fused_attention_bwd_ref(q, k, v, o, do)  # noqa: E731
        else:
            pfn = lambda: K.fused_rope_attention_bwd_ref(q, k, v, o, do, *tables)  # noqa: E731
        return kfn, pfn, (rq, rk, o, lse)

    for name, b, l, h, d, dtype, timed in cases:
        q, k, v, do = (_rand(gen, (b, l, h, d), dtype) for _ in range(4))
        tables = _tables(gen, b, l, d) if name == rope else None
        kfn, pfn, (rq, rk, o, lse) = run(name, q, k, v, do, tables)
        got = kfn()
        torch.cuda.synchronize()
        want = pfn()
        check(all(bool(torch.isfinite(g).all()) and g.dtype == dtype and g.shape == q.shape
                  for g in got), f"{name}: non-finite or misshapen gradient")
        abs_err, rel_err = _grad_errors(got, want)
        bound = BOUND[str(dtype).split(".")[-1]]
        rounding = ""
        if dtype == bf16:
            means = [_mean_rel(g, w) for g, w in zip(got, want)]
            rounding = (f"; mean|kernel-plain|/mean|plain| dq {means[0]:.3e}, dk {means[1]:.3e},"
                        f" dv {means[2]:.3e}")
            # the control: dv from float32 p (K5b's point) on the pair the
            # kernel read
            dv_ctl = _mean_rel(F.flash_attention_bwd_ref(rq, rk, v, o, lse, do)[2], want[2])
            rounding += f" (bound {ROUNDING_BOUND:.0e}; dv from float32 p {dv_ctl:.3e})"
            rec[name]["rounding_mean_rel"] = max(rec[name]["rounding_mean_rel"], *means)
            kid = KERNELS[name][0]
            check(max(means) <= ROUNDING_BOUND, f"{kid} B={b} L={l} D={d}: rounding points "
                  f"moved: dq, dk, dv mean errors {means}")
            check(dv_ctl > ROUNDING_BOUND, f"{kid} B={b} L={l} D={d}: the control passes the "
                  f"rounding bound ({dv_ctl}), so it cannot tell the rounding points apart")
        timing = ""
        if timed:
            ms, pms = kernel_vs_plain_ms(kfn, pfn, n=20)
            lib_b = _sdpa_fwd_bwd(q, k, v, do)[1]
            times = {"ms": ms, "plain_ms": pms, "library_ms": _library_ms(lib_b),
                     "device_ms": graph_ms(kfn), "library_device_ms": graph_ms(lib_b),
                     "library_device_by": "CUDA graph"}
            if times["library_device_ms"] is None:
                times["library_device_ms"] = profiled_ms(lib_b)
                times["library_device_by"] = "profiler, kernel time per call"
            rec[name]["ms_by_length"][l] = times
            # inputs q, k, v, o, lse, dO (+ tables), outputs dq, dk, dv; five
            # products: S, dP, dV, dQ, dK
            _set_bound(times, _nbytes(q, k, v, o, lse, do, *got, *(tables or ())),
                       5 * 2.0 * b * h * l * l * d)
            if not rec[name]["ms"]:             # the first timed length is the record's
                rec[name].update(times)
            timing = (f"; kernel {ms:.4f} ms, plain {pms:.4f} ms; bound "
                      f"{times['bound_ms']:.4f} ms ({times['bound_by']}), SDPA backward "
                      f"{times['library_ms']:.4f} ms; device (CUDA graph): kernel "
                      f"{_fmt(times['device_ms'])} ms, SDPA backward "
                      f"{_fmt(times['library_device_ms'])} ms ({times['library_device_by']})")
            del lib_b
        print(f"[kernels] {name} B={b} L={l} H={h} D={d} {str(dtype)[6:]}: dq/dk/dv "
              f"max|kernel-plain| {abs_err:.3e}, relative {rel_err:.3e} "
              f"(bound {bound:.0e}){rounding}{timing}", flush=True)
        check(rel_err <= bound, f"{name} B={b} L={l} D={d} {dtype}: error {rel_err} > {bound}")
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], abs_err)
    t256, t257 = (rec[norope]["ms_by_length"][n] for n in (256, 257))
    print(f"[kernels] {norope} B=16 H=16 D=64, L=257 against L=256 (the ragged last tile): "
          f"call {t257['ms']:.4f} / {t256['ms']:.4f} ms, device "
          f"{_fmt(t257['device_ms'])} / {_fmt(t256['device_ms'])} ms", flush=True)
    t577 = rec[norope]["ms_by_length"][577]
    print(f"[kernels] {norope} B=32 L=577 H=16 D=64 (middle@336 stage 2): call "
          f"{t577['ms']:.4f} ms, device {_fmt(t577['device_ms'])} ms, bound "
          f"{t577['bound_ms']:.4f} ms ({t577['bound_by']}), SDPA backward "
          f"{t577['library_ms']:.4f} ms", flush=True)

    # K1b and K2b on the strided q/k/v views of one fused projection
    for name, h, d in ((rope, 24, 128), (norope, 16, 64)):
        b, l = 2, 197
        fused = _rand(gen, (b, l, 3 * h * d + 64), bf16)
        q, k, v = (x.reshape(b, l, h, d) for x in fused[..., : 3 * h * d].split(h * d, dim=-1))
        do = _rand(gen, (b, l, h, d), bf16)
        tables = _tables(gen, b, l, d) if name == rope else None
        kfn, _, _ = run(name, q, k, v, do, tables)
        _, pfn, _ = run(name, q.contiguous(), k.contiguous(), v.contiguous(), do, tables)
        got, want = kfn(), pfn()
        torch.cuda.synchronize()
        abs_err, rel_err = _grad_errors(got, want)
        print(f"[kernels] {name} strided q/k/v views (row stride {q.stride(1)}): "
              f"max|kernel-plain| {abs_err:.3e}, relative {rel_err:.3e} (bound 2e-02)")
        check(rel_err <= BOUND["bfloat16"], f"strided {KERNELS[name][0]}: error {rel_err}")
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], abs_err)

    # the TMA reads 16-byte-aligned views only: one misaligned by an element
    # must raise before any launch, never fall back
    bad = fused[..., 1: 1 + h * d].reshape(b, l, h, d)
    o, lse, _, _ = K._fwd_kernel(q, k, v, None, want_lse=True)
    before = dict(K.LAUNCHES)
    try:
        K._bwd_kernel(q, k, bad, o, lse, do, None)
        raised = ""
    except ValueError as e:
        raised = str(e)
    print(f"[kernels] {norope} misaligned view (1 element past 16 bytes): "
          f"{'raises: ' + raised if raised else 'did not raise'}", flush=True)
    check(raised and K.LAUNCHES == before, "K2b: a misaligned bf16 view did not raise")
    return rec


def phase_kernels_flash():
    """K5 (o and lse) and K5b (dq, dk, dv) against their plain versions at
    the shapes the video paths give them (the SigLIP-384 tower's bf16 shape:
    phase_kernels_siglip), ragged lengths and float32 (the SigLIP eval's
    image side, B=50, L=729, D=72, among them) (whose o is also held to TF32_MEAN_BOUND, with
    the controls that must miss it); the bound is relative to max(1,
    max|plain|).  In bf16 the rounding points are held on their own
    (ROUNDING_BOUND): K5's o and K5b's dv against the plain versions, and two controls that round
    p elsewhere and must miss the bound — ``_round_before_normalise`` and
    K2b's plain backward (p rounded before p^T dO).  The middle@336 shape
    runs at B=4: the plain backward's [B, H, L, L] float32 tensors are
    7.8 GB each at its published B=32.
    Returns the K5/K5b records, timed at the sliding@224 shape."""
    import torch
    from genhancer_tpu_torch.core.kernels import flash_attention as F
    from genhancer_tpu_torch.core.kernels import short_attention as K

    gen = torch.Generator(device="cuda")
    gen.manual_seed(777)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = (  # what, B, L, H, D, dtype, timed
        ("sliding@224", 16, 964, 24, 128, bf16, True),
        ("next2@224", 32, 708, 24, 128, bf16, True),
        ("middle@336 (B cut from 32)", 4, 1593, 24, 128, bf16, True),
        ("sliding@336", 2, 2169, 24, 128, bf16, True),
        ("SigLIP-384 eval's image side", 50, 729, 16, 72, f32, False),
        ("ragged", 2, 601, 24, 128, bf16, False),
        ("ragged", 2, 1031, 24, 128, bf16, False),
        ("strided q/k/v views", 2, 964, 24, 128, bf16, False),
        ("float32", 2, 700, 4, 128, f32, False),
        ("float32 ragged", 1, 1031, 4, 72, f32, False))
    rec = {n: _record(n) for n in ("flash_attention", "flash_attention_bwd")}
    for r in rec.values():
        r["ms_by_shape"], r["rounding_mean_rel"] = {}, 0.0
    for what, b, l, h, d, dtype, timed in cases:
        q, k, v, do = (_rand(gen, (b, l, h, d), dtype) for _ in range(4))
        if what.startswith("strided"):     # views of one fused projection, as in the DiT
            fused = _rand(gen, (b, l, 3 * h * d + 64), dtype)
            q, k, v = (x.reshape(b, l, h, d) for x in fused[..., : 3 * h * d].split(h * d, -1))
        o, lse = F._fwd_kernel(q, k, v, want_lse=True)
        torch.cuda.synchronize()
        ro, rlse = F.flash_attention_fwd_ref(q, k, v)
        o_abs, o_rel = _grad_errors((o,), (ro,))
        lse_rel = ((lse - rlse).abs().max() / rlse.abs().max().clamp_min(1.0)).item()
        got = F._bwd_kernel(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        want = F.flash_attention_bwd_ref(q, k, v, o, lse, do)
        check(bool(torch.isfinite(o).all()) and o.dtype == dtype and o.shape == q.shape,
              f"K5 {what}: non-finite or misshapen output")
        check(all(bool(torch.isfinite(g).all()) and g.dtype == dtype and g.shape == q.shape
                  for g in got), f"K5b {what}: non-finite or misshapen gradient")
        g_abs, g_rel = _grad_errors(got, want)
        bound = BOUND[str(dtype).split(".")[-1]]
        timing = ""
        if timed:
            fms, fpms = kernel_vs_plain_ms(lambda: F._fwd_kernel(q, k, v, True),
                                           lambda: F.flash_attention_fwd_ref(q, k, v),
                                           n=5, rounds=4)
            bms, bpms = kernel_vs_plain_ms(lambda: F._bwd_kernel(q, k, v, o, lse, do),
                                           lambda: F.flash_attention_bwd_ref(q, k, v, o, lse, do),
                                           n=3, rounds=4)
            rec["flash_attention"]["ms_by_shape"][what] = [fms, fpms]
            rec["flash_attention_bwd"]["ms_by_shape"][what] = [bms, bpms]
            if what == "sliding@224":
                # the function's least work: 2 products forward, 5 backward
                lib_f, lib_b = _sdpa_fwd_bwd(q, k, v, do)
                _set_bound(rec["flash_attention"], _nbytes(q, k, v, o, lse),
                           2 * 2.0 * b * h * l * l * d)
                _set_bound(rec["flash_attention_bwd"], _nbytes(q, k, v, o, lse, do, *got),
                           5 * 2.0 * b * h * l * l * d)
                rec["flash_attention"]["library_ms"] = _library_ms(lib_f, n=5)
                rec["flash_attention_bwd"]["library_ms"] = _library_ms(lib_b, n=3)
                print(f"[kernels] flash_attention sliding@224: bound K5 "
                      f"{rec['flash_attention']['bound_ms']:.3f} ms, K5b "
                      f"{rec['flash_attention_bwd']['bound_ms']:.3f} ms (operations); SDPA "
                      f"forward {rec['flash_attention']['library_ms']:.3f} ms, backward "
                      f"{rec['flash_attention_bwd']['library_ms']:.3f} ms", flush=True)
                del lib_f, lib_b
            # the wgmma products each kernel runs, 2 B H L^2 D flops each:
            # forward 3 (QK^T in both passes, PV); backward 8 (S^T and dP^T in
            # the dk/dv kernel, S and dP in the dq kernel, dV twice for p's
            # hi/lo split, dK, dQ); the function itself needs 2 and 5
            unit = 2.0 * b * h * l * l * d
            rates = {}
            for n, ms, prods, least in (("flash_attention", fms, 3, 2),
                                        ("flash_attention_bwd", bms, 8, 5)):
                tf = prods * unit / ms / 1e9
                rates[n] = (tf, tf * 1e12 / BF16_PEAK, least * unit / ms / 1e9)
                rec[n].setdefault("tflops_by_shape", {})[what] = round(tf, 1)
            timing = "".join(
                f"; {tag} {ms:.3f} ms ({rates[n][0]:.1f} TFLOP/s run, "
                f"{100 * rates[n][1]:.1f}% of the 989 TFLOP/s peak; {rates[n][2]:.1f} TFLOP/s "
                f"of the function's {least} products), plain {pms:.3f}"
                for tag, n, ms, pms, least in (("K5", "flash_attention", fms, fpms, 2),
                                               ("K5b", "flash_attention_bwd", bms, bpms, 5)))
        dv_rel = ((got[2].float() - want[2].float()).abs().max()
                  / want[2].float().abs().max()).item()
        print(f"[kernels] flash_attention {what} B={b} L={l} H={h} D={d} {str(dtype)[6:]}: "
              f"o max|kernel-plain| {o_abs:.3e} relative {o_rel:.3e}, lse relative "
              f"{lse_rel:.3e}; dq/dk/dv max {g_abs:.3e} relative {g_rel:.3e} "
              f"(bound {bound:.0e}); dv alone max {dv_rel:.3e} of max|plain|{timing}",
              flush=True)
        check(o_rel <= bound and lse_rel <= 1e-4 and g_rel <= bound,
              f"K5/K5b {what} {dtype}: o {o_rel}, lse {lse_rel}, grads {g_rel} > {bound}")
        if dtype == f32:
            mean, _ = _tf32_mean_check(f"flash_attention {what} B={b} L={l} H={h} D={d}", o, ro,
                                       q, k, v)
            rec["flash_attention"]["float32_mean_rel"] = max(
                rec["flash_attention"].get("float32_mean_rel", 0.0), mean)
        if dtype == bf16:
            o_mean, dv_mean = _mean_rel(o, ro), _mean_rel(got[2], want[2])
            o_ctl = _mean_rel(_round_before_normalise(q, k, v), ro)
            dv_ctl = _mean_rel(K.fused_attention_bwd_ref(q, k, v, o, do)[2], want[2])
            print(f"[kernels] flash_attention {what}: rounding points, mean|a-plain|/mean|plain|"
                  f" (bound {ROUNDING_BOUND:.0e}): K5 o {o_mean:.3e} (p rounded before "
                  f"normalising {o_ctl:.3e}), K5b dv {dv_mean:.3e} (p rounded first {dv_ctl:.3e})",
                  flush=True)
            for n, x in (("flash_attention", o_mean), ("flash_attention_bwd", dv_mean)):
                rec[n]["rounding_mean_rel"] = max(rec[n]["rounding_mean_rel"], x)
            check(o_mean <= ROUNDING_BOUND and dv_mean <= ROUNDING_BOUND,
                  f"K5/K5b {what}: rounding points moved: o {o_mean}, dv {dv_mean}")
            check(o_ctl > ROUNDING_BOUND and dv_ctl > ROUNDING_BOUND,
                  f"K5/K5b {what}: the controls pass the rounding bound (o {o_ctl}, dv "
                  f"{dv_ctl}), so it cannot tell the rounding points apart")
        rec["flash_attention"]["max_abs_err"] = max(rec["flash_attention"]["max_abs_err"], o_abs)
        rec["flash_attention_bwd"]["max_abs_err"] = max(
            rec["flash_attention_bwd"]["max_abs_err"], g_abs)
        del q, k, v, do, o, lse, ro, rlse, got, want
        _free()
    # the TMA reads 16-byte-aligned views only: one misaligned by an element
    # must raise (and launch nothing), never fall back
    fused = _rand(gen, (2, 964, 3 * 24 * 128 + 8), bf16)
    bad = fused[..., 1: 1 + 24 * 128].reshape(2, 964, 24, 128)
    before = dict(F.LAUNCHES)
    try:
        F._fwd_kernel(bad, bad, bad, want_lse=True)
        raised = ""
    except ValueError as e:
        raised = str(e)
    print(f"[kernels] flash_attention misaligned view (1 element past 16 bytes): "
          f"{'raises: ' + raised if raised else 'did not raise'}", flush=True)
    check(raised and F.LAUNCHES == before, "K5: a misaligned bf16 view did not raise")
    for r in rec.values():
        r["ms"], r["plain_ms"] = r["ms_by_shape"]["sliding@224"]
    return rec


# the SigLIP-384 paths' attention shapes [B, L, H, D]: the DiT's joint
# sequence (576 latent tokens + 1 text token) and the so400m tower
SIGLIP_SHAPES = {"K1/K1b (DiT, joint L=577)": (16, 577, 24, 128),
                 "K5/K5b (so400m tower)": (16, 729, 16, 72)}


def phase_kernels_siglip(records):
    """K1/K1b at the SigLIP-384 image mode's joint L = 577 = 9 x 64 + 1
    (B=16, H=24, D=128: the last 64-row kv tile holds one row) and K5/K5b
    at the so400m tower's L = 729 = 5 x 128 + 89, D = 72 (B=16, H=16: D
    padded to 128 in shared memory), bf16: against their plain versions
    (2e-2), the rounding points (ROUNDING_BOUND: o; K1b's dq, dk, dv; K5b's
    dv) with their controls, and timed: the call and its plain version in
    turns, the device time from CUDA graphs, SDPA's call and device time on
    the same q, k, v, and the bound (bytes at 3.35 TB/s or the function's
    products, 2 forward and 5 backward, at 989 TFLOP/s).  The timings go
    into the four kernels' records under ``siglip_shape``."""
    import torch
    from genhancer_tpu_torch.core.kernels import flash_attention as F
    from genhancer_tpu_torch.core.kernels import short_attention as K

    gen = torch.Generator(device="cuda")
    gen.manual_seed(729)
    for what, (b, l, h, d) in SIGLIP_SHAPES.items():
        q, k, v, do = (_rand(gen, (b, l, h, d), torch.bfloat16) for _ in range(4))
        if what.startswith("K1"):
            tables = _tables(gen, b, l, d)
            names = ("fused_rope_attention", "fused_rope_attention_bwd")
            o, lse, rq, rk = K._fwd_kernel(q, k, v, tables, want_lse=True)
            ffn = lambda: K._fwd_kernel(q, k, v, tables, want_lse=True)  # noqa: E731
            bfn = lambda: K._bwd_kernel(rq, rk, v, o, lse, do, tables)  # noqa: E731
            fref = lambda: K.fused_rope_attention_ref(q, k, v, *tables)  # noqa: E731
            bref = lambda: K.fused_rope_attention_bwd_ref(q, k, v, o, do, *tables)  # noqa: E731
            # dv from float32 p (K5b's point), on the pair K1 wrote
            dv_ctl = lambda: F.flash_attention_bwd_ref(rq, rk, v, o, lse, do)[2]  # noqa: E731
        else:
            tables, rq, rk = None, q, k
            names = ("flash_attention", "flash_attention_bwd")
            o, lse = F._fwd_kernel(q, k, v, want_lse=True)
            ffn = lambda: F._fwd_kernel(q, k, v, want_lse=True)  # noqa: E731
            bfn = lambda: F._bwd_kernel(q, k, v, o, lse, do)  # noqa: E731
            fref = lambda: F.flash_attention_fwd_ref(q, k, v)[0]  # noqa: E731
            bref = lambda: F.flash_attention_bwd_ref(q, k, v, o, lse, do)  # noqa: E731
            dv_ctl = lambda: K.fused_attention_bwd_ref(q, k, v, o, do)[2]  # noqa: E731
        got = bfn()
        torch.cuda.synchronize()
        ro, want = fref(), bref()
        check(bool(torch.isfinite(o).all()) and all(bool(torch.isfinite(g).all()) for g in got),
              f"{what}: non-finite output or gradient")
        o_abs, o_rel = _grad_errors((o,), (ro,))
        g_abs, g_rel = _grad_errors(got, want)
        o_mean, o_ctl = _mean_rel(o, ro), _mean_rel(_round_before_normalise(rq, rk, v), ro)
        means = [_mean_rel(g, w) for g, w in zip(got, want)]
        held = means if what.startswith("K1") else means[2:]     # K5b: dv's point
        d_ctl = _mean_rel(dv_ctl(), want[2])
        print(f"[kernels] SigLIP-384 {what} B={b} L={l} H={h} D={d} bf16: o max "
              f"{o_abs:.3e} (rel {o_rel:.3e}), dq/dk/dv max {g_abs:.3e} (rel {g_rel:.3e}; bound "
              f"2e-02); mean|kernel-plain|/mean|plain| o {o_mean:.3e} (p rounded before "
              f"normalising {o_ctl:.3e}), dq {means[0]:.3e}, dk {means[1]:.3e}, dv "
              f"{means[2]:.3e} (the other kernel's p for dv {d_ctl:.3e}; bound "
              f"{ROUNDING_BOUND:.0e})", flush=True)
        check(o_rel <= BOUND["bfloat16"] and g_rel <= BOUND["bfloat16"],
              f"{what}: o {o_rel}, grads {g_rel} > {BOUND['bfloat16']}")
        check(o_mean <= ROUNDING_BOUND and max(held) <= ROUNDING_BOUND,
              f"{what}: rounding points moved: o {o_mean}, gradients {means}")
        check(o_ctl > ROUNDING_BOUND and d_ctl > ROUNDING_BOUND,
              f"{what}: a control passes the rounding bound (o {o_ctl}, dv {d_ctl})")
        lib_f, lib_b = _sdpa_fwd_bwd(q, k, v, do)
        unit = 2.0 * b * h * l * l * d
        rows = {}
        for name, kfn, pfn, lib, n, prods, io in (
                (names[0], ffn, fref, lib_f, 10, 2, (q, k, v, o, lse) + tuple(tables or ())),
                (names[1], bfn, bref, lib_b, 5, 5,
                 (q, k, v, o, lse, do, *got) + tuple(tables or ()))):
            ms, pms = kernel_vs_plain_ms(kfn, pfn, n=n, rounds=4)
            row = {"shape": [b, l, h, d], "ms": ms, "plain_ms": pms,
                   "device_ms": graph_ms(kfn, n=n), "library_ms": _library_ms(lib, n=n),
                   "library_device_ms": graph_ms(lib, n=n), "library_device_by": "CUDA graph"}
            if row["library_device_ms"] is None:
                row["library_device_ms"] = profiled_ms(lib, n=n)
                row["library_device_by"] = "profiler, kernel time per call"
            _set_bound(row, _nbytes(*io), prods * unit)
            rows[name] = row
            if records.get(name) is not None:
                records[name]["siglip_shape"] = row
            kid = KERNELS[name][0]
            share = (f", {100 * row['bound_ms'] / row['device_ms']:.1f}% of the bound"
                     if row["device_ms"] else "")
            print(f"[kernels] SigLIP-384 {kid} B={b} L={l} H={h} D={d}: call {ms:.4f} ms, plain "
                  f"{pms:.4f} ms; device {_fmt(row['device_ms'])} ms{share}; bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}); SDPA call "
                  f"{row['library_ms']:.4f} ms, device {_fmt(row['library_device_ms'])} ms "
                  f"({row['library_device_by']})", flush=True)
        del q, k, v, do, o, lse, got, want, ro, lib_f, lib_b
        _free()


def _stage1_trainable_shapes():
    """(path, shape, dtype) of every trainable leaf of the flux-dev stage-1
    state of CONFIG (DiT in bf16, projectors in float32), from meta tensors."""
    from genhancer_tpu_torch.tasks import factory
    from genhancer_tpu_torch.tasks.image import build_modules, trainable_predicate
    from genhancer_tpu_torch.train.config import load_config
    spec, _, _ = factory.build_spec(load_config(CONFIG))
    trains = trainable_predicate(spec)
    return [(n, tuple(p.shape), p.dtype)
            for n, p in build_modules(spec, device="meta").named_parameters() if trains(n)]


def phase_adamw():
    """K3 against fused_adamw_leaf_ref, within one ulp of the storage dtype,
    on the DiT's largest leaves and odd shapes; then one whole-state update
    over every trainable leaf of the flux-dev stage-1 state, kernel against
    plain.  Returns the K3 record."""
    import torch
    from genhancer_tpu_torch.core.kernels import adamw as KA

    gen = torch.Generator(device="cuda")
    gen.manual_seed(99)
    bf16, f32 = torch.bfloat16, torch.float32
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
    count = 3
    sc = torch.tensor([0.37, 1e-4, 1 / (1 - 0.9 ** count), 1 / (1 - 0.999 ** count)],
                      dtype=f32, device="cuda")
    rec = _record("fused_adamw")
    rec["max_ulps"] = 0.0
    cases = (("single_blocks.linear1.weight", (21504, 3072), bf16),
             ("single_blocks.linear2.weight", (3072, 15360), bf16),
             ("double_blocks.img_attn.qkv.weight", (9216, 3072), bf16),
             ("f32 projector-like [4096, 1024]", (4096, 1024), f32),
             ("project_t5.3.weight", (4096, 4096), f32),
             ("1-D bias", (3072,), bf16), ("rows not a multiple of 8", (1003, 64), bf16))
    for what, shape, dtype in cases:
        p, m = (_rand(gen, shape, dtype) for _ in range(2))
        v = _rand(gen, shape, dtype).abs() * 1e-2
        g = torch.randn(shape, generator=gen, device="cuda", dtype=f32)
        want = KA.fused_adamw_leaf_ref(p, m, v, g, sc, **hyper)
        KA.fused_adamw_leaf(p, m, v, g, sc, **hyper)
        torch.cuda.synchronize()
        diff, ulps, err = 0, 0.0, 0.0
        for got, w in zip((p, m, v), want):
            diff += int((got != w).sum().item())
            ulps = max(ulps, KA.ulp_distance(got, w).max().item())
            err = max(err, (got.float() - w.float()).abs().max().item())
        print(f"[kernels] fused_adamw {what} {shape} {str(dtype)[6:]}, f32 grads: "
              f"{diff} of {3 * p.numel()} p/m/v elements differ, max {ulps:.2f} ulp "
              f"(bound 1 ulp), max abs {err:.3e}")
        check(ulps <= 1.0, f"fused_adamw {what}: {ulps} ulp")
        rec["max_ulps"] = max(rec["max_ulps"], ulps)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        del p, m, v, g, want

    leaves = _stage1_trainable_shapes()
    state = [(_rand(gen, s, dt), _rand(gen, s, dt), _rand(gen, s, dt).abs() * 1e-2,
              torch.randn(s, generator=gen, device="cuda", dtype=f32))
             for _, s, dt in leaves]
    n_param = sum(t[0].numel() for t in state)
    n_bytes = sum(t[0].numel() * (6 * t[0].element_size() + 4) for t in state)

    def kernel_update():
        for p, m, v, g in state:
            KA.fused_adamw_leaf(p, m, v, g, sc, **hyper)

    def plain_update():
        for p, m, v, g in state:
            for dst, src in zip((p, m, v), KA.fused_adamw_leaf_ref(p, m, v, g, sc, **hyper)):
                dst.copy_(src)

    ms, pms = kernel_vs_plain_ms(kernel_update, plain_update, n=3, rounds=4)
    rec["ms"], rec["plain_ms"] = ms, pms
    _set_bound(rec, n_bytes)
    rec["library_ms"] = _fused_adamw_library_ms(state, hyper)
    rate = n_bytes / (ms * 1e-3)
    print(f"[kernels] fused_adamw whole stage-1 state: {len(leaves)} leaves, "
          f"{n_param / 1e9:.4f} B params, {n_bytes / 1e9:.2f} GB moved per update "
          f"(read p, m, v, g; write p, m, v); kernel {ms:.3f} ms = {rate / 1e12:.3f} TB/s "
          f"= {rate / HBM_PEAK:.1%} of the 3.35 TB/s HBM peak; plain {pms:.3f} ms; bound "
          f"{rec['bound_ms']:.3f} ms (bytes); torch._fused_adamw_ {rec['library_ms']:.3f} ms")
    rec["leaves"] = len(leaves)
    del state
    torch.cuda.empty_cache()
    return rec


def _fused_adamw_library_ms(state, hyper) -> float:
    """``torch._fused_adamw_`` (PyTorch's fused AdamW, one call per dtype
    group) on the same leaves, grads cast to the parameter dtype first (it
    takes no float32 grads for bfloat16 params; the cast is outside the
    timing); the same hyper-parameters.  Timed here only."""
    import torch
    groups = {}
    for p, m, v, g in state:
        groups.setdefault(p.dtype, []).append((p, g.to(p.dtype), m, v,
                                               torch.tensor(3.0, device="cuda")))
    groups = [[list(x) for x in zip(*leaves)] for leaves in groups.values()]

    def call():
        for ps, gs, ms, vs, steps in groups:
            torch._fused_adamw_(ps, gs, ms, vs, [], steps, lr=1e-4, beta1=hyper["b1"],
                                beta2=hyper["b2"], weight_decay=hyper["wd"], eps=hyper["eps"],
                                amsgrad=False, maximize=False)
    ms = _library_ms(call, n=3)
    del groups
    return ms


# the K7 widths of the flux-dev DiT's SwitchBack inputs and gradients, and
# the CLIP-L tower's int8 linears (T = 32 x 257 tokens)
ROWQUANT_C = (768, 3072, 4096, 6144, 9216, 12288, 15360, 18432, 21504)
# K7's timed calls (T, C, column-scaled), bfloat16: the DiT's 3072 (the
# kernel table's row), the tower's 1024, the widest gradient, a T = 32 gradient
K7_TIMED = ((6304, 3072, False), (32 * 257, 1024, False), (6304, 21504, True),
            (32, 18432, True))


def _halfway_rows(t, c, scale, dtype):
    """[t, c] rows whose elements are scale * (k + 0.5), k in [-127, 126],
    with the row maximum 127 * scale: s = scale and every element lies
    half-way between two codes, where K7 must redo the code with the IEEE
    division (at scale 7 the product with 1 / s rounds some the wrong way)."""
    import torch
    k = (torch.arange(t * c, device="cuda") % 254 - 127).reshape(t, c).to(torch.float32)
    x = (k + 0.5) * scale
    x[:, 0] = 127.0 * scale
    return x.to(dtype)


def _k7_cases(gen):
    """(label, x, column scales to try) of K7's bit-for-bit checks: every body
    (warp, block, cluster, scalar) at the int8 paths' widths, ragged and
    misaligned inputs, and planted half-way rows."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32

    def both(c):
        return None, torch.rand(c, generator=gen, device="cuda") + 0.5

    def view_past16(t, c, dtype):   # contiguous, its base one element past 16 bytes
        return _rand(gen, (t * c + 1,), dtype)[1:].view(t, c)

    shapes = ([(6304, c, bf16) for c in ROWQUANT_C] + [(6304, c, f32) for c in (3072, 18432)]
              + [(32 * 257, 1024, bf16), (32 * 257, 4096, bf16)]
              + [(32, c, bf16) for c in (768, 3072, 4096, 9216, 12288, 18432)]
              + [(32, 18432, f32), (777, 3000, bf16), (777, 777, bf16), (5, 60000, f32),
                 (300, 60000, f32), (3, 200000, bf16)])
    for t, c, dtype in shapes:
        yield (f"[{t}, {c}] {str(dtype)[6:]}", lambda t=t, c=c, d=dtype: _rand(gen, (t, c), d),
               both(c))
    for t, c, dtype in ((6304, 3072, bf16), (777, 3000, f32), (32, 18432, bf16)):
        yield (f"[{t}, {c}] {str(dtype)[6:]} view 1 element past 16 bytes",
               lambda t=t, c=c, d=dtype: view_past16(t, c, d), both(c))
    yield ("[300, 3072] bf16, column scales 1 element past 16 bytes",
           lambda: _rand(gen, (300, 3072), bf16),
           ((torch.rand(3073, generator=gen, device="cuda") + 0.5)[1:],))
    for t, c, scale, dtype in ((256, 3072, 1.0, bf16), (256, 3072, 7.0, f32),
                               (512, 1024, 7.0, f32), (512, 9216, 7.0, f32),
                               (32, 18432, 7.0, f32), (300, 777, 7.0, f32)):
        yield (f"[{t}, {c}] {str(dtype)[6:]} half-way rows, s = {scale:g}",
               lambda t=t, c=c, sc=scale, d=dtype: _halfway_rows(t, c, sc, d), (None,))
    yield ("[256, 3072] bf16 half-way rows, s = 7 from the column scale",
           lambda: _halfway_rows(256, 3072, 1.0, bf16),
           (torch.full((3072,), 7.0, device="cuda"),))


def _k7(gen):
    """K7 against rowquant_ref, bit for bit (codes and scales) on every case
    of ``_k7_cases``; kernel, plain and bound ms at ``K7_TIMED``, the device
    ms of the [6304, 3072] call from a CUDA graph, and the host's enqueue
    time per call at T = 32.  Returns K7's record."""
    import torch
    from genhancer_tpu_torch.core.kernels import rowquant as K7
    rec = _record("rowquant")
    bad, n_checks = [], 0
    for label, make, scales in _k7_cases(gen):
        x = make()
        t, c = x.shape
        aligned = x.data_ptr() % 16 == 0
        for col in scales:
            tl = K7.rowquant_tiling(t, c, x.element_size(),
                                    aligned and (col is None or col.data_ptr() % 16 == 0))
            q, sc = K7.rowquant(x, col)
            torch.cuda.synchronize()
            rq, rs = K7.rowquant_ref(x, col)
            n_diff = int((q != rq).sum()) + int((sc != rs).sum())
            rec["max_abs_err"] = max(rec["max_abs_err"], (q.int() - rq.int()).abs().max().item(),
                                     (sc - rs).abs().max().item())
            n_checks += 1
            print(f"[kernels] rowquant {label} cs={col is not None}: {tl.body} body "
                  f"(threads {tl.threads}, cluster {tl.cluster}, units {tl.units}), "
                  f"{n_diff} codes/scales differ", flush=True)
            if n_diff:
                bad.append((label, col is not None, n_diff))
        del x
    print(f"[kernels] rowquant: {n_checks} calls: {bad or 'every code and scale equal to the '
                                                     'plain version'} (bound 0)", flush=True)
    check(not bad, f"K7 differs from the plain version: {bad}")

    for t, c, with_cs in K7_TIMED:
        x = _rand(gen, (t, c), torch.bfloat16)
        col = torch.rand(c, generator=gen, device="cuda") + 0.5 if with_cs else None
        ms, pms = kernel_vs_plain_ms(lambda: K7.rowquant(x, col), lambda: K7.rowquant_ref(x, col))
        n_bytes = _nbytes(x) + t * c + 4 * t + (4 * c if with_cs else 0)
        bound = n_bytes / HBM_PEAK * 1e3
        extra = ""
        if (t, c, with_cs) == K7_TIMED[0]:
            rec["ms"], rec["plain_ms"] = ms, pms
            _set_bound(rec, n_bytes)
            dev = graph_ms(lambda: K7.rowquant(x, col))
            rec["device_ms"] = dev
            extra = f", device {_fmt(dev)} ms (CUDA graph)"
        print(f"[kernels] rowquant [{t}, {c}] bf16 cs={with_cs} "
              f"({K7.rowquant_tiling(t, c, 2, True).body} body): kernel {ms:.4f} ms"
              f"{extra}, plain {pms:.4f} ms, bound {bound:.4f} ms (bytes), "
              f"{bound / ms:.1%} of the bound; no library call quantizes rows to int8 with "
              "their own amax in one call", flush=True)
        del x

    x = _rand(gen, (32, 3072), torch.bfloat16)
    for _ in range(10):
        K7.rowquant(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        K7.rowquant(x)
    enqueue_us = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    dev = graph_ms(lambda: K7.rowquant(x))
    print(f"[kernels] rowquant [32, 3072] bf16: host enqueue {enqueue_us:.2f} us per call "
          f"(1000 unsynced calls), device {_fmt(dev)} ms per call (CUDA graph)", flush=True)
    return rec


def phase_kernels_int8():
    """K7 (``_k7``); K8 against int8_dw_ref within 1e-5 of max|plain| at T =
    6304 for every dW shape of the stage-1 DiT's SwitchBack layers, at the
    modulation layers' T = 32, at ragged T and on float32 inputs, its
    quantization workspace bit for bit against the plain per-block
    quantization.  Returns the K7 and K8 records."""
    import torch
    from genhancer_tpu_torch.core.kernels import int8_dw as K8

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2024)
    bf16, f32 = torch.bfloat16, torch.float32
    rec = {"rowquant": _k7(gen), "int8_dw": _record("int8_dw")}
    shapes = sorted({s for _, s in _int8_cache_shapes()})
    cases = ([(6304, o, i, bf16) for o, i in shapes]
             + [(32, 18432, 3072, bf16), (32, 9216, 3072, bf16), (777, 3072, 3072, bf16),
                (513, 3072, 768, bf16), (6304, 3072, 3072, f32), (32, 3072, 768, f32)])
    n_codes = 0
    for t, o, i, dtype in cases:
        g, x = _rand(gen, (t, o), dtype), _rand(gen, (t, i), dtype)
        dw, codes = K8.int8_dw_with_codes(g, x, f32)
        torch.cuda.synchronize()
        ref = K8.int8_dw_ref(g, x, f32)
        # the quantization pass against a plain per-block quantization, in
        # the K-major workspace layout, bit for bit
        bad = sum(int((a != b).sum())
                  for a, b in zip(codes, (*K8.block_codes_ref(g), *K8.block_codes_ref(x))))
        n_codes += bad
        check(bad == 0, f"K8 [{t}, {o}, {i}] {dtype}: {bad} workspace codes or scales differ "
              "from the plain per-block quantization")
        err = ((dw - ref).abs().max() / ref.abs().max()).item()
        n_diff = int((dw != ref).sum())
        rec["int8_dw"]["max_abs_err"] = max(rec["int8_dw"]["max_abs_err"],
                                            (dw - ref).abs().max().item())
        timing = ""
        if (t, o, i) == (6304, 12288, 3072):     # the double blocks' mlp.0, timed in bf16
            ms, pms = kernel_vs_plain_ms(lambda: K8.int8_dw(g, x, bf16),
                                         lambda: K8.int8_dw_ref(g, x, bf16), n=5, rounds=4)
            rec["int8_dw"]["ms"], rec["int8_dw"]["plain_ms"] = ms, pms
            _set_bound(rec["int8_dw"], _nbytes(g, x) + 2 * o * i, 2.0 * t * o * i, INT8_PEAK)
            # yardsticks, not K8's function: cuBLAS's int8 product of the same
            # codes with no per-block rescale, and the bf16 dW of dit_quant: none
            gq, xq = codes.gq, codes.xq
            int_mm = _library_ms(lambda: torch._int_mm(gq, xq.t()))
            bf16_dw = _library_ms(lambda: g.t() @ x)
            timing = (f"; bf16 out: kernel {ms:.4f} ms ({2.0 * t * o * i / ms / 1e9:.1f} TOPS, "
                      f"{rec['int8_dw']['bound_ms'] / ms:.1%} of the bound), plain {pms:.3f} ms, "
                      f"bound {rec['int8_dw']['bound_ms']:.4f} ms (operations); yardsticks: "
                      f"torch._int_mm on the same codes {int_mm:.4f} ms "
                      f"({2.0 * gq.shape[1] * o * i / int_mm / 1e9:.1f} TOPS), bf16 g.t() @ x "
                      f"{bf16_dw:.4f} ms; no library call quantizes per 512-row block in the "
                      "product")
        print(f"[kernels] int8_dw T={t} O={o} I={i} {str(dtype)[6:]}: max|kernel-plain|/max|plain| "
              f"{err:.3e} (bound 1e-5), {n_diff} of {o * i} dW elements differ from the plain "
              f"version, workspace codes and scales bit for bit{timing}", flush=True)
        check(err <= 1e-5, f"K8 [{t}, {o}, {i}]: error {err} > 1e-5")
        del g, x, dw, ref, codes
    print(f"[kernels] int8_dw: {len(cases)} shapes: {n_codes} workspace codes or scales differ "
          "from the plain per-block quantization (bound 0)", flush=True)
    _free()
    return rec


def _int8_cache_shapes():
    """(path, shape) of the flux-dev DiT weights whose int8 copy the
    optimizer keeps (``switchback_cache_paths``), from meta tensors."""
    import torch
    from genhancer_tpu_torch.core.quant import switchback_cache_paths
    flat = {n: torch.empty(s, device="meta") for n, s, _ in _stage1_trainable_shapes()}
    return [(p, tuple(flat[p].shape)) for p in switchback_cache_paths(flat)]


def _k4_edges(gen, sc, hyper, rec):
    """K4 bit for bit (p, m, v, codes, scales) where its body differs from
    the cached leaves': float32 p, bf16 grads, clusters of two and eight
    blocks per row, and the L2 path's rows: a ragged row, a row wider than
    the register path holds and a leaf whose base is not 16-byte aligned."""
    import torch
    from genhancer_tpu_torch.core.kernels import adamw as KA
    bf16, f32 = torch.bfloat16, torch.float32
    cases = (  # shape, p dtype, g dtype, base 16-byte aligned
        ((64, 3072), f32, f32, True), ((32, 15360), f32, bf16, True),
        ((64, 4096), bf16, bf16, True), ((16, 6144), bf16, f32, True),
        ((40, 777), bf16, f32, True), ((4, 40000), bf16, f32, True),
        ((2, 70000), bf16, f32, True),
        ((48, 3072), bf16, f32, False))
    bad = []
    for shape, pdt, gdt, aligned in cases:
        n = shape[0] * shape[1]
        # a misaligned leaf: contiguous views whose bases sit one element past 16 bytes
        p, m, v = (_rand(gen, shape, pdt) if aligned else _rand(gen, (n + 1,), pdt)[1:].view(shape)
                   for _ in range(3))
        v.abs_().mul_(1e-2)
        g = torch.randn(shape, generator=gen, device="cuda", dtype=f32).to(gdt)
        wq = torch.empty(shape, dtype=torch.int8, device="cuda")
        ws = torch.empty(shape[0], dtype=f32, device="cuda")
        want = KA.fused_adamw_quant_leaf_ref(p, m, v, g, sc, **hyper)
        KA.fused_adamw_quant_leaf(p, m, v, g, sc, wq, ws, **hyper)
        torch.cuda.synchronize()
        n_diff = sum(int((a != b).sum()) for a, b in zip((p, m, v, wq, ws), want))
        rec["max_abs_err"] = max(rec["max_abs_err"], *((a.float() - b.float()).abs().max().item()
                                                        for a, b in zip((p, m, v), want[:3])))
        if n_diff:
            bad.append((shape, str(pdt), str(gdt), aligned, n_diff))
    print(f"[kernels] fused_adamw_quant (K4) edges (shape, p, g, aligned) "
          f"{[(c[0], str(c[1])[6:], str(c[2])[6:], c[3]) for c in cases]}: "
          f"{bad or 'every output identical to the plain version'}", flush=True)
    check(not bad, f"K4 edges differ from the plain version: {bad}")


def _k6_edges(gen, sc, hyper, rec):
    """K6, both bodies, within its bounds where its body differs from the
    stage-1 leaves': float32 p with bf16 grads, clusters of two and of eight
    blocks per row, and the second path's leaves: a ragged row, a row wider
    than the register path holds and a p whose base is not 16-byte aligned."""
    import torch
    from genhancer_tpu_torch.core.kernels import adamw as KA
    bf16, f32 = torch.bfloat16, torch.float32
    cases = (  # shape, p dtype, g dtype, p's base 16-byte aligned
        ((64, 3072), f32, bf16, True), ((16, 6144), bf16, bf16, True),
        ((8, 24576), bf16, f32, True),
        ((40, 777), bf16, f32, True), ((4, 40000), bf16, f32, True),
        ((48, 3072), bf16, f32, False))
    bad = []
    for shape, pdt, gdt, aligned in cases:
        for quant in (False, True):
            n = shape[0] * shape[1]
            p = (_rand(gen, shape, pdt) if aligned
                 else _rand(gen, (n + 1,), pdt)[1:].view(shape))
            m8 = KA.m8_encode_m(torch.randn(shape, generator=gen, device="cuda") * 1e-3)
            v8 = KA.m8_encode_v(10.0 ** (torch.rand(shape, generator=gen, device="cuda") * 6 - 10))
            g = (torch.randn(shape, generator=gen, device="cuda") * 1e-3).to(gdt)
            wq = torch.empty(shape, dtype=torch.int8, device="cuda") if quant else None
            ws = torch.empty(shape[0], dtype=f32, device="cuda") if quant else None
            want = KA.fused_adamw8_leaf_ref(p, m8, v8, g, sc, quant=quant, **hyper)
            KA.fused_adamw8_leaf(p, m8, v8, g, sc, wq=wq, ws=ws, **hyper)
            torch.cuda.synchronize()
            dp = (p.float() - want[0].float()).abs().max().item()
            rec["max_abs_err"] = max(rec["max_abs_err"], dp)
            ok = dp <= 1e-6 and (not quant or (torch.equal(wq, want[3])
                                               and torch.equal(ws, want[4])))
            for got, w in ((m8, want[1]), (v8, want[2])):
                d = (got.q.int() - w.q.int()).abs()
                ok &= (d.max().item() <= 1 and (d > 0).float().mean().item() < 1e-3
                       and ((got.s - w.s).abs() <= 1e-6 * w.s.abs()).all().item())
            if not ok:
                bad.append((shape, str(pdt)[6:], str(gdt)[6:], aligned, quant))
    print(f"[kernels] fused_adamw8 (K6) edges (shape, p, g, aligned) x (both bodies) "
          f"{[(c[0], str(c[1])[6:], str(c[2])[6:], c[3]) for c in cases]}: "
          f"{bad or 'every output within the bounds'}", flush=True)
    check(not bad, f"K6 edges out of bounds: {bad}")


def _k6_paths_agree(gen, sc, hyper):
    """K6's register path and its second path (the same update on a copy of p
    one element past 16 bytes) on one leaf of each width of the 8-bit state,
    both bodies: every output bit for bit.  The register path takes fast
    paths for the division, square root, log2 and weight code and redoes the
    rare elements next to a rounding boundary; this shows that it gives the
    accurate arithmetic's bits."""
    import torch
    from genhancer_tpu_torch.core.kernels import adamw as KA
    shapes = {}
    for _, s, dt in _stage1_trainable_shapes():
        if KA.moment8_ok(torch.empty(s, device="meta")):
            shapes.setdefault(s[1], (s, dt))
    n_diff, n_bytes = 0, 0
    for shape, dt in shapes.values():
        for quant in (False, True):
            p = _rand(gen, shape, dt)
            m8 = KA.m8_encode_m(torch.randn(shape, generator=gen, device="cuda") * 1e-3)
            v8 = KA.m8_encode_v(10.0 ** (torch.rand(shape, generator=gen, device="cuda") * 6 - 10))
            g = torch.randn(shape, generator=gen, device="cuda") * 1e-3
            outs = []
            for second in (False, True):
                pp = (torch.empty(p.numel() + 1, dtype=dt, device="cuda")[1:].view(shape)
                      if second else torch.empty_like(p)).copy_(p)
                mm, vv = KA.Moment8(*(t.clone() for t in m8)), KA.Moment8(*(t.clone() for t in v8))
                wq = torch.empty(shape, dtype=torch.int8, device="cuda") if quant else None
                ws = torch.empty(shape[0], dtype=torch.float32, device="cuda") if quant else None
                KA.fused_adamw8_leaf(pp, mm, vv, g, sc, wq=wq, ws=ws, **hyper)
                outs.append([pp, *mm, *vv] + ([wq, ws] if quant else []))
            torch.cuda.synchronize()
            n_diff += sum(int((a.view(torch.uint8) != b.view(torch.uint8)).sum())
                          for a, b in zip(*outs))
            n_bytes += sum(_nbytes(a) for a in outs[0])
            del outs, p, m8, v8, g
    print(f"[kernels] fused_adamw8 register path vs second path, one leaf of each width "
          f"{sorted(shapes)} x both bodies: {n_diff} of {n_bytes} output bytes differ (bound 0)",
          flush=True)
    check(n_diff == 0, f"K6's two paths disagree in {n_diff} bytes")


def phase_adamw_int8():
    """K4 on every cached DiT leaf of the full stage-1 state (p, m, v within
    one ulp as K3's, wq and ws identical); K6 on the full state with 8-bit
    moments on the ``moment8_ok`` leaves, its quant body on the cached ones
    (codes identical or one apart at a rate below 1e-3, scales within 1e-6
    relative, p within 1e-6 absolute, the weight copy identical), on its
    edge shapes, and its two paths against each other bit for bit; then
    each whole update timed against its plain version, and each kernel's
    two paths in turns.  Returns the K4 and K6 records."""
    import torch
    from genhancer_tpu_torch.core.kernels import adamw as KA

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4242)
    bf16, f32 = torch.bfloat16, torch.float32
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
    count = 3
    sc = torch.tensor([0.37, 1e-4, 1 / (1 - 0.9 ** count), 1 / (1 - 0.999 ** count)],
                      dtype=f32, device="cuda")
    rec = {n: _record(n) for n in ("fused_adamw_quant", "fused_adamw8")}
    cache = dict(_int8_cache_shapes())
    leaves = [(n, s, dt) for n, s, dt in _stage1_trainable_shapes()]

    # K4: every cached leaf, bf16 p/m/v, f32 grads
    state = {n: (_rand(gen, s, bf16), _rand(gen, s, bf16), _rand(gen, s, bf16).abs() * 1e-2,
                 torch.randn(s, generator=gen, device="cuda", dtype=f32),
                 torch.empty(s, dtype=torch.int8, device="cuda"),
                 torch.empty(s[0], dtype=f32, device="cuda")) for n, s in cache.items()}
    diff, ulps = 0, 0.0
    for n, (p, m, v, g, wq, ws) in state.items():
        want = KA.fused_adamw_quant_leaf_ref(p, m, v, g, sc, **hyper)
        KA.fused_adamw_quant_leaf(p, m, v, g, sc, wq, ws, **hyper)
        torch.cuda.synchronize()
        for got, w in zip((p, m, v), want):
            ulps = max(ulps, KA.ulp_distance(got, w).max().item())
            rec["fused_adamw_quant"]["max_abs_err"] = max(
                rec["fused_adamw_quant"]["max_abs_err"], (got.float() - w.float()).abs().max().item())
        diff += int((wq != want[3]).sum()) + int((ws != want[4]).sum())
        del want
    print(f"[kernels] fused_adamw_quant (K4) on the {len(state)} cached DiT leaves: p/m/v max "
          f"{ulps:.2f} ulp (bound 1), {diff} int8 codes or scales differ (bound 0)", flush=True)
    check(ulps <= 1.0 and diff == 0, f"K4: {ulps} ulp, {diff} codes or scales differ")
    _k4_edges(gen, sc, hyper, rec["fused_adamw_quant"])

    def k4():
        for p, m, v, g, wq, ws in state.values():
            KA.fused_adamw_quant_leaf(p, m, v, g, sc, wq, ws, **hyper)

    def k4_plain():
        for p, m, v, g, wq, ws in state.values():
            for dst, src in zip((p, m, v, wq, ws),
                                KA.fused_adamw_quant_leaf_ref(p, m, v, g, sc, **hyper)):
                dst.copy_(src)

    r = rec["fused_adamw_quant"]
    r["ms"], r["plain_ms"] = kernel_vs_plain_ms(k4, k4_plain, n=3, rounds=4)
    _set_bound(r, sum(_nbytes(*t) + _nbytes(*t[:3]) for t in state.values()))
    r["library_ms"] = _fused_adamw_library_ms([t[:4] for t in state.values()], hyper)
    print(f"[kernels] fused_adamw_quant whole cache ({len(state)} leaves): kernel "
          f"{r['ms']:.4f} ms ({r['bound_ms'] / r['ms']:.1%} of the bound), plain "
          f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms (bytes), torch._fused_adamw_ "
          f"(no int8 copy) {r['library_ms']:.4f} ms", flush=True)

    # the same update on the L2 path: each p on a base one element past 16 bytes
    shifted = []
    for p, *rest in state.values():
        ps = torch.empty(p.numel() + 1, dtype=p.dtype, device="cuda")[1:].view(p.shape)
        shifted.append((ps.copy_(p), *rest))

    def k4_l2():
        for p, m, v, g, wq, ws in shifted:
            KA.fused_adamw_quant_leaf(p, m, v, g, sc, wq, ws, **hyper)

    reg_ms, l2_ms = kernel_vs_plain_ms(k4, k4_l2, n=3, rounds=4)
    print(f"[kernels] fused_adamw_quant whole cache, in turns: register path {reg_ms:.4f} ms, "
          f"L2 path (p misaligned) {l2_ms:.4f} ms", flush=True)
    del state, shifted
    _free()

    # K6: the full state with 8-bit moments where moment8_ok
    state = []
    for n, s, dt in leaves:
        if not KA.moment8_ok(torch.empty(s, device="meta")):
            continue
        p = _rand(gen, s, dt)
        m8 = KA.m8_encode_m(torch.randn(s, generator=gen, device="cuda") * 1e-3)
        v8 = KA.m8_encode_v(10.0 ** (torch.rand(s, generator=gen, device="cuda") * 6 - 10))
        g = torch.randn(s, generator=gen, device="cuda") * 1e-3
        wq, ws = ((torch.empty(s, dtype=torch.int8, device="cuda"),
                   torch.empty(s[0], dtype=f32, device="cuda")) if n in cache else (None, None))
        state.append((p, m8, v8, g, wq, ws))
    worst = {"p": 0.0, "codes": 0, "rate": 0.0, "scale": 0.0, "wq": 0}
    for p, m8, v8, g, wq, ws in state:
        want = KA.fused_adamw8_leaf_ref(p, m8, v8, g, sc, quant=wq is not None, **hyper)
        KA.fused_adamw8_leaf(p, m8, v8, g, sc, wq=wq, ws=ws, **hyper)
        torch.cuda.synchronize()
        worst["p"] = max(worst["p"], (p.float() - want[0].float()).abs().max().item())
        for got, w in ((m8, want[1]), (v8, want[2])):
            d = (got.q.int() - w.q.int()).abs()
            worst["codes"] = max(worst["codes"], d.max().item())
            worst["rate"] = max(worst["rate"], (d > 0).float().mean().item())
            worst["scale"] = max(worst["scale"], ((got.s - w.s).abs()
                                                  / w.s.abs().clamp_min(1e-30)).max().item())
        if wq is not None:
            worst["wq"] += int((wq != want[3]).sum()) + int((ws != want[4]).sum())
        del want
    rec["fused_adamw8"]["max_abs_err"] = worst["p"]
    n_quant = sum(1 for t in state if t[4] is not None)
    print(f"[kernels] fused_adamw8 (K6) on {len(state)} leaves ({n_quant} with the int8 weight "
          f"copy): p max|kernel-plain| {worst['p']:.3e} (bound 1e-6), codes max diff "
          f"{worst['codes']} at a rate of at most {worst['rate']:.3e} (bounds 1, 1e-3), scales "
          f"{worst['scale']:.3e} relative (bound 1e-6), weight copy {worst['wq']} differ "
          "(bound 0)", flush=True)
    check(worst["p"] <= 1e-6 and worst["codes"] <= 1 and worst["rate"] < 1e-3
          and worst["scale"] <= 1e-6 and worst["wq"] == 0, f"K6 disagrees: {worst}")

    _k6_edges(gen, sc, hyper, rec["fused_adamw8"])
    _k6_paths_agree(gen, sc, hyper)

    def k6():
        for p, m8, v8, g, wq, ws in state:
            KA.fused_adamw8_leaf(p, m8, v8, g, sc, wq=wq, ws=ws, **hyper)

    def k6_plain():
        for p, m8, v8, g, wq, ws in state:
            out = KA.fused_adamw8_leaf_ref(p, m8, v8, g, sc, quant=wq is not None, **hyper)
            for dst, src in zip((p, *m8, *v8) + ((wq, ws) if wq is not None else ()),
                                (out[0], *out[1], *out[2], *out[3:])):
                dst.copy_(src)

    r = rec["fused_adamw8"]
    r["ms"], r["plain_ms"] = kernel_vs_plain_ms(k6, k6_plain, n=3, rounds=4)
    _set_bound(r, sum(_nbytes(p, *m8, *v8, g) + _nbytes(p, *m8, *v8)
                      + (_nbytes(wq, ws) if wq is not None else 0)
                      for p, m8, v8, g, wq, ws in state))
    print(f"[kernels] fused_adamw8 whole 8-bit state ({len(state)} leaves): kernel "
          f"{r['ms']:.4f} ms ({r['bound_ms'] / r['ms']:.1%} of the bound), plain "
          f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms (bytes); no library call keeps "
          "log-coded 8-bit moments", flush=True)

    # the same update on the second path: each p on a base one element past 16 bytes
    shifted = []
    for p, *rest in state:
        ps = torch.empty(p.numel() + 1, dtype=p.dtype, device="cuda")[1:].view(p.shape)
        shifted.append((ps.copy_(p), *rest))

    def k6_second():
        for p, m8, v8, g, wq, ws in shifted:
            KA.fused_adamw8_leaf(p, m8, v8, g, sc, wq=wq, ws=ws, **hyper)

    reg_ms, second_ms = kernel_vs_plain_ms(k6, k6_second, n=3, rounds=4)
    print(f"[kernels] fused_adamw8 whole 8-bit state, in turns: register path {reg_ms:.4f} ms, "
          f"second path (p misaligned) {second_ms:.4f} ms", flush=True)
    del state, shifted
    _free()
    return rec


def _tiny_spec():
    import torch
    from genhancer_tpu_torch.models import dit as dm
    from genhancer_tpu_torch.models import vae as vm
    from genhancer_tpu_torch.models.towers import clip as cm
    from genhancer_tpu_torch.tasks.image import TaskSpec
    return TaskSpec(
        stage="stage1", tower_kind="clip", img_size=32, clip_image_size=32,
        dit_cfg=dm.DiTConfig(in_channels=16, vec_in_dim=24, context_in_dim=32,
                             hidden_size=64, num_heads=4, depth=1,
                             depth_single_blocks=1, axes_dim=(4, 6, 6)),
        vae_cfg=vm.VAEConfig(resolution=32, ch=8, ch_mult=(1, 2), num_res_blocks=1,
                             z_channels=4),
        tower_cfg=cm.CLIPConfig(vision=cm.CLIPVisionConfig(
            hidden_size=16, intermediate_size=32, num_layers=1, num_heads=2,
            image_size=32, patch_size=16), projection_dim=24),
        clip_dim=24, t5_dim=32, compute_dtype=torch.float32)


def phase_small_reference():
    """Tiny engine: CUDA (kernels) vs CPU (plain versions), same weights.
    float32 compute: the two differ by summation order only (bound 1e-3
    over the composed tower, 2 Euler steps and the VAE)."""
    import numpy as np
    import torch
    from genhancer_tpu_torch.serve.engine import InferenceEngine
    from genhancer_tpu_torch.tasks.image import init_modules

    spec = _tiny_spec()
    mods = init_modules(spec, torch.Generator().manual_seed(5))
    sd = {k: v.clone() for k, v in mods.state_dict().items()}
    cpu = InferenceEngine(spec, mods, device="cpu", buckets=(2,), num_steps=2)
    mods_gpu = init_modules(spec, torch.Generator().manual_seed(6))
    mods_gpu.load_state_dict(sd, strict=True)
    gpu = InferenceEngine(spec, mods_gpu, device="cuda", buckets=(2,), num_steps=2)
    img = np.random.default_rng(7).random((2, 32, 32, 3), dtype=np.float32)
    noise = torch.randn((2, *spec.latent_hw, spec.vae_cfg.z_channels),
                        generator=torch.Generator().manual_seed(8))
    e_err = np.abs(gpu.embed(img) - cpu.embed(img)).max()
    r_gpu = gpu._recon(gpu._place(img), noise.cuda()).cpu().numpy()
    r_cpu = cpu._recon(cpu._place(img), noise).numpy()
    r_err = np.abs(r_gpu - r_cpu).max()
    print(f"[small] tiny engine cuda vs cpu: embed max err {e_err:.3e}, "
          f"reconstruct max err {r_err:.3e} (bound 1e-3)")
    check(e_err <= 1e-3 and r_err <= 1e-3, "tiny engine: CUDA and CPU disagree")


def _jpeg(rng, h, w):
    import numpy as np
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(
        buf, format="JPEG", quality=95)
    return buf.getvalue()


def _post(url, body):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "image/jpeg"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.headers["Content-Type"], r.read()


def phase_server():
    """Full-width engine behind HTTP; returns the K1/K2 launch counts of the
    served requests."""
    import numpy as np
    import torch
    from PIL import Image
    from genhancer_tpu_torch.serve.engine import InferenceEngine
    from genhancer_tpu_torch.serve.http import ServeApp

    t0 = time.perf_counter()
    engine = InferenceEngine.from_config(CONFIG, device="cuda", buckets=BUCKETS,
                                         num_steps=NUM_STEPS, wire_dtype="uint8")
    torch.cuda.synchronize()
    n = {k: sum(p.numel() for p in m.parameters())
         for k, m in (("dit", engine.modules["dit"]), ("vae", engine.modules["vae"]),
                      ("tower", engine.modules["clip"]["model"]))}
    cfg = engine.spec.dit_cfg
    print(f"[server] engine built in {time.perf_counter() - t0:.1f} s: DiT "
          f"{n['dit'] / 1e9:.3f} B params bf16 (hidden {cfg.hidden_size}, "
          f"{cfg.num_heads} heads, {cfg.depth}+{cfg.depth_single_blocks} blocks), "
          f"tower {n['tower'] / 1e9:.3f} B f32, VAE {n['vae'] / 1e6:.1f} M f32")
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    SERVE_BF16["peak"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"[server] warmup of buckets {BUCKETS} in {time.perf_counter() - t0:.1f} s; "
          f"peak memory {SERVE_BF16['peak']:.2f} GiB")

    # the float32 wire on the same modules: reconstructed pixels are finite
    f32_engine = InferenceEngine(engine.spec, engine.modules, device="cuda",
                                 buckets=(1,), num_steps=NUM_STEPS, wire_dtype="float32")
    rng = np.random.default_rng(0)
    probe = f32_engine.reconstruct(rng.random((1, 224, 224, 3), dtype=np.float32), seed=1)
    check(probe.shape == (1, 224, 224, 3) and np.isfinite(probe).all(),
          "float32-wire reconstruct: non-finite or misshapen output")
    print(f"[server] float32-wire reconstruct: finite, mean {probe.mean():.4f}, "
          f"std {probe.std():.4f}")

    _zero_counts()
    app = ServeApp(engine, max_wait_ms=100.0)
    server = app.make_server("127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    replies, errors = {}, []

    def client(i, path, body):
        try:
            replies[(path, i)] = _post(base + path, body)
        except Exception as e:  # reported below as a failed phase
            errors.append(f"{path} #{i}: {e!r}")

    n_req = 8
    bodies = [_jpeg(rng, 240 + 8 * i, 320 - 8 * i) for i in range(n_req)]
    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=client, args=(i, p, bodies[i]))
                   for i in range(n_req) for p in ("/v1/reconstruct", "/v1/embed")]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        with urllib.request.urlopen(base + "/v1/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        app.close()
        thread.join(timeout=30)
    counts = _read_counts()
    check(not errors, f"requests failed: {errors}")
    check(len(replies) == 2 * n_req, f"{len(replies)} of {2 * n_req} replies")
    for (path, i), (status, ctype, data) in sorted(replies.items()):
        check(status == 200, f"{path} #{i}: HTTP {status}")
        if path == "/v1/reconstruct":
            check(ctype == "image/jpeg", f"reconstruct #{i}: {ctype}")
            check(Image.open(io.BytesIO(data)).size == (224, 224), f"reconstruct #{i}: size")
        else:
            emb = json.loads(data)
            vec = np.asarray(emb["embedding"], np.float32)
            check(emb["dim"] == 768 and vec.shape == (768,) and np.isfinite(vec).all(),
                  f"embed #{i}: {emb['dim']} / finite {np.isfinite(vec).all()}")
    hist = {ep: {int(k): v for k, v in stats[ep]["batch_histogram"].items()}
            for ep in ("reconstruct", "embed")}
    batches = {ep: sum(h.values()) for ep, h in hist.items()}
    print(f"[server] {2 * n_req} HTTP requests in {wall:.2f} s; batch histograms "
          f"(size: count) {hist}; latency p50 reconstruct "
          f"{stats['reconstruct']['latency_ms']['p50']} ms, embed "
          f"{stats['embed']['latency_ms']['p50']} ms")
    check(max(max(h) for h in hist.values()) > 1, "no request was batched with another")
    check(all(stats[ep]["requests"] == n_req and stats[ep]["errors"] == 0 for ep in hist),
          f"stats: {stats}")
    want = {**_no_launches(),
            "fused_rope_attention": batches["reconstruct"] * NUM_STEPS * (cfg.depth + cfg.depth_single_blocks),
            "fused_attention": (batches["reconstruct"] + batches["embed"])
            * engine.spec.tower_cfg.vision.num_layers}
    print(f"[server] kernel launches {counts}, expected {want}")
    check(counts == want, f"launch counts {counts} != expected {want}")

    for b in BUCKETS:
        imgs = (rng.random((b, 224, 224, 3)) * 255).astype(np.uint8)
        rec_s = []
        for r in range(3):
            t0 = time.perf_counter()
            engine.reconstruct(imgs, seed=r)
            rec_s.append(time.perf_counter() - t0)
        emb_s = []
        for _ in range(10):
            t0 = time.perf_counter()
            engine.embed(imgs)
            emb_s.append(time.perf_counter() - t0)
        rs, es = statistics.median(rec_s), statistics.median(emb_s)
        SERVE_BF16[b] = (rs, es)
        print(f"[server] bucket {b}: reconstruct {rs * 1e3:.1f} ms/batch = "
              f"{b / rs:.2f} img/s ({NUM_STEPS} steps, uint8 wire); embed "
              f"{es * 1e3:.2f} ms/batch = {b / es:.1f} img/s")
    del engine, f32_engine, app, server
    _free()
    return counts


def _counters():
    from genhancer_tpu_torch.core.kernels import adamw as KA
    from genhancer_tpu_torch.core.kernels import flash_attention as F
    from genhancer_tpu_torch.core.kernels import int8_dw as K8
    from genhancer_tpu_torch.core.kernels import rowquant as K7
    from genhancer_tpu_torch.core.kernels import short_attention as K
    return (K.LAUNCHES, F.LAUNCHES, KA.LAUNCHES, K7.LAUNCHES, K8.LAUNCHES)


def _no_launches():
    """Every launch counter at 0: the base of an expected-count table."""
    return {k: 0 for table in _counters() for k in table}


def _zero_counts():
    for table in _counters():
        for key in table:
            table[key] = 0


def _read_counts():
    return {k: v for table in _counters() for k, v in table.items()}


def _free():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _tiny_step_card_vs_cpu(label, make_state, loss_fn, micro, stacked, draws, lr,
                           noise_ref=None, null=()):
    """One tiny float32 step (accumulation 2) on the card (kernels) against
    the same weights, batch and injected draws on the CPU (plain versions):
    the first micro-batch's loss and every gradient within 1e-4 relative
    (norm-wise per leaf), the params after the step within 2*lr*(1 + 1e-3)
    absolute — AdamW's first update is about lr*sign(g) per element, so
    where a gradient is near zero its sign can differ between the two
    devices' summation orders and move a parameter by up to 2*lr.
    ``noise_ref`` (an int8 step): (loss, grads) of the same step without
    int8 on the CPU; the loss and each leaf's gradient may then differ
    between the devices by up to twice the int8 noise of the CPU run
    (|int8 - float|), where that exceeds 1e-4.  A leaf whose path ends
    with one of ``null`` has a gradient of 0 in exact arithmetic (a key
    bias: the softmax ignores a constant added to a row), so roundoff on
    both devices: its error is taken against the largest gradient norm of
    any leaf instead of its own.  A leaf the loss does not reach (the
    stage-2 text side) has a zero gradient on both.  Draws may hold lists
    (the LoRA dropout masks).  Returns the launch counts of the card's first
    forward + backward."""
    import torch
    from genhancer_tpu_torch.train.step_utils import make_accum_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    losses, grads, before, after, launches = {}, {}, {}, {}, None
    for dev in ("cpu", "cuda"):
        state, opt = make_state(dev)

        def to(arrays):
            return {k: ([torch.from_numpy(x).to(dev) for x in v] if isinstance(v, list)
                        else torch.from_numpy(v).to(dev)) for k, v in arrays.items()}

        if dev == "cuda":
            _zero_counts()
        loss = loss_fn(state.modules, to(micro), None, to(draws[0]))
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = _read_counts()
        losses[dev] = loss.item()
        grads[dev] = {k: (p.grad.detach().cpu().clone() if p.grad is not None
                          else torch.zeros(p.shape, dtype=p.dtype))
                      for k, p in state.trainable.items()}
        before[dev] = {k: p.detach().cpu().clone() for k, p in state.trainable.items()}
        for p in state.trainable.values():
            p.grad = None
        make_accum_train_step(loss_fn, opt, 2)(state, to(stacked), None, [to(d) for d in draws])
        after[dev] = {k: p.detach().cpu() for k, p in state.trainable.items()}
        del state
    l_err = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    # per leaf, ||g_cuda - g_cpu|| / ||g_cpu||; the elementwise worst case
    # (relative to the leaf's largest entry) is printed beside it
    g_top = max(g.norm().item() for g in grads["cpu"].values())
    g_rel = {k: ((grads["cuda"][k] - g).norm()
                 / (g_top if k.endswith(tuple(null)) else g.norm().clamp_min(1e-30))).item()
             for k, g in grads["cpu"].items()}
    g_max = {k: (grads["cuda"][k] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
             for k, g in grads["cpu"].items()}
    l_bound, g_bound = 1e-4, {k: 1e-4 for k in g_rel}
    if noise_ref is not None:
        ref_loss, ref_grads = noise_ref
        l_bound = max(l_bound, 2 * abs(losses["cpu"] - ref_loss) / abs(losses["cpu"]))
        g_bound = {k: max(1e-4, 2 * ((g - ref_grads[k]).norm() / g.norm().clamp_min(1e-30)).item())
                   for k, g in grads["cpu"].items()}
    worst, worst_max = max(g_rel, key=g_rel.get), max(g_max, key=g_max.get)
    tight = max(g_rel, key=lambda k: g_rel[k] / g_bound[k])
    p_err = max((after["cuda"][k] - p).abs().max().item() for k, p in after["cpu"].items())
    moved = max((after["cpu"][k] - p).abs().max().item() for k, p in before["cpu"].items())
    bound = 2 * lr * (1 + 1e-3)
    print(f"[small] {label}: loss cuda vs cpu rel {l_err:.3e} (bound {l_bound:.3e}); grads "
          f"||cuda-cpu||/||cpu|| worst leaf {worst} {g_rel[worst]:.3e} (bound {g_bound[worst]:.3e}),"
          f" median leaf {statistics.median(g_rel.values()):.3e}, closest to its bound {tight} "
          f"{g_rel[tight]:.3e} of {g_bound[tight]:.3e}; elementwise max/leaf max "
          f"worst {worst_max} {g_max[worst_max]:.3e}; params after one accumulation-2 step "
          f"max|cuda-cpu| {p_err:.3e} (bound {bound:.4g}; the step moved them up to "
          f"{moved:.3e})", flush=True)
    check(l_err <= l_bound and all(g_rel[k] <= g_bound[k] for k in g_rel),
          f"{label}: loss/grads disagree")
    check(p_err <= bound, f"{label}: params disagree by {p_err}")
    _free()
    return launches


def phase_small_train():
    """One tiny float32 image stage-1 step of each optimizer, card against
    CPU (``_tiny_step_card_vs_cpu``)."""
    import numpy as np
    import torch
    from genhancer_tpu_torch.tasks.image import (create_state, init_modules, make_loss_fn,
                                                 trainable_predicate)
    from genhancer_tpu_torch.train import optim

    spec = dataclasses.replace(_tiny_spec(), dit_param_dtype=torch.float32,
                               vae_dtype=torch.float32)
    lr = 1e-3
    rng = np.random.default_rng(11)
    lat = spec.latent_hw
    n_tok = (lat[0] // 2) * (lat[1] // 2)
    imgs = rng.random((2, 2, 32, 32, 3), dtype=np.float32)
    draws = [{"t": rng.random(2, dtype=np.float32),
              "x0": rng.standard_normal((2, n_tok, 4 * spec.vae_cfg.z_channels),
                                        dtype=np.float32),
              "vae_noise": rng.standard_normal((2, *lat, spec.vae_cfg.z_channels),
                                               dtype=np.float32)} for _ in range(2)]
    for name, cls in (("chain", optim.AdamWChain), ("pallas", optim.FusedAdamW)):
        def make_state(dev, cls=cls):
            mods = init_modules(spec, torch.Generator().manual_seed(5)).to(dev)
            opt = cls(optim.make_lr_schedule("constant", lr))
            return create_state(mods, trainable_predicate(spec), opt), opt

        _tiny_step_card_vs_cpu(f"tiny f32 train step, {name}", make_state, make_loss_fn(spec),
                               {"image": imgs[0]}, {"image": imgs}, draws, lr)


def phase_small_video():
    """One tiny float32 sliding-window stage-1 step (the default chain), card
    against CPU (``_tiny_step_card_vs_cpu``); the joint length is 3 x 4
    tower patches + 25 x 25 latent tokens = 637, so the card runs K5/K5b and
    the CPU their plain versions."""
    import numpy as np
    import torch
    from genhancer_tpu_torch.tasks import video as tv
    from genhancer_tpu_torch.train import optim

    tiny = _tiny_spec()
    spec = tv.VideoTaskSpec(mode="sliding", stage="stage1", tower_kind="clip", img_size=100,
                            clip_image_size=32, dit_cfg=tiny.dit_cfg, vae_cfg=tiny.vae_cfg,
                            tower_cfg=tiny.tower_cfg, clip_dim=24, t5_dim=32,
                            adapter_in_dim=16, compute_dtype=torch.float32,
                            dit_param_dtype=torch.float32, vae_dtype=torch.float32)
    lr = 1e-3
    rng = np.random.default_rng(12)
    lat = spec.latent_hw
    n_tok = (lat[0] // 2) * (lat[1] // 2)
    batch = {"cond": rng.random((2, 2, 3, 32, 32, 3), dtype=np.float32),
             "target": rng.random((2, 2, 100, 100, 3), dtype=np.float32),
             "valid": np.array([[True, True], [True, False]])}
    draws = [{"t": rng.random(2, dtype=np.float32),
              "x0": rng.standard_normal((2, n_tok, 4 * spec.vae_cfg.z_channels),
                                        dtype=np.float32),
              "vae_noise": rng.standard_normal((2, *lat, spec.vae_cfg.z_channels),
                                               dtype=np.float32)} for _ in range(2)]

    def make_state(dev):
        mods = tv.init_modules(spec, torch.Generator().manual_seed(5)).to(dev)
        opt = optim.AdamWChain(optim.make_lr_schedule("constant", lr))
        return tv.create_state(mods, tv.trainable_predicate(spec), opt), opt

    launches = _tiny_step_card_vs_cpu(
        f"tiny f32 sliding video step (joint L={n_tok + 12})", make_state,
        tv.make_loss_fn(spec), {k: v[0] for k, v in batch.items()}, batch, draws, lr)
    k5 = {k: launches[k] for k in ("flash_attention", "flash_attention_bwd")}
    print(f"[small] launches of the card's video forward + backward {k5}")
    check(k5 == {"flash_attention": 2, "flash_attention_bwd": 2},
          f"tiny video step: K5/K5b launches {k5}, expected 2 and 2")


def _plant_lora_b(tower, seed):
    """A nonzero B in every LoRA-wrapped module (at B = 0 the branch adds
    nothing and dA is 0)."""
    import torch
    from genhancer_tpu_torch.train import lora
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for path in lora.wrapped_paths(tower):
            b = tower.get_submodule(path).lora_B
            b.copy_(0.1 * torch.randn(b.shape, generator=g))


def phase_small_stage2():
    """One tiny float32 image stage-2 step of each stage (the default chain),
    card against CPU (``_tiny_step_card_vs_cpu``): a nonzero B planted in
    every wrapped linear, LoRA dropout 0.1 on the same injected masks; the
    card's tower backward runs K2b."""
    import numpy as np
    import torch
    from genhancer_tpu_torch.tasks.image import (create_state, init_modules, make_loss_fn,
                                                 trainable_predicate)
    from genhancer_tpu_torch.train import optim

    lr = 1e-3
    rng = np.random.default_rng(13)
    base = dataclasses.replace(_tiny_spec(), dit_param_dtype=torch.float32,
                               vae_dtype=torch.float32, lora_r=3, lora_alpha=16.0,
                               lora_dropout=0.1)
    v = base.tower_cfg.vision
    n_img = v.grid ** 2 + 1
    shapes = ([(2, n_img, v.hidden_size)] * 5 + [(2, n_img, v.intermediate_size)]) \
        * v.num_layers + [(2, v.hidden_size)]
    lat = base.latent_hw
    n_tok = (lat[0] // 2) * (lat[1] // 2)
    imgs = rng.random((2, 2, 32, 32, 3), dtype=np.float32)
    draws = [{"t": rng.random(2, dtype=np.float32),
              "x0": rng.standard_normal((2, n_tok, 4 * base.vae_cfg.z_channels),
                                        dtype=np.float32),
              "vae_noise": rng.standard_normal((2, *lat, base.vae_cfg.z_channels),
                                               dtype=np.float32),
              "lora_masks": [rng.random(sh) < 0.9 for sh in shapes]} for _ in range(2)]
    for stage in ("stage2_all", "stage2_only"):
        spec = dataclasses.replace(base, stage=stage)

        def make_state(dev, spec=spec):
            mods = init_modules(spec, torch.Generator().manual_seed(5))
            _plant_lora_b(mods["clip"]["model"], 6)
            opt = optim.AdamWChain(optim.make_lr_schedule("constant", lr))
            mods = mods.to(dev)
            return create_state(mods, trainable_predicate(spec, mods), opt), opt

        launches = _tiny_step_card_vs_cpu(
            f"tiny f32 image {stage} step", make_state, make_loss_fn(spec),
            {"image": imgs[0]}, {"image": imgs}, draws, lr, null=("self_attn.k_proj.bias",))
        k2 = {k: launches[k] for k in ("fused_attention", "fused_attention_bwd")}
        print(f"[small] launches of the card's {stage} forward + backward {k2}", flush=True)
        check(k2 == {"fused_attention": v.num_layers, "fused_attention_bwd": v.num_layers},
              f"tiny {stage} step: K2/K2b launches {k2}, expected {v.num_layers} each")


def phase_small_video_stage2():
    """One tiny float32 middle-mode stage-2 step (the default chain) with
    ``tower_remat`` on, card against CPU (``_tiny_step_card_vs_cpu``): a
    nonzero B planted in every wrapped linear, LoRA dropout 0.1 on the same
    injected masks, which the recompute in the backward must read again; the
    card runs K2 twice per layer (the forward and its recompute) and K2b
    once."""
    import numpy as np
    import torch
    from genhancer_tpu_torch.tasks import video as tv
    from genhancer_tpu_torch.train import optim

    tiny = _tiny_spec()
    spec = tv.VideoTaskSpec(mode="middle", stage="stage2_all", tower_kind="clip",
                            img_size=32, clip_image_size=32, dit_cfg=tiny.dit_cfg,
                            vae_cfg=tiny.vae_cfg, tower_cfg=tiny.tower_cfg, clip_dim=24,
                            t5_dim=32, adapter_in_dim=16, compute_dtype=torch.float32,
                            dit_param_dtype=torch.float32, vae_dtype=torch.float32,
                            lora_r=3, lora_alpha=16.0, lora_dropout=0.1, tower_remat=True)
    lr = 1e-3
    rng = np.random.default_rng(14)
    v = spec.tower_cfg.vision
    frames, n_img = 2 * spec.n_cond, v.grid ** 2 + 1
    shapes = ([(frames, n_img, v.hidden_size)] * 5 + [(frames, n_img, v.intermediate_size)]) \
        * v.num_layers + [(frames, v.hidden_size)]
    lat = spec.latent_hw
    n_tok = (lat[0] // 2) * (lat[1] // 2)
    batch = {"cond": rng.random((2, 2, spec.n_cond, 32, 32, 3), dtype=np.float32),
             "target": rng.random((2, 2, 32, 32, 3), dtype=np.float32)}
    draws = [{"t": rng.random(2, dtype=np.float32),
              "x0": rng.standard_normal((2, n_tok, 4 * spec.vae_cfg.z_channels),
                                        dtype=np.float32),
              "vae_noise": rng.standard_normal((2, *lat, spec.vae_cfg.z_channels),
                                               dtype=np.float32),
              "lora_masks": [rng.random(sh) < 0.9 for sh in shapes]} for _ in range(2)]

    def make_state(dev):
        mods = tv.init_modules(spec, torch.Generator().manual_seed(5))
        _plant_lora_b(mods["clip"]["model"], 6)
        opt = optim.AdamWChain(optim.make_lr_schedule("constant", lr))
        mods = mods.to(dev)
        return tv.create_state(mods, tv.trainable_predicate(spec, mods), opt), opt

    launches = _tiny_step_card_vs_cpu(
        "tiny f32 video middle stage2_all step, tower_remat on", make_state,
        tv.make_loss_fn(spec), {k: x[0] for k, x in batch.items()}, batch, draws, lr,
        null=("self_attn.k_proj.bias",))
    k2 = {k: launches[k] for k in ("fused_attention", "fused_attention_bwd")}
    print(f"[small] launches of the card's video stage-2 forward + backward {k2}", flush=True)
    check(k2 == {"fused_attention": 2 * v.num_layers, "fused_attention_bwd": v.num_layers},
          f"tiny video stage-2 step: K2/K2b launches {k2}, expected {2 * v.num_layers} "
          f"(forward and recompute) and {v.num_layers}")


def _tiny_siglip_spec(stage="stage1"):
    """The tiny spec of ``_tiny_spec`` with a SigLIP tower whose grid gives
    L > 600 at D = 72: 100 px, patch 4 (625 tokens), hidden 144 in two
    heads; float32; LoRA r=3 with dropout 0.1 on SIGLIP_TARGETS."""
    import torch
    from genhancer_tpu_torch.models.towers import siglip as sm
    from genhancer_tpu_torch.train import lora
    tower = sm.SiglipConfig(
        vision=sm.SiglipVisionConfig(hidden_size=144, intermediate_size=64, num_layers=2,
                                     num_heads=2, image_size=100, patch_size=4),
        text=sm.SiglipTextConfig(hidden_size=144, intermediate_size=64, num_layers=2,
                                 num_heads=2, vocab_size=100, max_position_embeddings=64,
                                 projection_size=144))
    return dataclasses.replace(
        _tiny_spec(), stage=stage, tower_kind="siglip", img_size=100, clip_image_size=100,
        tower_cfg=tower, dit_param_dtype=torch.float32, vae_dtype=torch.float32, lora_r=3,
        lora_alpha=16.0, lora_dropout=0.1, lora_targets=lora.SIGLIP_TARGETS)


def phase_small_siglip():
    """One tiny float32 SigLIP image step of stage 1 and of stage2_all (the
    default chain), card against CPU (``_tiny_step_card_vs_cpu``): the tower
    at L = 625, D = 72 runs K5 (and, in stage 2, K5b) on the card; stage 2
    with a nonzero B planted in every wrapped linear and LoRA dropout on the
    same injected masks (six per layer, then the head's out_proj, fc1,
    fc2).  The DiT's joint length is 25 x 25 + 1 = 626: K5/K5b there too."""
    import numpy as np
    import torch
    from genhancer_tpu_torch.tasks.image import (create_state, init_modules, make_loss_fn,
                                                 trainable_predicate)
    from genhancer_tpu_torch.train import optim

    lr = 1e-3
    rng = np.random.default_rng(15)
    spec = _tiny_siglip_spec()
    v = spec.tower_cfg.vision
    n_img = v.grid ** 2
    shapes = ([(2, n_img, v.hidden_size)] * 5 + [(2, n_img, v.intermediate_size)]) \
        * v.num_layers + [(2, 1, v.hidden_size)] * 2 + [(2, 1, v.intermediate_size)]
    lat = spec.latent_hw
    n_tok = (lat[0] // 2) * (lat[1] // 2)
    imgs = rng.random((2, 2, 100, 100, 3), dtype=np.float32)
    draws = [{"t": rng.random(2, dtype=np.float32),
              "x0": rng.standard_normal((2, n_tok, 4 * spec.vae_cfg.z_channels),
                                        dtype=np.float32),
              "vae_noise": rng.standard_normal((2, *lat, spec.vae_cfg.z_channels),
                                               dtype=np.float32),
              "lora_masks": [rng.random(sh) < 0.9 for sh in shapes]} for _ in range(2)]
    blocks = spec.dit_cfg.depth + spec.dit_cfg.depth_single_blocks
    for stage in ("stage1", "stage2_all"):
        sp = dataclasses.replace(spec, stage=stage)
        stage_draws = draws if stage != "stage1" else [
            {k: x for k, x in d.items() if k != "lora_masks"} for d in draws]

        def make_state(dev, sp=sp):
            mods = init_modules(sp, torch.Generator().manual_seed(5))
            if sp.stage != "stage1":
                _plant_lora_b(mods["clip"]["model"], 6)
            opt = optim.AdamWChain(optim.make_lr_schedule("constant", lr))
            mods = mods.to(dev)
            return create_state(mods, trainable_predicate(sp, mods), opt), opt

        launches = _tiny_step_card_vs_cpu(
            f"tiny f32 SigLIP image {stage} step (tower L=625, D=72)", make_state,
            make_loss_fn(sp), {"image": imgs[0]}, {"image": imgs}, stage_draws, lr,
            null=("self_attn.k_proj.bias",))
        got = {k: launches[k] for k in ("flash_attention", "flash_attention_bwd",
                                        "fused_attention", "fused_attention_bwd")}
        want = {"flash_attention": v.num_layers + blocks,
                "flash_attention_bwd": (v.num_layers if stage != "stage1" else 0) + blocks,
                "fused_attention": 0, "fused_attention_bwd": 0}
        print(f"[small] launches of the card's SigLIP {stage} forward + backward {got}",
              flush=True)
        check(got == want, f"tiny SigLIP {stage} step: launches {got}, expected {want}")


def _write_mmvp(root, pairs, size, seed=0):
    """A synthetic MMVP-VLM tree: ``Questions.csv`` and ``MLLM_VLM Images/
    {category}/{qid}.jpg``, ``pairs`` pairs in each of the nine categories,
    noise JPEGs of ``size`` x ``size`` px."""
    import csv
    import numpy as np
    from genhancer_tpu_torch.eval import mmvp
    rng = np.random.default_rng(seed)
    rows, qid = [["qid", "type", "statement"]], 1
    for cat in mmvp.CATEGORIES:
        d = os.path.join(root, "MLLM_VLM Images", cat)
        os.makedirs(d, exist_ok=True)
        for _ in range(pairs):
            for q in (qid, qid + 1):
                with open(os.path.join(d, f"{q}.jpg"), "wb") as f:
                    f.write(_jpeg(rng, size, size))
                rows.append([str(q), cat, f"the statement of question {q} about {cat}"])
            qid += 2
    with open(os.path.join(root, "Questions.csv"), "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return root


def _toy_tokenize(length, eos):
    """A deterministic tokenizer in place of the HF one (the card has no
    ``transformers``): characters hashed into ids 3-42, then ``eos`` to the
    end (the first EOS is the pooled position)."""
    import numpy as np

    def fn(texts):
        ids = np.full((len(texts), length), eos, dtype=np.int64)
        for i, t in enumerate(texts):
            for j, ch in enumerate(t[: length - 1]):
                ids[i, j] = 3 + ord(ch) % 40
        return ids, None
    return fn


def _same_results(a, b, csv_a, csv_b, tag):
    """Equal result dicts; equal CSV rows but for the two scores (1e-5)."""
    import csv
    with open(csv_a) as f:
        ra = list(csv.reader(f))
    with open(csv_b) as f:
        rb = list(csv.reader(f))
    score_err = max(abs(float(x) - float(y)) for r1, r2 in zip(ra[1:], rb[1:])
                    for x, y in zip(r1[6:], r2[6:]))
    same = a == b and len(ra) == len(rb) and all(r1[:6] == r2[:6] for r1, r2 in zip(ra, rb))
    print(f"{tag} result dicts and CSV rows {'equal' if same else 'DIFFER'}; scores "
          f"max|card - cpu| {score_err:.3e} (bound 1e-5)", flush=True)
    check(same and score_err <= 1e-5, f"{tag} the card's MMVP-VLM result differs from the CPU's")


def phase_small_eval(work):
    """A tiny CLIPModel (random, seeded; vision D=64 at L=17, text 16
    positions) evaluated on a tiny synthetic MMVP-VLM tree (9 categories x 2
    pairs) with a toy tokenizer, on the card (K2 in float32) and on the CPU
    (plain versions): the whole ``evaluate`` output equal, the embeddings
    within 1e-5 of the CPU's largest."""
    import numpy as np
    import torch
    from genhancer_tpu_torch.core.nn import init_weights
    from genhancer_tpu_torch.eval import mmvp
    from genhancer_tpu_torch.models.towers import clip as cm

    cfg = cm.CLIPConfig(
        vision=cm.CLIPVisionConfig(hidden_size=128, intermediate_size=256, num_layers=2,
                                   num_heads=2, image_size=32, patch_size=8),
        text=cm.CLIPTextConfig(hidden_size=64, intermediate_size=128, num_layers=2,
                               num_heads=2, vocab_size=100, max_position_embeddings=16,
                               eos_token_id=99),
        projection_dim=32)
    model = init_weights(cm.CLIPModel(cfg), torch.Generator().manual_seed(21)).eval()
    bench = _write_mmvp(os.path.join(work, "tiny-mmvp"), 2, 40, seed=1)
    tok = _toy_tokenize(16, 99)
    cpu = mmvp.evaluate(model, cfg, "clip", bench, tok,
                        results_csv=os.path.join(work, "tiny-cpu.csv"))
    card = copy.deepcopy(model).cuda()
    _zero_counts()
    got = mmvp.evaluate(card, cfg, "clip", bench, tok,
                        results_csv=os.path.join(work, "tiny-card.csv"))
    torch.cuda.synchronize()
    counts = {k: v for k, v in _read_counts().items() if v}
    _same_results(got, cpu, os.path.join(work, "tiny-card.csv"),
                  os.path.join(work, "tiny-cpu.csv"), "[small] tiny MMVP-VLM eval card vs cpu:")
    pairs = mmvp.load_pairs(bench)
    images = np.stack([mmvp.preprocess_image(p, "clip", 32)
                       for pair in pairs for p in (pair.img1, pair.img2)])
    ids = tok([t for pair in pairs for t in (pair.text1, pair.text2)])[0]
    errs = []
    for want, have in zip(mmvp._embed_all(model, cfg, "clip", images, ids),
                          mmvp._embed_all(card, cfg, "clip", images, ids)):
        errs.append(float(np.abs(have - want).max() / np.abs(want).max()))
    print(f"[small] tiny eval embeddings card vs cpu: images {errs[0]:.3e}, texts "
          f"{errs[1]:.3e} of the largest (bound 1e-5); the card's launches {counts}",
          flush=True)
    check(max(errs) <= 1e-5, f"tiny eval: embeddings differ by {errs}")
    check(counts == {"fused_attention": cfg.vision.num_layers},
          f"tiny eval: launches {counts}, expected K2 {cfg.vision.num_layers} times")


def phase_small_eval_siglip(work):
    """A tiny SigLIP model (random, seeded; vision D=72 at L=625, text D=72
    at 64 positions) evaluated on a tiny synthetic MMVP-VLM tree with a toy
    64-token tokenizer, on the card (K5 and, for the text side, K2 in
    float32) and on the CPU (plain versions): the whole ``evaluate``
    output equal, the embeddings within 1e-5 of the CPU's largest."""
    import numpy as np
    import torch
    from genhancer_tpu_torch.core.nn import init_weights
    from genhancer_tpu_torch.eval import mmvp
    from genhancer_tpu_torch.models.towers import siglip as sm

    cfg = _tiny_siglip_spec().tower_cfg
    model = init_weights(sm.SiglipModel(cfg), torch.Generator().manual_seed(22)).eval()
    with torch.no_grad():
        model.logit_scale.fill_(2.3)
        model.logit_bias.fill_(-1.7)
    bench = _write_mmvp(os.path.join(work, "tiny-mmvp-siglip"), 2, 40, seed=2)
    tok = _toy_tokenize(64, 1)
    cpu = mmvp.evaluate(model, cfg, "siglip", bench, tok,
                        results_csv=os.path.join(work, "siglip-cpu.csv"))
    card = copy.deepcopy(model).cuda()
    _zero_counts()
    got = mmvp.evaluate(card, cfg, "siglip", bench, tok,
                        results_csv=os.path.join(work, "siglip-card.csv"))
    torch.cuda.synchronize()
    counts = {k: v for k, v in _read_counts().items() if v}
    _same_results(got, cpu, os.path.join(work, "siglip-card.csv"),
                  os.path.join(work, "siglip-cpu.csv"),
                  "[small] tiny SigLIP MMVP-VLM eval card vs cpu:")
    pairs = mmvp.load_pairs(bench)
    images = np.stack([mmvp.preprocess_image(p, "siglip", 100)
                       for pair in pairs for p in (pair.img1, pair.img2)])
    ids = tok([t for pair in pairs for t in (pair.text1, pair.text2)])[0]
    errs = []
    for want, have in zip(mmvp._embed_all(model, cfg, "siglip", images, ids),
                          mmvp._embed_all(card, cfg, "siglip", images, ids)):
        errs.append(float(np.abs(have - want).max() / np.abs(want).max()))
    print(f"[small] tiny SigLIP eval embeddings card vs cpu: images {errs[0]:.3e}, texts "
          f"{errs[1]:.3e} of the largest (bound 1e-5); the card's launches {counts}",
          flush=True)
    check(max(errs) <= 1e-5, f"tiny SigLIP eval: embeddings differ by {errs}")
    want = {"flash_attention": cfg.vision.num_layers, "fused_attention": cfg.text.num_layers}
    check(counts == want, f"tiny SigLIP eval: launches {counts}, expected {want}")


def _tiny_int8_spec(dit_quant: str):
    """The tiny spec cut for the int8 stack: a DiT of hidden 512 (its large
    linears reach the SwitchBack threshold), a tower of hidden 64 (its
    linears reach the tower's 64), the tiny VAE with int8 convs from 8
    channels; float32 throughout, the cache kept as with the fused
    optimizer."""
    import torch
    from genhancer_tpu_torch.models import dit as dm
    from genhancer_tpu_torch.models.towers import clip as cm
    return dataclasses.replace(
        _tiny_spec(),
        dit_cfg=dm.DiTConfig(in_channels=16, vec_in_dim=24, context_in_dim=32, hidden_size=512,
                             num_heads=4, depth=1, depth_single_blocks=1, axes_dim=(32, 48, 48)),
        tower_cfg=cm.CLIPConfig(vision=cm.CLIPVisionConfig(
            hidden_size=64, intermediate_size=128, num_layers=1, num_heads=2, image_size=32,
            patch_size=16), projection_dim=64),
        dit_param_dtype=torch.float32, vae_dtype=torch.float32, tower_quant="int8",
        vae_quant="int8", vae_quant_min_ch=8, dit_quant=dit_quant, dit_quant_cache=True)


def phase_small_int8():
    """One tiny float32 int8 step per int8 configuration (``int8_full`` with
    the fused optimizer emitting the cache: K7, K4; ``int8_dw`` with 8-bit
    moments: K7, K8, K6), card against CPU, held two ways.

    * Each SwitchBack layer of the card's composed forward + backward on the
      inputs it was given there, against the CPU's plain path on the same
      inputs (``_int8_layers_card_vs_cpu``): output, dx and dW within 1e-5
      of max|CPU|, the layer set, cache buffer and dW kind exactly.  This
      holds the composition; controls on the same inputs (an unquantized
      forward, the float32 dW of ``dit_quant: int8``) must miss the bound.
    * The whole step (``_tiny_step_card_vs_cpu``), which can only be held
      to the int8 noise: the int8 forward is chaotic between two devices —
      a float32 summation-order difference flips one code, the flip moves
      its whole row by a fraction of a step and the next layer flips more,
      until the two runs differ by the int8 quantization noise itself.  So
      the bound is twice the CPU's own |int8 - float| per leaf and for the
      loss, from the same step with every int8 knob off on the same weights
      and draws: it catches a step that breaks, not a wrong composition."""
    for dit_quant, bits in (("int8_full", 16), ("int8_dw", 8)):
        attempt(_small_int8_step, dit_quant, bits)


def _switchback_spy(names):
    """(calls, spy): ``spy`` stands in for ``core.quant.switchback`` and
    records each call — the weight's flat path (``names``: data pointer ->
    path), the inputs, the cache it read (codes and buffer address), the dW
    kind and the output; the backward adds the gradient g that reached the
    output and the dx and dW the call returned."""
    import torch
    from genhancer_tpu_torch.core import quant

    class Tap(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, rec, key):
            ctx.rec, ctx.key = rec, key
            return a.clone()

        @staticmethod
        def backward(ctx, g):
            ctx.rec[ctx.key] = g.detach().clone()
            return g, None, None

    calls, orig = [], quant.switchback

    def spy(x, w, wq=None, ws=None, dw="bf16"):
        rec = dict(path=names.get(w.data_ptr()), x=x.detach().clone(), w=w.detach().clone(),
                   dw_kind=dw, wq_ptr=None if wq is None else wq.data_ptr(),
                   wq=None if wq is None else wq.clone(), ws=None if ws is None else ws.clone())
        y = orig(Tap.apply(x, rec, "dx"), Tap.apply(w, rec, "dW"), wq, ws, dw)
        rec["y"] = y.detach().clone()
        calls.append(rec)
        return Tap.apply(y, rec, "g")

    return calls, spy


def _int8_layers_card_vs_cpu(label, make_state, loss_fn, micro, draw, kind):
    """Every SwitchBack call of one composed forward + backward on the card
    against ``core.quant.switchback`` on the CPU (plain K7/K8) on the same
    inputs and gradient: y, dx and dW within 1e-5 of max|CPU| (exact codes
    and int32 sums; float32 dequantization and dW sums may round in another
    order), the called layers exactly the cached ones, each reading its
    cache buffer, with the dW kind ``kind``.  Controls on the same inputs
    must miss that bound by 10x: the forward unquantized, and the float32
    dW where ``kind`` is int8 (``int8_dw`` keeps the float32 dW where K8
    does not apply, T < 8)."""
    import torch
    from genhancer_tpu_torch.core import quant
    from genhancer_tpu_torch.core.kernels import int8_dw as K8

    bound = 1e-5
    torch.backends.cuda.matmul.allow_tf32 = False
    state, _ = make_state("cuda")
    calls, spy = _switchback_spy({p.data_ptr(): k for k, p in state.trainable.items()})
    orig, quant.switchback = quant.switchback, spy
    try:
        cuda = lambda a: {k: torch.from_numpy(v).cuda() for k, v in a.items()}  # noqa: E731
        loss_fn(state.modules, cuda(micro), None, cuda(draw)).backward()
        torch.cuda.synchronize()
    finally:
        quant.switchback = orig
    paths = sorted(c["path"] for c in calls)
    check(paths == sorted(state.quant), f"{label}: SwitchBack ran on {paths}, the cache holds "
                                        f"{sorted(state.quant)}")
    rel = lambda a, b: ((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()  # noqa: E731
    worst, gap = {"y": 0.0, "dx": 0.0, "dW": 0.0}, float("inf")
    for c in calls:
        check(c["dw_kind"] == kind and c["wq_ptr"] == state.quant[c["path"]][0].data_ptr(),
              f"{label}: {c['path']} ran dW {c['dw_kind']} or missed its cache buffer")
        x, w, g = (c[k].cpu().requires_grad_(k != "g") for k in ("x", "w", "g"))
        y = quant.switchback(x, w, c["wq"].cpu(), c["ws"].cpu(), kind)
        y.backward(g)
        errs = {"y": rel(c["y"], y.detach()), "dW": rel(c["dW"], w.grad)}
        if "dx" in c:
            errs["dx"] = rel(c["dx"], x.grad)
        worst = {k: max(v, errs.get(k, 0.0)) for k, v in worst.items()}
        xd, wd, gd = x.detach(), w.detach(), g
        gap = min(gap, rel(xd @ wd.t(), y.detach()))
        if kind == "cols" or K8.dw_supported(xd.numel() // xd.shape[-1], *wd.shape):
            gap = min(gap, rel(quant._bf16_dw(gd, xd, wd.dtype), w.grad))
    print(f"[small] {label}: {len(calls)} SwitchBack layers card vs CPU on equal inputs, "
          f"max|card-cpu|/max|cpu| y {worst['y']:.3e}, dx {worst['dx']:.3e}, dW "
          f"{worst['dW']:.3e} (bound {bound:g}); closest control (unquantized forward, float32 "
          f"dW) {gap:.3e} (must exceed {10 * bound:g})", flush=True)
    check(max(worst.values()) <= bound, f"{label}: SwitchBack layers disagree: {worst}")
    check(gap > 10 * bound, f"{label}: a control came within {gap} of the layer check")
    del state
    _free()


def _small_int8_step(dit_quant: str, bits: int):
    import numpy as np
    import torch
    from genhancer_tpu_torch.tasks.image import (create_state, init_modules, make_loss_fn,
                                                 trainable_predicate)
    from genhancer_tpu_torch.train import optim
    from genhancer_tpu_torch.train.state import with_quant_cache

    lr = 1e-3
    rng = np.random.default_rng(13)
    spec = _tiny_int8_spec(dit_quant)
    lat = spec.latent_hw
    n_tok = (lat[0] // 2) * (lat[1] // 2)
    imgs = rng.random((2, 2, 32, 32, 3), dtype=np.float32)
    draws = [{"t": rng.random(2, dtype=np.float32),
              "x0": rng.standard_normal((2, n_tok, 4 * spec.vae_cfg.z_channels),
                                        dtype=np.float32),
              "vae_noise": rng.standard_normal((2, *lat, spec.vae_cfg.z_channels),
                                               dtype=np.float32)} for _ in range(2)]
    to = lambda arrays: {k: torch.from_numpy(v) for k, v in arrays.items()}  # noqa: E731

    # the same step without int8 (same weights: the surgery follows the init)
    plain = dataclasses.replace(spec, tower_quant="none", vae_quant="none", dit_quant="none",
                                dit_quant_cache=False)
    mods = init_modules(plain, torch.Generator().manual_seed(5))
    st = create_state(mods, trainable_predicate(plain), optim.AdamWChain(lambda c: lr))
    loss = make_loss_fn(plain)(st.modules, to({"image": imgs[0]}), None, to(draws[0]))
    loss.backward()
    noise_ref = (loss.item(), {k: p.grad.detach().clone() for k, p in st.trainable.items()})
    del st, mods

    def make_state(dev):
        mods = init_modules(spec, torch.Generator().manual_seed(5)).to(dev)
        opt = optim.FusedAdamW(optim.make_lr_schedule("constant", lr), emit_quant=True,
                               moment_bits=bits)
        return with_quant_cache(create_state(mods, trainable_predicate(spec), opt)), opt

    label = f"tiny f32 int8 step, dit_quant {dit_quant}, {bits}-bit moments"
    _int8_layers_card_vs_cpu(label, make_state, make_loss_fn(spec), {"image": imgs[0]},
                             draws[0], {"int8_full": "cols", "int8_dw": "int8_dw"}[dit_quant])
    launches = _tiny_step_card_vs_cpu(label, make_state, make_loss_fn(spec), {"image": imgs[0]},
                                      {"image": imgs}, draws, lr, noise_ref=noise_ref)
    k = {n: launches[n] for n in ("rowquant", "int8_dw")}
    print(f"[small] launches of the card's int8 forward + backward {k}", flush=True)
    check(k["rowquant"] > 0 and (k["int8_dw"] > 0) == (dit_quant == "int8_dw"),
          f"tiny int8 step {dit_quant}: launches {k}")


def _write_shards(root, n_shards=4, per_shard=96, size=256):
    from genhancer_tpu_torch.data.testing import make_image_shard
    os.makedirs(root, exist_ok=True)
    for i in range(n_shards):
        make_image_shard(os.path.join(root, f"shard-{i:03d}.tar"), per_shard, size, seed=i)
    return root


class _Recording:
    """A loader that keeps a copy of every batch it hands on: the crops of
    the image loader's decode threads share one generator, so a second
    run of the same config reads other crops."""

    def __init__(self, inner):
        self.inner, self.batches = inner, []

    def __iter__(self):
        for b in self.inner:
            self.batches.append({k: (v.copy() if hasattr(v, "copy") else v)
                                 for k, v in b.items()})
            yield b

    def close(self) -> None:
        self.inner.close()


def phase_train(work):
    """The port's Trainer at full width (the chain's run with the DiT cut
    to 1 + 1 blocks), once per optimizer; returns ({optimizer: launch
    counts of its 8-step run}, trainable leaf count, the K3 run's output
    directory, which keeps the step-10 component files for stage 2's
    ``load_dir``, and the K3 run's reference for phase_dp: its losses,
    median step time and the digests of its parameters after the 8 steps,
    with the chain run's losses and host batches)."""
    from genhancer_tpu_torch.train import checkpoint as ckpt
    from genhancer_tpu_torch.train.config import load_config

    t0 = time.perf_counter()
    shards = _write_shards(os.path.join(work, "shards"))
    print(f"[train] wrote 4 synthetic shards of 96 256-px JPEGs in "
          f"{time.perf_counter() - t0:.1f} s; free disk "
          f"{shutil.disk_usage(work).free / 2**30:.0f} GiB")
    base = load_config(CONFIG)
    base["data_config"]["img_dir"] = shards
    # one checkpoint, at step 8, which the resume and the engine load (the
    # cadence itself is the CPU tests'; a step-4 one cost ~10 s of writes)
    base.update(max_train_steps=8, checkpointing_steps=8, log_interval=1, report_to="none")
    runs, n_leaves = {}, None
    for opt in ("chain", "pallas"):
        # the chain run at 1 + 1 blocks, to stay within the time limit (its
        # float32 moments made a 13 GB checkpoint at full width)
        depth = _DitDepth(1, 1) if opt == "chain" else contextlib.nullcontext()
        with depth:
            out, counts, chain_ref_, k3_ref_, n_l = _train_run(base, opt, work)
        runs[opt] = counts
        if opt == "chain":
            chain_ref = chain_ref_
            continue
        n_leaves, k3_ref = n_l, {**k3_ref_, "chain": chain_ref}
        # the stage-1 files stage 2 loads: step 10's components
        ckpt.prune_checkpoints(out, 1)
        os.remove(os.path.join(out, "optimizer-state-10.bin"))
        stage1 = out
    return runs, n_leaves, stage1, k3_ref


def _train_run(base, opt, work):
    """phase_train's run of one optimizer: 8 steps, a resume for 9-10 and
    an engine on the step-8 files; returns (its output directory, launch
    counts, the chain's reference or None, the K3 run's reference or None,
    its trainable leaf count)."""
    import numpy as np
    import torch
    from genhancer_tpu_torch.parallel.testing import plan_vs_live
    from genhancer_tpu_torch.serve.engine import InferenceEngine
    from genhancer_tpu_torch.train import checkpoint as ckpt
    from genhancer_tpu_torch.train.trainer import Trainer
    from genhancer_tpu_torch import registry
    chain_ref = k3_ref = None
    dit_cfg = registry.build_dit_config("flux-dev")
    cfg = copy.deepcopy(base)
    cfg["output_dir"] = out = os.path.join(work, f"out-{opt}")
    if opt == "pallas":
        cfg["fused_optimizer"] = "pallas"
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device="cuda")
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    planned = plan_vs_live(trainer) if opt == "pallas" else None
    n_leaves = len(trainer.state.trainable)
    n_par = sum(p.numel() for p in trainer.state.trainable.values())
    # the host batches phase_dp (a) and phase_tp_fsdp (a, b) replay
    trainer.loader = _Recording(trainer.loader)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if planned is not None:
        _plan_report("MetaCLIP_large_stage1 (K3)", planned, torch.cuda.max_memory_allocated())
    hist = trainer.history
    check(len(hist) == 8 and [h["step"] for h in hist] == list(range(1, 9)),
          f"{opt}: synced steps {[h['step'] for h in hist]}")
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist),
          f"{opt}: non-finite loss or grad norm: {hist}")
    step_s = statistics.median(h["step_time"] for h in hist[2:])
    mu_dtype = next(iter(trainer.state.opt_state["mu"].values())).dtype
    print(f"[train] {opt}: Trainer built in {built:.1f} s (DiT {dit_cfg.depth} + "
          f"{dit_cfg.depth_single_blocks} blocks, {n_leaves} trainable leaves, "
          f"{n_par / 1e9:.4f} B params; moments now {str(mu_dtype)[6:]}); 8 steps in "
          f"{wall:.1f} s incl. the checkpoint; losses "
          f"{[round(h['loss'], 4) for h in hist]}; grad norms "
          f"{[round(h['grad_norm'], 3) for h in hist]}")
    print(f"[train] {opt}: median step time of steps 3-8 {step_s * 1e3:.1f} ms = "
          f"{32 / step_s:.2f} img/s (B=16 x accumulation 2); peak device memory "
          f"{peak:.2f} GiB")
    # micro-batches per step x DiT blocks
    steps, blocks = 8, 2 * (dit_cfg.depth + dit_cfg.depth_single_blocks)
    want = {**_no_launches(), "fused_rope_attention": steps * blocks,
            "fused_rope_attention_bwd": steps * blocks, "fused_attention": steps * 2 * 24,
            "fused_adamw": steps * n_leaves if opt == "pallas" else 0}
    print(f"[train] {opt}: kernel launches {counts}, expected {want}")
    check(counts == want, f"{opt}: launch counts {counts} != expected {want}")
    if opt == "chain":
        chain_ref = {"loss": [h["loss"] for h in hist], "batches": trainer.loader.batches}
    if opt == "pallas":
        from genhancer_tpu_torch.parallel.testing import digest
        k3_ref = {"loss": [h["loss"] for h in hist], "step_s": step_s,
                  "batches": trainer.loader.batches,
                  "params": {k: digest(v) for k, v in trainer.state.trainable.items()}}
    for pat in ("checkpoint-dit-{}.bin", "checkpoint-project-clip-{}.bin",
                "checkpoint-project-t5-{}.bin", "optimizer-state-{}.bin"):
        check(os.path.exists(os.path.join(out, pat.format(8))),
              f"{opt}: {pat.format(8)} missing")
    del trainer
    _free()
    ckpt.prune_checkpoints(out, 1)     # bound the disk: keep step 8 only

    cfg2 = copy.deepcopy(cfg)
    cfg2.update(max_train_steps=10, resume_from_checkpoint="latest")
    trainer = Trainer(cfg2, device="cuda")
    check(trainer.state.step == 8, f"{opt}: resumed at step {trainer.state.step}, not 8")
    trainer.train()
    hist2 = trainer.history
    check([h["step"] for h in hist2] == [9, 10]
          and all(np.isfinite(h["loss"]) for h in hist2), f"{opt}: resume ran {hist2}")
    print(f"[train] {opt}: a second Trainer resumed at step 8 and ran steps 9-10, "
          f"losses {[round(h['loss'], 4) for h in hist2]}")
    del trainer
    _free()

    engine = InferenceEngine.from_config(copy.deepcopy(cfg), device="cuda",
                                         load_dir=out, load_step=8, buckets=(1,),
                                         num_steps=4)
    size = engine.spec.img_size
    img = np.random.default_rng(3).random((1, size, size, 3), dtype=np.float32)
    rec = engine.reconstruct(img, seed=0)
    check(rec.shape == img.shape and np.isfinite(rec).all(),
          f"{opt}: reconstruct from the trained checkpoint failed")
    print(f"[train] {opt}: InferenceEngine loaded checkpoint-*-8.bin strictly and "
          f"served a reconstruct (mean {rec.mean():.4f})")
    del engine
    _free()
    if opt == "chain":
        shutil.rmtree(out)
    return out, counts, chain_ref, k3_ref, n_leaves


# phase_dp (b): the int8 paths of configs/tpu_fast_stage1.yaml, each run
# replicated and with shard_optimizer_state (ZeRO-1) on two gloo ranks
DP_GLOO_VARIANTS = {"int8_full": {},
                    "int8_dw": {"dit_quant": "int8_dw", "optimizer_moment_bits": 8}}
DP_GLOO_STEPS = 2
DP_GLOO_BATCH = 4      # rows per rank
# JAX's bound for int8 under data parallelism (tests/test_quant_parallel.py:134)
DP_INT8_REL = 3e-3


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _optimizer_launches(counts) -> int:
    return sum(counts[k] for k in ("fused_adamw", "fused_adamw_quant", "fused_adamw8",
                                   "fused_adamw8_quant"))


def _device_memory(tag):
    import torch
    free, total = torch.cuda.mem_get_info()
    print(f"[dp] {tag}: this process holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"({torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved); the card has "
          f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB free", flush=True)


def _dp_nccl_start(work, k3_ref):
    """(a): the Trainer as one torchrun-style rank over NCCL, world size 1,
    ``fused_optimizer: pallas`` with ``shard_optimizer_state``, for the 8
    steps of phase_train's K3 run on the host batches that run read (its
    decode threads' crops are not repeatable).  Returns (the launch, its
    output directory)."""
    from genhancer_tpu_torch.parallel import testing as ptest
    from genhancer_tpu_torch.train.config import load_config
    cfg = load_config(CONFIG)
    cfg["data_config"]["img_dir"] = os.path.join(work, "shards")
    out_dir = os.path.join(work, "out-dp")
    cfg.update(max_train_steps=8, checkpointing_steps=8, log_interval=1, report_to="none",
               fused_optimizer="pallas", shard_optimizer_state=True, output_dir=out_dir)
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()), "LOCAL_RANK": "0"}
    return ptest.start({"scenario": "train", "device": "cuda", "cfg": dict(cfg),
                        "batches": k3_ref["batches"], "digests": True, "threads": 2,
                        "dcp": os.path.join(work, "dcp-nccl")}, 1,
                       os.path.join(work, "dp-nccl"), timeout=480, env=env), out_dir


def _dp_nccl_check(res, wall, out_dir, k3_ref):
    """(a): the losses and the parameters after step 8 equal the K3 run's
    bit for bit."""
    hist = res["history"]
    losses = [h["loss"] for h in hist]
    n = len(res["params"])
    check([h["step"] for h in hist] == list(range(1, 9)), f"dp (a): synced steps {hist}")
    check(losses == k3_ref["loss"], f"dp (a): losses {losses} != the K3 run's {k3_ref['loss']}")
    diff = [k for k, d in res["params"].items() if d != k3_ref["params"].get(k)]
    check(not diff, f"dp (a): {len(diff)} of {n} parameters differ from the K3 run's after "
          f"step 8: {diff[:4]}")
    check(len(res["rows"]) == n and res["saved_steps"] == [8]
          and all(os.path.exists(os.path.join(out_dir, f"{f}-8.bin"))
                  for f in ("checkpoint-dit", "optimizer-state")),
          f"dp (a): {len(res['rows'])} of {n} leaves by rows, saved {res['saved_steps']}")
    want = {**_no_launches(), "fused_rope_attention": 8 * 12,
            "fused_rope_attention_bwd": 8 * 12, "fused_attention": 8 * 2 * 24,
            "fused_adamw": 8 * n}
    check(res["launches"] == want, f"dp (a): launches {res['launches']} != {want}")
    step_s = statistics.median(h["step_time"] for h in hist[2:])
    print(f"[dp] (a) NCCL, world size 1, shard_optimizer_state: one rank of "
          f"configs/MetaCLIP_large_stage1.yaml (B=16 x accumulation 2, K3) in a subprocess, 8 "
          f"steps in {wall:.1f} s with its start and the step-8 checkpoint, while (b)'s gloo "
          f"ranks shared the card and the host; losses and the {n} "
          f"parameters after step 8 identical to the K3 run's (losses {losses}); K3 "
          f"{res['launches']['fused_adamw'] // 8} launches per step ({n} leaves by rows "
          f"[0, n)); median step time of steps 3-8 {step_s * 1e3:.1f} ms against the K3 run's "
          f"{k3_ref['step_s'] * 1e3:.1f} ms; peak device memory "
          f"{res['peak_bytes'] / 2**30:.2f} GiB; moments {res['moment_bytes'] / 2**30:.3f} GiB",
          flush=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    _dcp_report("(a) NCCL, world size 1, K3, full width", [res["dcp"]])
    shutil.rmtree(os.path.join(os.path.dirname(out_dir), "dcp-nccl"), ignore_errors=True)
    return res["launches"]


def _dcp_report(tag, runs) -> None:
    """The sharded checkpoint backend's round trip on each rank
    (``parallel.testing.dcp_round_trip``): every block restored bit for bit
    (they differed before), the ZeRO-1 rows and the count kept, the int8
    cache rebuilt to the saved state's, the next step equal to the
    uninterrupted run's; each rank's bytes written and seconds."""
    for r, d in enumerate(runs):
        check(d["restored_equal"] and d["equal_before"] < d["keys"] and d["rows_equal"]
              and d["count"][0] == d["count"][1] and d["cache_equal"] and d["next_equal"],
              f"dcp {tag} rank {r}: {d}")
    print(f"[dcp] {tag}: saved at step {runs[0]['step']} and restored into a fresh Trainer: "
          f"{runs[0]['keys']} keys ({runs[0]['sharded']} of them a rank's block) bit for bit, "
          f"each rank's rows kept, the next step's loss "
          f"{runs[0]['next_loss'][1]:.6f} equal to the uninterrupted run's and its "
          f"parameters too; per rank " + "; ".join(
              f"rank {r} wrote {d['bytes'] / 2**30:.3f} GiB in {d['save_s']:.2f} s, restored in "
              f"{d['restore_s']:.2f} s" for r, d in enumerate(runs))
          + " (the save gathers nothing: each rank writes its blocks)", flush=True)


class _DitDepth:
    """The registry's flux-dev DiT config cut to ``depth`` double and
    ``single`` single blocks while open (restored on exit)."""

    def __init__(self, depth: int, single: int):
        self.depth, self.single = depth, single

    def __enter__(self):
        from genhancer_tpu_torch import registry
        self.real = registry.build_dit_config
        cut = dataclasses.replace(self.real("flux-dev"), depth=self.depth,
                                  depth_single_blocks=self.single)
        registry.build_dit_config = lambda name: cut
        return cut

    def __exit__(self, *exc):
        from genhancer_tpu_torch import registry
        registry.build_dit_config = self.real


def _dp_gloo_cfg(work):
    from genhancer_tpu_torch.train.config import load_config
    cfg = load_config(INT8_CONFIG)
    cfg["data_config"].update(img_dir=os.path.join(work, "shards"),
                              train_batch_size=DP_GLOO_BATCH)
    cfg.update(log_interval=1, report_to="none", output_dir=os.path.join(work, "out-dp-gloo"))
    return cfg


def _dp_gloo(work, wave, dit):
    """(b): two gloo ranks sharing the card (both LOCAL_RANK=0, torchrun's
    layout of two one-card nodes), configs/tpu_fast_stage1.yaml's settings at
    flux-dev width with the DiT cut to one double and one single block, B=4
    per rank, DP_GLOO_STEPS steps of int8_full (K4's cache) and of int8_dw +
    8-bit moments (K6), each replicated and with shard_optimizer_state, one
    launch per kind, both at once (beside (a)): ZeRO-1 equal to replicated
    and rank equal to rank bit for bit, the loss within 3e-3 of one process
    on the global batch (run meanwhile in this process), each rank's moment
    bytes its row ranges', K3/K4/K6 once per leaf per rank per step."""
    cfg = _dp_gloo_cfg(work)
    launches = {}
    t0 = time.perf_counter()
    for name, over in DP_GLOO_VARIANTS.items():
        launches[name] = wave.start(work, f"dp-gloo-{name}", {
            "scenario": "steps", "device": "cuda", "steps": DP_GLOO_STEPS, "cfg": dict(cfg),
            "registry": {"dit": dit}, "variants": {
                name: over, name + "_zero1": {**over, "shard_optimizer_state": True}},
            "dcp": os.path.join(work, "dcp-gloo"), "dcp_variants": ["int8_full_zero1"]}, 2,
            timeout=480)
    # one process on the global batch (2 x 4 rows), in this process
    ref = {name: _one_process(cfg.merged_with(over), DP_GLOO_STEPS, batch=2 * DP_GLOO_BATCH)
           for name, over in DP_GLOO_VARIANTS.items()}
    outs = [{"runs": {}} for _ in range(2)]
    for launch in launches.values():
        for o, part in zip(outs, wave.join(launch)):
            o["runs"].update(part["runs"])
    wall = time.perf_counter() - t0
    variants = [v for name in DP_GLOO_VARIANTS for v in (name, name + "_zero1")]
    counts = {}
    for name in variants:
        runs = [o["runs"][name] for o in outs]
        r0, r1 = runs
        for key in ("loss", "params", "caches", "moments"):
            check(r0[key] == r1[key], f"dp (b) {name}: the ranks' {key} differ")
        check(r0["rows"] != r1["rows"] or not r0["rows"], f"dp (b) {name}: equal row ranges")
        for r, run in enumerate(runs):
            check(run["moment_bytes"] == run["moment_bytes_expected"],
                  f"dp (b) {name} rank {r}: {run['moment_bytes']} moment bytes, its rows "
                  f"hold {run['moment_bytes_expected']}")
            for step, c in enumerate(run["launches"]):
                cached = len(run["caches"][step])
                ok = _optimizer_launches(c) == run["leaves"] and (
                    c["fused_adamw_quant"] == cached if name.startswith("int8_full")
                    else c["fused_adamw8"] > 0 and c["fused_adamw8_quant"] > 0)
                check(ok and c["rowquant"] > 0,
                      f"dp (b) {name} rank {r} step {step + 1}: launches {c}, "
                      f"{run['leaves']} leaves, {cached} cached")
        counts[f"dp_gloo_{name}"] = {k: sum(c[k] for c in r0["launches"])
                                     for k in r0["launches"][0]}
    lines, far = [], []
    for name in DP_GLOO_VARIANTS:
        rep, zero = outs[0]["runs"][name], outs[0]["runs"][name + "_zero1"]
        for key in ("loss", "params", "caches", "moments"):
            check(rep[key] == zero[key], f"dp (b) {name}: ZeRO-1's {key} differ from replicated")
        rel = [abs(a - b) / abs(b) for a, b in zip(rep["loss"], ref[name]["loss"])]
        if max(rel) > DP_INT8_REL:
            far.append(f"{name}: losses {rep['loss']} against one process's "
                       f"{ref[name]['loss']} (relative {rel}, bound {DP_INT8_REL})")
        c = zero["launches"][0]
        lines.append(
            f"{name}: losses {[round(x, 5) for x in rep['loss']]} (one process on the global "
            f"batch {[round(x, 5) for x in ref[name]['loss']]}, max relative {max(rel):.2e}); "
            f"moments per rank {rep['moment_bytes'] / 2**20:.1f} MiB replicated, "
            f"{zero['moment_bytes'] / 2**20:.1f} MiB with ZeRO-1 ({len(zero['rows'])} of "
            f"{zero['leaves']} leaves by rows); per rank and step K3 {c['fused_adamw']}, K4 "
            f"{c['fused_adamw_quant']}, K6 {c['fused_adamw8'] + c['fused_adamw8_quant']}; "
            f"host-staged gloo step (step 2) replicated "
            f"{statistics.median(rep['step_s'][1:]) * 1e3:.1f} ms, ZeRO-1 "
            f"{statistics.median(zero['step_s'][1:]) * 1e3:.1f} ms, one process on the card "
            f"{statistics.median(ref[name]['step_s'][1:]) * 1e3:.1f} ms")
    print(f"[dp] (b) two gloo ranks on one card, tpu_fast_stage1 at flux-dev width with the "
          f"DiT cut to 1 + 1 blocks, B={DP_GLOO_BATCH} per rank, {DP_GLOO_STEPS} steps, "
          f"{len(variants)} runs (two launches at once, beside (a)) in {wall:.1f} s: ZeRO-1 "
          f"equal to replicated and rank 0 equal "
          f"to rank 1 bit for bit (parameters and int8 caches after every step, gathered "
          f"moments); " + "; ".join(lines), flush=True)
    check(not far, "dp (b): " + "; ".join(far))
    _dcp_report("(b) two gloo ranks, int8_full with ZeRO-1 (K4's cache), 1 + 1 blocks",
                [o["runs"]["int8_full_zero1"]["dcp"] for o in outs])
    shutil.rmtree(os.path.join(work, "dcp-gloo"), ignore_errors=True)
    return counts


def _dp_row_kernels():
    """K3, K4 and K6 on row ranges through ``fused_adamw_apply``, at offsets
    that leave the views' bases off 16 bytes (the kernels' own unaligned
    paths) and on aligned rows: the rows of the whole-leaf update bit for
    bit, one launch per leaf."""
    import torch
    from genhancer_tpu_torch.core.kernels import adamw as KA
    from genhancer_tpu_torch.train.optim import make_lr_schedule
    gen = torch.Generator(device="cuda").manual_seed(16)
    leaves = {"k3": ((10,), (5, 10)), "k3_rows": ((64, 3072), (32, 64)),
              "k4": ((6, 12), (3, 6)), "k4_rows": ((64, 3072), (32, 64)),
              "k6": ((192, 512), (96, 192)), "k6_unaligned": ((6, 132), (3, 6))}
    quant = ("k4", "k4_rows", "k6", "k6_unaligned")
    eight = ("k6", "k6_unaligned")
    sched = make_lr_schedule("constant", 1e-3)
    params = {k: torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
              for k, (s, _) in leaves.items()}
    grads = {k: torch.randn(s, generator=gen, device="cuda") * 1e-2
             for k, (s, _) in leaves.items()}

    def run(rows):
        p = {k: v.clone() for k, v in params.items()}
        local = {k: (v[rows[k][0]:rows[k][1]] if k in rows else v) for k, v in p.items()}
        mu = {k: KA.moment8_zeros_m(v) if k in eight else torch.zeros_like(v)
              for k, v in local.items()}
        nu = {k: KA.moment8_zeros_v(v) if k in eight else torch.zeros_like(v)
              for k, v in local.items()}
        q = {k: (torch.zeros(leaves[k][0], dtype=torch.int8, device="cuda"),
                 torch.zeros(leaves[k][0][0], device="cuda")) for k in quant}
        before = dict(KA.LAUNCHES)
        KA.fused_adamw_apply(p, mu, nu, grads, 1, sched, quant=q, rows=rows)
        torch.cuda.synchronize()
        return p, mu, nu, q, {k: KA.LAUNCHES[k] - before[k] for k in before}

    rows = {k: r for k, (_, r) in leaves.items()}
    whole, part = run({}), run(rows)
    want = {"fused_adamw": 2, "fused_adamw_quant": 2, "fused_adamw8": 0,
            "fused_adamw8_quant": 2}
    check(whole[4] == want and part[4] == want,
          f"dp row kernels: launches {whole[4]}, {part[4]} != {want}")
    bad = []
    for k, (a, b) in rows.items():
        got = [part[0][k][a:b], *(part[1][k] if k in eight else (part[1][k],)),
               *(part[2][k] if k in eight else (part[2][k],)),
               *(t[a:b] for t in part[3].get(k, ()))]
        ref = [whole[0][k][a:b], *(t[a:b] for t in (whole[1][k] if k in eight
                                                      else (whole[1][k],))),
               *(t[a:b] for t in (whole[2][k] if k in eight else (whole[2][k],))),
               *(t[a:b] for t in whole[3].get(k, ()))]
        if not all(torch.equal(x, y) for x, y in zip(got, ref)):
            bad.append(k)
    aligned = {k: part[0][k][a:b].data_ptr() % 16 == 0 for k, (a, b) in rows.items()}
    print(f"[dp] K3/K4/K6 on row ranges (views' bases 16-byte aligned: {aligned}): "
          f"{bad or 'every row of p, the moments and the int8 copy identical to the whole-leaf update'}; "
          f"launches {part[4]}", flush=True)
    check(not bad, f"dp row kernels: the row updates of {bad} differ from the whole leaf's")
    check(not aligned["k3"] and not aligned["k4"] and not aligned["k6_unaligned"],
          f"dp row kernels: the unaligned cases are aligned: {aligned}")


def _mask_draw_ms():
    """The time to draw one micro-batch's LoRA dropout masks of the stage-2
    MetaCLIP-L/14 tower (24 layers x 6 wrapped calls on [B, 257, 1024 or
    4096], then the projection's [B, 1024]) for the global batch of B = 16
    rows per rank at 1, 2 and 4 ranks: each rank draws them all."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for w in (1, 2, 4):
        b = 16 * w
        shapes = [(b, 257, 1024)] * 5 + [(b, 257, 4096)]
        shapes = shapes * 24 + [(b, 1024)]

        def draw():
            for s in shapes:
                torch.rand(s, generator=gen, device="cuda") < 0.9

        draw()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            draw()
        end.record()
        torch.cuda.synchronize()
        out[w] = start.elapsed_time(end) / 3
    print(f"[dp] drawing one micro-batch's 145 LoRA dropout masks of the MetaCLIP-L/14 tower "
          f"for the global batch (each rank draws every rank's rows; B=16 per rank): "
          + ", ".join(f"{w} rank(s) {ms:.3f} ms" for w, ms in out.items()), flush=True)
    return out


def phase_dp(work, k3_ref):
    """Data parallelism and ZeRO-1: (a) full width at world size 1 over
    NCCL against phase_train's K3 run, (b) two gloo ranks sharing the card
    on the int8 paths, at once with (a); K3/K4/K6 on row ranges, the cost
    of the global masks.  Returns {path: launch counts}."""
    check(k3_ref is not None, "dp: phase_train gave no K3 reference")
    _free()
    _device_memory("before the ranks start")
    with _DitDepth(1, 1) as dit, _Wave() as wave:
        t0 = time.perf_counter()
        la, out_dir = _dp_nccl_start(work, k3_ref)
        wave.launches.append(la)
        counts = _dp_gloo(work, wave, dit)
        (res,) = wave.join(la)
        counts["dp_nccl"] = _dp_nccl_check(res, time.perf_counter() - t0, out_dir, k3_ref)
    _free()
    _dp_row_kernels()
    _mask_draw_ms()
    return counts


# phase_tp_fsdp: the mesh's paths on gloo ranks sharing the card
TP_STEPS = 2
# host memory free before (a), (b) and (c) share the first wave (six ranks
# of about 5-6 GiB each), else (c) waits for (a)
TOGETHER_GIB = 48.0
MESH_STEPS = 2
# the bf16 loss of a step on the mesh against one process on the same rows
# (the TP partial products are rounded to bf16 before their sum; FSDP and
# the data axis reorder the sums)
MESH_LOSS_REL = 1e-2
GLOO_NOTE = ("host-staged gloo, ranks sharing one card and the host with the other sub-runs "
             "of their wave and this process's references; says nothing of NCCL")


def _rank_bytes(cfg, tp: int, fsdp: bool, dp: int, dit=None) -> dict:
    """What one rank holds under ``tp`` model ranks and, with ``fsdp``,
    ``dp`` data ranks: the bytes of its trainable and frozen blocks and of
    its DiT blocks, and its trainable elements; from the config's shapes on
    the meta device and the specs of ``parallel.tp`` and ``parallel.fsdp``
    (FSDP's default ``fsdp_min_size``)."""
    from genhancer_tpu_torch.parallel import fsdp as fsdp_m
    from genhancer_tpu_torch.parallel import tp as tp_m
    from genhancer_tpu_torch.tasks import factory
    from genhancer_tpu_torch.tasks import image as timage
    spec = factory.build_spec(cfg)[0]
    if dit is not None:
        spec = dataclasses.replace(spec, dit_cfg=dit)
    mods = timage.build_modules(spec, device="meta")
    pred = timage.trainable_predicate(spec, mods)
    out = {"trainable": 0, "frozen": 0, "dit": 0, "trainable_n": 0, "dit_whole_n": 0}
    for path, p in mods.named_parameters():
        base = tp_m.port_spec(path[4:], p) if tp > 1 and path.startswith("dit.") else ()
        spec_ = fsdp_m.fsdp_spec(p, dp, base) if fsdp else base
        n = p.numel() // (tp if "model" in spec_ else 1) // (dp if "data" in spec_ else 1)
        out["trainable" if pred(path) else "frozen"] += n * p.element_size()
        if pred(path):
            out["trainable_n"] += n
        if path.startswith("dit."):
            out["dit"] += n * p.element_size()
            out["dit_whole_n"] += p.numel()
    return out


def _mesh_report(tag, runs, step_s):
    groups = "; ".join(f"rank {g['rank']}: data index {g['data_index']} group "
                       f"{g['data_group']}, model index {g['model_index']} group "
                       f"{g['model_group']}" for g in (r["groups"] for r in runs))
    peaks = [round(r["peak_bytes"] / 2**30, 2) for r in runs if "peak_bytes" in r]
    print(f"[tp_fsdp] {tag} groups: {groups}; step (median of the timed steps; {GLOO_NOTE}) "
          f"{statistics.median(step_s) * 1e3:.1f} ms; peak device memory per rank {peaks} GiB",
          flush=True)


class _Wave:
    """Rank launches that run at once (``parallel.testing.start``); a
    failed or hung rank fails the phase, and leaving the block kills every
    launch still running."""

    def __init__(self):
        self.launches = []

    def start(self, work, name, payload, world, timeout=600):
        from genhancer_tpu_torch.parallel import testing as ptest
        self.launches.append(ptest.start(
            {**payload, "init_file": os.path.join(work, f"{name}.store"), "threads": 2},
            world, os.path.join(work, name), timeout=timeout, env={"LOCAL_RANK": "0"}))
        return self.launches[-1]

    @staticmethod
    def join(launch):
        try:
            return launch.join()
        except RuntimeError as e:
            raise SmokeFailure(str(e)[-4000:]) from e

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for launch in self.launches:
            launch.kill()


def _tp_k3_payload(work):
    """(a)'s config: ``model_parallel: 2`` on MetaCLIP_large_stage1 (B=16 x
    accumulation 2, bf16, K3) at full width, TP_STEPS steps and a
    checkpoint at the last."""
    from genhancer_tpu_torch.train.config import load_config
    cfg = load_config(CONFIG)
    cfg["data_config"]["img_dir"] = os.path.join(work, "shards")
    cfg.update(max_train_steps=TP_STEPS, checkpointing_steps=0, log_interval=1,
               report_to="none", fused_optimizer="pallas", model_parallel=2,
               output_dir=os.path.join(work, "out-tp"))
    return cfg


def _tp_k3_check(cfg, outs, wall, k3_ref, n_leaves):
    """(a) on the K3 run's host batches: the loss at each step within
    MESH_LOSS_REL of the K3 run's, each rank's DiT parameter and moment
    bytes those of its blocks' shapes, K1/K1b on 12 heads, K3 once per
    local leaf, and the checkpoint rank 0 wrote loaded strictly in this
    process with the reference's keys and shapes."""
    import torch
    from genhancer_tpu_torch.models import dit as dit_m
    from genhancer_tpu_torch.weights import hf_io
    want_b = _rank_bytes(cfg, 2, False, 1)
    train_b, frozen_b = want_b["trainable"], want_b["frozen"]
    ref = k3_ref["loss"][:TP_STEPS]
    want = {**_no_launches(), "fused_rope_attention": TP_STEPS * 2 * 6,
            "fused_rope_attention_bwd": TP_STEPS * 2 * 6,
            "fused_attention": TP_STEPS * 2 * 24, "fused_adamw": TP_STEPS * n_leaves}
    for r, o in enumerate(outs):
        _plan_report(f"tp_fsdp (a) TP=2 rank {r}", o["plan"], o["peak_bytes"])
        losses = [h["loss"] for h in o["history"]]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
        check(len(losses) == TP_STEPS and max(rel) <= MESH_LOSS_REL,
              f"tp_fsdp (a) rank {r}: losses {losses} against the K3 run's {ref} "
              f"(relative {rel}, bound {MESH_LOSS_REL})")
        check(o["param_bytes"] == train_b and o["frozen_bytes"] == frozen_b,
              f"tp_fsdp (a) rank {r}: {o['param_bytes']} trainable and {o['frozen_bytes']} "
              f"frozen bytes, the shapes give {train_b} and {frozen_b}")
        check(o["moment_bytes"] == 2 * train_b,
              f"tp_fsdp (a) rank {r}: {o['moment_bytes']} moment bytes, K3's bf16/f32 moments "
              f"of its blocks are {2 * train_b}")
        check(o["heads"] == [12], f"tp_fsdp (a) rank {r}: DiT attention on {o['heads']} heads")
        check(o["launches"] == want, f"tp_fsdp (a) rank {r}: launches {o['launches']} != {want}")
        check(o["local_shapes"]["dit.double_blocks.0.img_attn.qkv.weight"] == (4608, 3072),
              f"tp_fsdp (a) rank {r}: qkv block {o['local_shapes']}")
    check(outs[0]["params"] == outs[1]["params"],
          "tp_fsdp (a): the ranks' gathered parameters differ")
    dit_cfg = dit_m.DIT_CONFIGS["flux-dev"]
    whole = dit_m.DiT(dit_cfg, device="meta", dtype=torch.bfloat16).state_dict()
    out_dir = cfg["output_dir"]
    sd = hf_io.load_state_dict(os.path.join(out_dir, f"checkpoint-dit-{TP_STEPS}.bin"))
    check(sd.keys() == whole.keys() and all(sd[k].shape == whole[k].shape for k in sd),
          "tp_fsdp (a): checkpoint-dit keys or shapes differ from the reference's")
    one = dit_m.DiT(dit_cfg, dtype=torch.bfloat16)
    one.load_state_dict(sd, strict=True)
    del one, sd
    print(f"[tp_fsdp] (a) TP=2 on two gloo ranks sharing the card, "
          f"configs/MetaCLIP_large_stage1.yaml at full width (B=16 x accumulation 2, K3), "
          f"{TP_STEPS} steps on the K3 run's batches in {wall:.1f} s with the start and the "
          f"step-{TP_STEPS} checkpoint: losses "
          f"{[round(h['loss'], 5) for h in outs[0]['history']]} (K3 run "
          f"{[round(x, 5) for x in ref]}); per rank the DiT's blocks "
          f"{want_b['dit'] / 2 / 1e9:.3f} B of its {want_b['dit_whole_n'] / 1e9:.3f} B "
          f"parameters ({want_b['dit'] / 2**30:.3f} GiB bf16), all trainable "
          f"{train_b / 2**30:.3f} GiB, moments {outs[0]['moment_bytes'] / 2**30:.3f} GiB, "
          f"frozen {frozen_b / 2**30:.3f} GiB, as the shapes give; K1/K1b on 12 heads, K3 "
          f"{n_leaves} per step; checkpoint-dit-{TP_STEPS}.bin loaded strictly in one "
          f"process", flush=True)
    _mesh_report("(a)", outs, [h["step_time"] for o in outs for h in o["history"][1:]])
    shutil.rmtree(out_dir, ignore_errors=True)
    return {"tp_k3": outs[0]["launches"]}


def _fsdp_payload(work):
    """(b)'s config: ``fsdp: true`` on two data ranks (B=8 each,
    accumulation 2), the default chain (run with the DiT cut to 1 + 1
    blocks, to keep the whole run inside its time)."""
    from genhancer_tpu_torch.train.config import load_config
    cfg = load_config(CONFIG)
    cfg["data_config"].update(img_dir=os.path.join(work, "shards"), train_batch_size=8)
    cfg.update(log_interval=1, report_to="none", fsdp=True,
               output_dir=os.path.join(work, "out-fsdp"))
    return cfg


def _fsdp_check(cfg, outs, wall, one, dit):
    """(b): TP_STEPS steps on the chain run's host batches against one
    process's on them (the DiT ``dit``); each rank's parameters and
    moments its blocks'."""
    want_b, whole_b = _rank_bytes(cfg, 1, True, 2, dit), _rank_bytes(cfg, 1, False, 1, dit)
    train_b, frozen_b, train_n = want_b["trainable"], want_b["frozen"], want_b["trainable_n"]
    ref = one["loss"]
    blocks = dit.depth + dit.depth_single_blocks
    want = {**_no_launches(), "fused_rope_attention": 2 * blocks,
            "fused_rope_attention_bwd": 2 * blocks, "fused_attention": 2 * 24}
    for r, o in enumerate(outs):
        rel = [abs(a - b) / abs(b) for a, b in zip(o["loss"], ref)]
        check(len(o["loss"]) == TP_STEPS and max(rel) <= MESH_LOSS_REL,
              f"tp_fsdp (b) rank {r}: losses {o['loss']} against one process's {ref} "
              f"(relative {rel}, bound {MESH_LOSS_REL})")
        check(o["param_bytes"] == train_b and o["frozen_bytes"] == frozen_b,
              f"tp_fsdp (b) rank {r}: {o['param_bytes']} trainable and {o['frozen_bytes']} "
              f"frozen bytes, its blocks' shapes give {train_b} and {frozen_b}")
        check(o["moment_bytes"] == 2 * 4 * train_n,
              f"tp_fsdp (b) rank {r}: {o['moment_bytes']} moment bytes, the chain's float32 "
              f"moments of its blocks are {2 * 4 * train_n}")
        check(o["heads"] == [24], f"tp_fsdp (b) rank {r}: DiT attention on {o['heads']} heads")
        check(all(c == want for c in o["launches"]),
              f"tp_fsdp (b) rank {r}: launches per step {o['launches']} != {want}")
    check(outs[0]["full_params"] == outs[1]["full_params"],
          "tp_fsdp (b): the ranks' gathered parameters differ")
    print(f"[tp_fsdp] (b) FSDP on two data ranks (B=8 each x accumulation 2, the chain), "
          f"the DiT cut to {dit.depth} + {dit.depth_single_blocks} blocks, {TP_STEPS} steps on "
          f"the chain run's batches in {wall:.1f} s with the start: losses "
          f"{[round(x, 5) for x in outs[0]['loss']]} (one process on them "
          f"{[round(x, 5) for x in ref]}); per rank {train_b / 2**30:.3f} GiB trainable + "
          f"{frozen_b / 2**30:.3f} GiB frozen (one process: {whole_b['trainable'] / 2**30:.3f} "
          f"+ {whole_b['frozen'] / 2**30:.3f}), moments "
          f"{outs[0]['moment_bytes'] / 2**30:.3f} GiB, as the shapes give", flush=True)
    _mesh_report("(b)", outs, [s for o in outs for s in o["step_s"][1:]])
    return {"fsdp_chain": {k: sum(c[k] for c in outs[0]["launches"]) for k in want}}


# (c)'s per-call check: the DiT's four linear kinds at flux-dev width
TP_LINEARS = {"dit.double_blocks.0.img_attn.qkv": (3 * 3072, 3072),
              "dit.double_blocks.0.img_attn.proj": (3072, 3072),
              "dit.single_blocks.0.linear1": (3 * 3072 + 12288, 3072),
              "dit.single_blocks.0.linear2": (3072, 3072 + 12288)}


def _tp_linears_payload():
    """Equal bf16 inputs of each DiT linear kind, for SwitchBack
    (``int8_full``, the cache read) on two model ranks."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(170)
    bf = torch.bfloat16
    weights, xs, gs = {}, {}, {}
    for path, (o, i) in TP_LINEARS.items():
        weights[path] = ((torch.randn(o, i, generator=gen, device="cuda") / i ** 0.5).to(bf),
                         (torch.randn(o, generator=gen, device="cuda") * 0.1).to(bf))
        xs[path] = torch.randn(512, i, generator=gen, device="cuda").to(bf)
        gs[path] = (torch.randn(512, o, generator=gen, device="cuda") * 1e-3).to(bf)
    return {"tp": 2, "hidden": 3072, "weights": weights, "x": xs, "g": gs, "dw": "cols",
            "cached": True}


def _tp_linears_want(p):
    """The one-process SwitchBack calls on ``p``'s inputs: {path: (y, dx,
    dW, the bias's gradient, the cache)}."""
    import torch
    from genhancer_tpu_torch.core import nn as tnn_
    from genhancer_tpu_torch.core.quant import quantize_cache
    want = {}
    for path, (w, b) in p["weights"].items():
        lin = tnn_.Linear(w.shape[1], w.shape[0], device="cuda", dtype=w.dtype)
        with torch.no_grad():
            lin.weight.copy_(w)
            lin.bias.copy_(b)
        (wq, ws), = quantize_cache({"w": lin.weight}, ["w"]).values()
        lin.register_buffer("weight_sb_q", wq, persistent=False)
        lin.register_buffer("weight_sb_scale", ws, persistent=False)
        x = p["x"][path].clone().requires_grad_(True)
        with tnn_.int8_training_ctx(full=True):
            y = tnn_.linear(lin, x)
        y.backward(p["g"][path])
        want[path] = {"y": y.detach(), "dx": x.grad, "dw": lin.weight.grad,
                      "db": lin.bias.grad, "cache": (wq, ws)}
    return want


def _tp_int8_payload(work):
    """(c)'s config: tpu_fast_stage1's settings (``int8_full``, K4's cache)
    under TP=2, the DiT cut to 1 + 1 blocks, B=4."""
    from genhancer_tpu_torch.train.config import load_config
    cfg = load_config(INT8_CONFIG)
    cfg["data_config"].update(img_dir=os.path.join(work, "shards"), train_batch_size=4)
    cfg.update(log_interval=1, report_to="none", output_dir=os.path.join(work, "out-tp-int8"))
    return cfg


def _tp_int8_check(outs, wall, one, lin_want):
    """(c): every SwitchBack call within 1e-5 of the one-process call on
    equal inputs and its cache bit for bit; the steps' loss within
    DP_INT8_REL of one process on the same rows, the gathered int8 cache bit
    for bit the one-process quantization of the gathered masters, K3 + K4
    once per leaf per step, K7 launched."""
    import torch
    from genhancer_tpu_torch.core.quant import quantize_cache
    worst = 0.0
    for r, o in enumerate(outs):
        for path, want in lin_want.items():
            got = o["linears"][path]
            for k in ("y", "dx", "dw", "db"):
                ref = want[k].float()
                err = float((got[k].to("cuda").float() - ref).abs().max() / ref.abs().max())
                worst = max(worst, err)
                check(err <= 1e-5, f"tp_fsdp (c) {path} rank {r}: {k} off by {err:.2e} of its "
                      f"largest element (bound 1e-5)")
            check(all(torch.equal(a.to("cuda"), b) for a, b in zip(got["cache"], want["cache"])),
                  f"tp_fsdp (c) {path} rank {r}: the gathered cache differs from one process's")
    print(f"[tp_fsdp] (c) SwitchBack (int8_full, the cache read) on two model ranks against "
          f"one process, bf16 [512 rows] at flux-dev width: qkv and linear1 column-parallel, "
          f"proj and linear2 row-parallel (whole-row amax, int32 sum over the model axis); "
          f"largest relative error {worst:.2e} (bound 1e-5); the caches bit for bit",
          flush=True)
    runs = [o["runs"]["int8_full_tp2"] for o in outs]
    rel = [abs(a - b) / abs(b) for a, b in zip(runs[0]["loss"], one["loss"])]
    check(max(rel) <= DP_INT8_REL, f"tp_fsdp (c): losses {runs[0]['loss']} against one "
          f"process's {one['loss']} (relative {rel}, bound {DP_INT8_REL})")
    for r, run in enumerate(runs):
        check(run["loss"] == runs[0]["loss"], f"tp_fsdp (c) rank {r}: losses differ")
        check(run["heads"] == [12], f"tp_fsdp (c) rank {r}: heads {run['heads']}")
        for step, c in enumerate(run["launches"]):
            cached = len(run["caches"][step])
            check(_optimizer_launches(c) == run["leaves"] and c["fused_adamw_quant"] == cached
                  and c["rowquant"] > 0,
                  f"tp_fsdp (c) rank {r} step {step + 1}: launches {c}, {run['leaves']} leaves, "
                  f"{cached} cached")
        params = {k: v.to("cuda") for k, v in run["tensors"]["params"].items()}
        caches = run["tensors"]["caches"]
        want = quantize_cache(params, sorted(caches))
        bad = [k for k, (wq, ws) in caches.items()
               if not (torch.equal(wq.to("cuda"), want[k][0])
                       and torch.equal(ws.to("cuda"), want[k][1]))]
        check(not bad, f"tp_fsdp (c) rank {r}: the gathered cache of {bad[:4]} differs from "
              f"the quantization of the gathered masters")
    c = runs[0]["launches"][0]
    print(f"[tp_fsdp] (c) int8_full with K4's cache under TP=2, tpu_fast_stage1 at flux-dev "
          f"width with the DiT cut to 1 + 1 blocks, B=4, {TP_STEPS} steps in {wall:.1f} s: "
          f"losses {[round(x, 5) for x in runs[0]['loss']]} (one process "
          f"{[round(x, 5) for x in one['loss']]}, max relative {max(rel):.2e}); the gathered "
          f"cache of {len(runs[0]['tensors']['caches'])} leaves equal bit for bit to the "
          f"quantization of the gathered masters; per rank and step K3 {c['fused_adamw']}, "
          f"K4 {c['fused_adamw_quant']}, K7 {c['rowquant']}; one process's step "
          f"{statistics.median(one['step_s'][1:]) * 1e3:.1f} ms", flush=True)
    _mesh_report("(c)", runs, [s for r in runs for s in r["step_s"][1:]])
    return {"tp_int8": {k: sum(c[k] for c in runs[0]["launches"]) for k in c}}


def _dp_tp_payload(work):
    """(d)'s config: MetaCLIP_large_stage1 with B=4 per data index and no
    accumulation (the mesh's collectives per step halve), the chain."""
    from genhancer_tpu_torch.train.config import load_config
    cfg = load_config(CONFIG)
    cfg["data_config"].update(img_dir=os.path.join(work, "shards"), train_batch_size=4)
    cfg.update(log_interval=1, report_to="none", gradient_accumulation_steps=1,
               output_dir=os.path.join(work, "out-2d"))
    return cfg


def _dp_tp_check(cfg, outs, wall, one, dit):
    """(d): dp2 x tp2 with FSDP on four ranks, the DiT cut to 1 + 1 blocks,
    MESH_STEPS steps, against one process on the same 8 rows; each rank's
    groups, and its bytes its blocks'."""
    want_b = _rank_bytes(cfg.merged_with({"fsdp": True, "model_parallel": 2}), 2, True, 2, dit)
    train_b, frozen_b = want_b["trainable"], want_b["frozen"]
    runs = [o["runs"]["dp2xtp2_fsdp"] for o in outs]
    rel = [abs(a - b) / abs(b) for a, b in zip(runs[0]["loss"], one["loss"])]
    check(max(rel) <= MESH_LOSS_REL, f"tp_fsdp (d): losses {runs[0]['loss']} against one "
          f"process's {one['loss']} (relative {rel}, bound {MESH_LOSS_REL})")
    for r, run in enumerate(runs):
        g = run["groups"]
        check((g["data_index"], g["model_index"]) == (r // 2, r % 2)
              and g["data_group"] == [r % 2, r % 2 + 2]
              and g["model_group"] == [r - r % 2, r - r % 2 + 1],
              f"tp_fsdp (d) rank {r}: groups {g}")
        check(run["loss"] == runs[0]["loss"] and run["full_params"] == runs[0]["full_params"],
              f"tp_fsdp (d) rank {r}: losses or gathered parameters differ from rank 0's")
        # no accumulation: the gradients, and so the chain's moments, keep
        # the parameters' dtypes
        check(run["param_bytes"] == train_b and run["frozen_bytes"] == frozen_b
              and run["moment_bytes"] == 2 * train_b,
              f"tp_fsdp (d) rank {r}: {run['param_bytes']} trainable, {run['frozen_bytes']} "
              f"frozen, {run['moment_bytes']} moment bytes; the shapes give {train_b}, "
              f"{frozen_b}, {2 * train_b}")
        check(run["heads"] == [12], f"tp_fsdp (d) rank {r}: heads {run['heads']}")
    print(f"[tp_fsdp] (d) dp2 x tp2 with FSDP on four gloo ranks sharing the card, "
          f"MetaCLIP_large_stage1 with the DiT cut to 1 + 1 blocks, B=4 per data index, no "
          f"accumulation, the chain, {MESH_STEPS} steps in {wall:.1f} s: losses "
          f"{[round(x, 5) for x in runs[0]['loss']]} (one process on the 8 rows "
          f"{[round(x, 5) for x in one['loss']]}, max relative {max(rel):.2e}); per rank "
          f"{train_b / 2**20:.1f} MiB trainable, {frozen_b / 2**20:.1f} MiB frozen, "
          f"{runs[0]['moment_bytes'] / 2**20:.1f} MiB of moments, as the shapes give; one "
          f"process's step {statistics.median(one['step_s'][1:]) * 1e3:.1f} ms", flush=True)
    _mesh_report("(d)", runs, [s for r in runs for s in r["step_s"][1:]])
    return {"dp2xtp2_fsdp": {k: sum(c[k] for c in runs[0]["launches"])
                             for k in runs[0]["launches"][0]}}


def _one_process(cfg, steps, batch=None, batches=None):
    """``steps`` steps of one process's Trainer on ``cfg`` (``batch`` rows)
    on the seeded global batches, or on ``batches`` (global micro-batches;
    ``parallel.testing.run_steps``)."""
    from genhancer_tpu_torch.parallel import testing as ptest
    from genhancer_tpu_torch.train.trainer import Trainer
    one_cfg = copy.deepcopy(cfg)
    if batch is not None:
        one_cfg["data_config"]["train_batch_size"] = batch
    trainer = Trainer(one_cfg, device="cuda")
    trainer.loader.close()
    out = ptest.run_steps(trainer, steps, batches=batches)
    del trainer
    _free()
    return out


def phase_tp_fsdp(work, k3_ref, n_leaves, beside=None):
    """Tensor parallelism and FSDP on gloo ranks sharing the card (NCCL
    refuses two ranks on one device), in two waves of launches that run at
    once: (a) TP=2 at full width with K3 against phase_train's K3 run,
    (b) FSDP on two data ranks with the DiT cut to 1 + 1 blocks against one
    process on the chain run's batches, and (c) the int8 stack under TP=2
    at 1 + 1 blocks, beside them where the host has the memory, else
    taking (a)'s place when it ends; then (d)
    dp2 x tp2 with FSDP on four ranks, beside phase_sp_pp's (b) where
    ``beside`` (a dict) is given: its launch starts with (d) and its ranks'
    outputs, wall seconds or failure go into ``beside``.  The one-process
    references of (b), (c) and (d) run meanwhile in this process.  Returns
    {path: launch counts}."""
    check(k3_ref is not None and "chain" in k3_ref, "tp_fsdp: phase_train gave no reference")
    counts = {}
    _free()
    cfg_a, cfg_b, cfg_c = _tp_k3_payload(work), _fsdp_payload(work), _tp_int8_payload(work)
    chain = k3_ref["chain"]["batches"][:2 * TP_STEPS]
    linears = _tp_linears_payload()
    together = _meminfo_gib("MemAvailable") >= TOGETHER_GIB
    print(f"[tp_fsdp] first wave: (c) {'beside' if together else 'after'} (a); "
          f"{_host_memory()}", flush=True)
    with _Wave() as wave, _DitDepth(1, 1) as dit:
        t0 = time.perf_counter()
        la = wave.start(work, "tp-k3", {"scenario": "train", "device": "cuda",
                                        "cfg": dict(cfg_a), "digests": True, "plan": True,
                                        "batches": k3_ref["batches"][:2 * TP_STEPS]}, 2)
        lb = wave.start(work, "fsdp", {"scenario": "steps", "device": "cuda",
                                       "steps": TP_STEPS, "cfg": dict(cfg_b),
                                       "registry": {"dit": dit}, "variants": {"fsdp": {}},
                                       "batches": chain}, 2)

        def start_c():
            return time.perf_counter(), wave.start(work, "tp-int8", {
                "scenario": "steps", "device": "cuda", "steps": TP_STEPS, "cfg": dict(cfg_c),
                "registry": {"dit": dit}, "variants": {"int8_full_tp2": {"model_parallel": 2}},
                "keep_tensors": True, "linears": linears}, 2, timeout=480)
        if together:
            t1, lc = start_c()
        lin_want = _tp_linears_want(linears)
        one_cfg_b = copy.deepcopy(cfg_b)
        one_cfg_b["fsdp"] = False
        one_b = _one_process(one_cfg_b, TP_STEPS, batches=chain)
        one_c = _one_process(cfg_c, TP_STEPS)
        outs_a = wave.join(la)
        wall_a = time.perf_counter() - t0
        if not together:        # (c) takes (a)'s place on the card
            t1, lc = start_c()
        outs_c = wave.join(lc)
        wall_c = time.perf_counter() - t1
        outs_b = [o["runs"]["fsdp"] for o in wave.join(lb)]
        wall_b = time.perf_counter() - t0
    counts.update(_tp_k3_check(cfg_a, outs_a, wall_a, k3_ref, n_leaves))
    counts.update(_fsdp_check(cfg_b, outs_b, wall_b, one_b, dit))
    counts.update(_tp_int8_check(outs_c, wall_c, one_c, lin_want))
    _free()
    cfg_d = _dp_tp_payload(work)
    with _Wave() as wave:
        lb = _pp_start(work, k3_ref, wave, beside) if beside is not None else None
        try:
            with _DitDepth(1, 1) as dit:
                t0 = time.perf_counter()
                ld = wave.start(work, "2d", {
                    "scenario": "steps", "device": "cuda", "steps": MESH_STEPS,
                    "cfg": dict(cfg_d), "registry": {"dit": dit},
                    "variants": {"dp2xtp2_fsdp": {"model_parallel": 2, "fsdp": True}}}, 4,
                    timeout=480)
                one_d = _one_process(cfg_d, MESH_STEPS, batch=8)
                outs_d = wave.join(ld)
                counts.update(_dp_tp_check(cfg_d, outs_d, time.perf_counter() - t0, one_d,
                                           dit))
        finally:
            if lb is not None:
                _pp_join(wave, lb, beside)
    return counts


# phase_sp_pp: ring SP and GPipe PP on gloo ranks sharing the card
SP_PP_STEPS = 2
SLIDING_CONFIG = os.path.join(ROOT, "configs", "OpenAICLIP_224_sliding_stage1.yaml")
# JAX's bf16 bound of its ring against the unsharded attention
# (tests/test_ring.py:47)
RING_BF16_ATOL = 3e-2


def _sp_pp_rank_bytes(cfg, moment_bytes_per_elem: int) -> dict:
    """What one SP or PP rank holds, from the config's shapes on the meta
    device: its parameters are whole (neither axis shards a weight), the
    float32 gradient accumulators of the trainable ones, and the moments
    (``moment_bytes_per_elem`` per element for both: 8 for the chain's
    float32 pair, 2 x the parameter's bytes for K3's)."""
    from genhancer_tpu_torch.tasks import factory
    from genhancer_tpu_torch.tasks import image as timage
    from genhancer_tpu_torch.tasks import video as tvideo
    spec, _, kind = factory.build_spec(cfg)
    task = timage if kind == "image" else tvideo
    mods = task.build_modules(spec, device="meta")
    pred = task.trainable_predicate(spec, mods)
    b = {"trainable": 0, "frozen": 0, "trainable_n": 0}
    for path, p in mods.named_parameters():
        b["trainable" if pred(path) else "frozen"] += p.numel() * p.element_size()
        b["trainable_n"] += p.numel() if pred(path) else 0
    n = b["trainable_n"]
    moments = n * moment_bytes_per_elem if moment_bytes_per_elem else 2 * b["trainable"]
    return {**b, "grads": 4 * n, "moments": moments,
            "static": b["trainable"] + b["frozen"] + 4 * n + moments}


# host memory a pair of SP or PP ranks may take (each about 5 GiB of CUDA
# context and libraries, its payload, pinned staging buffers), with room
HOST_ROOM_GIB = 40.0


def _host_room(tag) -> None:
    """Fail the phase, launching nothing, where the host lacks the memory
    a pair of ranks may take."""
    free = _meminfo_gib("MemAvailable")
    print(f"[sp_pp] {tag} before the launch: {_host_memory()}", flush=True)
    check(free >= HOST_ROOM_GIB, f"sp_pp {tag}: host MemAvailable {free:.1f} GiB < "
          f"{HOST_ROOM_GIB} GiB: not launching two more ranks")


def _sp_payload(work):
    """(a)'s config: ``sequence_parallel: 2`` on the published sliding@224
    stage-1 config (2 videos x 8 windows x accumulation 2, the chain)."""
    from genhancer_tpu_torch.train.config import load_config
    cfg = load_config(SLIDING_CONFIG)
    cfg["data_config"]["video_dir"] = os.path.join(work, "sliding")
    cfg.update(sequence_parallel=2, log_interval=1, report_to="none",
               output_dir=os.path.join(work, "out-sp"))
    return cfg


def _pp_payload(work):
    """(b)'s config: ``pipeline_parallel: 2`` with 2 micro-batches per
    pipeline on MetaCLIP_large_stage1 (B=16 x accumulation 2, K3)."""
    from genhancer_tpu_torch.train.config import load_config
    cfg = load_config(CONFIG)
    cfg["data_config"]["img_dir"] = os.path.join(work, "shards")
    cfg.update(pipeline_parallel=2, pipeline_microbatches=2, fused_optimizer="pallas",
               log_interval=1, report_to="none", output_dir=os.path.join(work, "out-pp"))
    return cfg


def _ring_case():
    """The DiT's attention at sliding@224 (B=16, L=964, 24 heads of 128)
    in bf16 from a seed, with an output cotangent."""
    import torch
    gen = torch.Generator().manual_seed(18)
    return {x: torch.randn((16, 964, 24, 128), generator=gen).to(torch.bfloat16)
            for x in "qkvg"}


def _sp_pp_report(tag, name, outs, ref, want, reckon):
    """Checks and prints one SP or PP run: per step and rank the loss
    against the one-process run's within MESH_LOSS_REL and the launches
    against ``want``; the ranks' groups, step times and peak memory
    against the reckoned static bytes."""
    for r, o in enumerate(outs):
        rel = [abs(a - b) / abs(b) for a, b in zip(o["loss"], ref)]
        check(len(o["loss"]) == SP_PP_STEPS and max(rel) <= MESH_LOSS_REL,
              f"sp_pp {tag} rank {r}: losses {o['loss']} against the one-process run's {ref} "
              f"(relative {rel}, bound {MESH_LOSS_REL})")
        for i, got in enumerate(o["launches"]):
            check(got == want, f"sp_pp {tag} rank {r} step {i + 1}: launches {got} != {want}")
        print(f"[sp_pp] {tag} rank {r} launches per step: " + "; ".join(
            f"step {i + 1}: " + ", ".join(f"{k} {v}" for k, v in got.items() if v)
            for i, got in enumerate(o["launches"])), flush=True)
    check(outs[0]["full_params"] == outs[1]["full_params"],
          f"sp_pp {tag}: the ranks' parameters differ after the steps")
    for r, o in enumerate(outs):
        _plan_report(f"{tag} rank {r}", o["plan"], o["peak_bytes"])
    groups = "; ".join(f"rank {g['rank']}: data {g['data_index']}, seq {g['seq_index']} "
                       f"(group {g['seq_group']}), pipe {g['pipe_index']} (group "
                       f"{g['pipe_group']})" for g in (o["groups"] for o in outs))
    peaks = [round(o["peak_bytes"] / 2**30, 2) for o in outs]
    step_s = [s for o in outs for s in o["step_s"][1:]]
    print(f"[sp_pp] {tag} {name}: losses {[round(x, 5) for x in outs[0]['loss']]} (one "
          f"process {[round(x, 5) for x in ref]}); {groups}; step (median of steps 2-"
          f"{SP_PP_STEPS} of both ranks; {GLOO_NOTE}) {statistics.median(step_s) * 1e3:.1f} ms; "
          f"peak device memory per rank {peaks} GiB, reckoned static {reckon['static'] / 2**30:.2f}"
          f" GiB (parameters {reckon['trainable'] / 2**30:.2f}, frozen "
          f"{reckon['frozen'] / 2**30:.2f}, float32 gradients {reckon['grads'] / 2**30:.2f}, "
          f"moments {reckon['moments'] / 2**30:.2f})", flush=True)


def _pp_start(work, k3_ref, wave, beside):
    """(b)'s launch in ``wave`` (phase_tp_fsdp's second, beside (d), whose
    1 + 1-block ranks leave the card and the host room for it): PP=2, M=2
    on phase_train's K3 batches.  Returns the launch, or None where it
    could not start (the reason in ``beside``)."""
    try:
        check(k3_ref is not None, "phase_train gave no K3 reference")
        cfg = _pp_payload(work)
        beside.update(cfg=cfg, reckon=_sp_pp_rank_bytes(cfg, 0))
        _host_room("(b)")
        beside["t0"] = time.perf_counter()
        return wave.start(work, "pp", {
            "scenario": "steps", "device": "cuda", "steps": SP_PP_STEPS, "cfg": dict(cfg),
            "variants": {"pp2": {}}, "batches": k3_ref["batches"][:2 * SP_PP_STEPS],
            "plan": True}, 2, timeout=480)
    except SmokeFailure as e:
        beside["error"] = str(e)
        return None


def _pp_join(wave, launch, beside) -> None:
    try:
        beside["runs"] = [o["runs"]["pp2"] for o in wave.join(launch)]
        beside["wall"] = time.perf_counter() - beside["t0"]
    except SmokeFailure as e:
        beside["error"] = str(e)


def phase_sp_pp(work, sliding_ref, pp_run):
    """Sequence and pipeline parallelism on gloo ranks sharing the card
    (each pair of ranks holds two whole models: (a)'s pair and (b)'s
    cannot share the card): (a) SP=2 on the sliding@224 stage-1 config at
    full width and published batch with the DiT cut to 1 + 1 blocks, on
    the host batches of phase_video_train's sliding run, against one
    process at that depth on them (run meanwhile), then the ring at
    the DiT's attention shape against ``sdpa_ref``; (b) PP=2 with 2
    micro-batches on MetaCLIP_large_stage1 with K3, whose launch ran
    beside phase_tp_fsdp's (d) on phase_train's K3 batches
    (``pp_run``), against the K3 run's losses.  Returns {path: launch
    counts of the last step}."""
    import torch
    from genhancer_tpu_torch.core.attention import sdpa_ref
    counts = {}
    check("runs" in pp_run, f"sp_pp (b): the PP launch gave no result: "
          f"{pp_run.get('error', 'phase_tp_fsdp did not start it')}")
    runs = pp_run["runs"]
    n_leaves = runs[0]["leaves"]
    # per rank per step: 3 of the 6 blocks x 2 micro-batches x accumulation 2
    want_b = {**_no_launches(), "fused_rope_attention": 12, "fused_rope_attention_bwd": 12,
              "fused_attention": 2 * 24, "fused_adamw": n_leaves}
    _sp_pp_report("(b)", f"PP=2, M=2, {os.path.basename(CONFIG)} with K3 (B=16 x 2), "
                  f"{SP_PP_STEPS} steps in {pp_run['wall']:.1f} s with the start, beside "
                  "phase_tp_fsdp's (d)", runs, pp_run["k3_loss"][:SP_PP_STEPS], want_b,
                  pp_run["reckon"])
    check(n_leaves == 112, f"sp_pp (b): {n_leaves} trainable leaves, not 112")
    counts["pp_k3"] = runs[0]["launches"][-1]
    check(sliding_ref is not None, "sp_pp (a): phase_video_train gave no reference")
    _free()
    cfg_a = _sp_payload(work)
    batches_a = sliding_ref["batches"][:2 * SP_PP_STEPS]
    with _DitDepth(1, 1) as dit_a:      # (a) at 1 + 1 blocks, to stay within the time limit
        reckon_a = _sp_pp_rank_bytes(cfg_a, 8)
    free, total = torch.cuda.mem_get_info()
    print(f"[sp_pp] reckoned static bytes per rank: (a) {reckon_a['static'] / 2**30:.2f} GiB, "
          f"(b) {pp_run['reckon']['static'] / 2**30:.2f} GiB; with the one-process sliding "
          f"step's activations (36.17 GiB peak there) (a)'s pair and (b)'s pair cannot share "
          f"the card's {total / 2**30:.1f} GiB ({free / 2**30:.1f} free)", flush=True)
    ring = _ring_case()
    _host_room("(a)")
    with _Wave() as wave:
        t0 = time.perf_counter()
        la = wave.start(work, "sp", {
            "scenario": "steps", "device": "cuda", "steps": SP_PP_STEPS, "cfg": dict(cfg_a),
            "registry": {"dit": dit_a}, "variants": {"sp2": {}}, "batches": batches_a,
            "ring": {"sp": 2, "device": "cuda", "cases": [ring]}, "plan": True}, 2,
            timeout=480)
        # one process on the same batches at the same depth, meanwhile
        one_cfg = copy.deepcopy(cfg_a)
        one_cfg.pop("sequence_parallel")
        with _DitDepth(1, 1):
            one_a = _one_process(one_cfg, SP_PP_STEPS, batches=batches_a)
        outs = wave.join(la)
        wall_a = time.perf_counter() - t0
    runs = [o["runs"]["sp2"] for o in outs]
    want_a = {**_no_launches(), "fused_attention": 2 * 24}
    _sp_pp_report("(a)", f"SP=2, {os.path.basename(SLIDING_CONFIG)} with the DiT cut to 1 + 1 "
                  f"blocks (joint L=964, 482 tokens per rank, 2 x 8 windows x 2), "
                  f"{SP_PP_STEPS} steps and the ring's check in {wall_a:.1f} s with the start, "
                  "against one process at that depth on the same batches", runs,
                  one_a["loss"], want_a, reckon_a)
    counts["sp_sliding"] = runs[0]["launches"][-1]
    # the ring at the DiT's shape against the unsharded attention on the card
    got = torch.cat([o["ring"]["cases"][0]["o"] for o in outs], dim=1)[:, :964].cuda()
    with torch.no_grad():
        want = sdpa_ref(*(ring[x].cuda() for x in "qkv"))
    err = float((got.float() - want.float()).abs().max())
    check(err <= RING_BF16_ATOL, f"sp_pp (a): ring against sdpa_ref max error {err} > "
          f"{RING_BF16_ATOL}")
    c0 = outs[0]["ring"]["cases"][0]
    print(f"[sp_pp] (a) ring attention [16, 964, 24, 128] bf16 on 2 seq ranks (chunks "
          f"{c0['lengths']}), after the steps: max |ring - sdpa_ref| {err:.5f} (bound "
          f"{RING_BF16_ATOL}); forward {c0['fwd_s'] * 1e3:.1f} ms, backward "
          f"{c0['bwd_s'] * 1e3:.1f} ms on rank 0 ({GLOO_NOTE})", flush=True)
    return counts


# phase_sp_int8_serve: SP under the int8 DiT, and the serving mesh, on gloo
# ranks sharing the card (host-staged)
SP_INT8_STEPS = 2
SWITCHBACK_REL = 1e-5
SERVE_MESH_STEPS = 4            # Euler steps (the served default is 20)
SERVE_MESH_SEED = 11
# the mesh engines against the one-process engine on the card, pixels in
# [0, 1] and the embedding (stated in PERF.md before the first run): the
# data ranks' GEMMs run on 2 rows, the row-parallel linears sum bf16 partials
SERVE_MESH_MAX = 5e-2
SERVE_MESH_MEAN = 5e-3


def _sp_int8_payload(work, variant, dit_1_1=None, shards=None):
    """SP=2 on configs/tpu_fast_stage1.yaml at the published B=32:
    ``int8_full`` (K4's cache) at full width and depth, or ``int8_dw`` +
    8-bit moments (K8, K6) with the DiT cut to 1 + 1 blocks; the last
    step's SwitchBack calls (kept in host memory) held in-rank against one
    process on the joined inputs (K8's operands as the step built them
    against one process's rows built from each rank's real tokens).
    ``shards``: the image shards (``work``'s by default)."""
    from genhancer_tpu_torch.train.config import load_config
    cfg = load_config(INT8_CONFIG)
    cfg["data_config"]["img_dir"] = shards or os.path.join(work, "shards")
    cfg.update(sequence_parallel=2, log_interval=1, report_to="none",
               output_dir=os.path.join(work, f"out-sp-{variant}"))
    over = ({} if variant == "int8_full" else
            {"dit_quant": "int8_dw", "optimizer_moment_bits": 8})
    return {"scenario": "steps", "device": "cuda", "steps": SP_INT8_STEPS, "cfg": dict(cfg),
            "hold_calls": True, "hold_store": "cpu", "plan": True,
            **({"registry": {"dit": dit_1_1}} if dit_1_1 is not None else {}),
            "variants": {variant: over}}


def _sp_int8_report(outs, name, wall, beside) -> dict:
    """Per rank of variant ``name``: every SwitchBack call of the last
    step within SWITCHBACK_REL of one process (y, dx, dW) with the codes
    and scales that span tokens bit for bit, token and vector calls both;
    the ranks' losses and parameters equal; per rank per step K7, and K4
    (``int8_full``) or K8 and K6 (``int8_dw``); the planner's bytes."""
    counts = {}
    runs = [o["runs"][name] for o in outs]
    for r, run in enumerate(runs):
        h = run["held"]
        check(h["calls"] > 0 and h["codes_equal"] == h["calls"]
              and max(h["worst"].values()) <= SWITCHBACK_REL
              and h["splits"] == ["tokens", "vector"],
              f"sp_int8 {name} rank {r}: SwitchBack calls against one process {h}")
        for step, c in enumerate(run["launches"]):
            ok = c["rowquant"] > 0 and (
                c["fused_adamw_quant"] > 0 if name == "int8_full"
                else c["int8_dw"] > 0 and c["fused_adamw8"] + c["fused_adamw8_quant"] > 0)
            check(ok, f"sp_int8 {name} rank {r} step {step + 1}: launches {c}")
        _plan_report(f"sp_int8 {name} rank {r}", run["plan"], run["peak_bytes"])
    check(runs[0]["loss"] == runs[1]["loss"]
          and runs[0]["full_params"] == runs[1]["full_params"],
          f"sp_int8 {name}: the ranks' losses or parameters differ")
    c = runs[0]["launches"][-1]
    h = runs[0]["held"]
    counts[f"sp_{name}"] = {k: sum(x[k] for x in runs[0]["launches"]) for k in c}
    held = ("K8's operands equal to one process's rows" if name == "int8_dw"
            else "codes and scales equal")
    print(f"[sp_int8] {name} ({'full depth' if name == 'int8_full' else '1 + 1 blocks'}, "
          f"B=32, SP=2, 99 and 98 tokens per rank, rank 1 without the text token): losses "
          f"{[round(x, 5) for x in runs[0]['loss']]}; the last step's {h['calls']} "
          f"SwitchBack calls ({', '.join(h['kinds'])}; token and vector calls) against one "
          f"process on the joined inputs: max rel y {h['worst']['y']:.2e}, dx "
          f"{h['worst']['dx']:.2e}, dW {h['worst']['dW']:.2e} (bound {SWITCHBACK_REL}), "
          f"{held} in {h['codes_equal']} of {h['calls']}; per rank per step "
          f"K7 {c['rowquant']}, K8 {c['int8_dw']}, K4 {c['fused_adamw_quant']}, K6 "
          f"{c['fused_adamw8'] + c['fused_adamw8_quant']}, K3 {c['fused_adamw']}, K1 "
          f"{c['fused_rope_attention']} (0: the ring takes the DiT's attention), K2 "
          f"{c['fused_attention']}; step {statistics.median(runs[0]['step_s']) * 1e3:.1f} ms "
          f"({GLOO_NOTE}); peak {[round(x['peak_bytes'] / 2**30, 2) for x in runs]} GiB",
          flush=True)
    print(f"[sp_int8] the {name} pair ran {beside} in {wall:.1f} s with its start", flush=True)
    return counts


def _serve_mesh_payload(img, rgb):
    """One launch of two ranks, an engine per phase: dp=2 (bf16 reconstruct
    B=4 and embed, then the HTTP server on rank 0: 4 concurrent
    reconstructs and an embed), dp=2 with the control (each data rank
    draws its own rows' noise), tp=2 (the same as the first in bf16), tp=2
    int8."""
    base = {"buckets": (4,), "num_steps": SERVE_MESH_STEPS,
            "requests": [("reconstruct", img, SERVE_MESH_SEED), ("embed", img, None)],
            "http": True, "http_reconstructs": 4, "max_wait_ms": 1000.0, "jpeg_image": rgb}
    one = {"buckets": (4,), "num_steps": SERVE_MESH_STEPS,
           "requests": [("reconstruct", img, SERVE_MESH_SEED)]}
    return {"scenario": "serve", "device": "cuda", "config": CONFIG, "phases": [
        {**base, "num_devices": 2}, {**one, "num_devices": 2, "control": "own_noise"},
        {**base, "model_parallel": 2}, {**one, "model_parallel": 2, "quant": "int8"}]}


def _close(tag, got, want, bound_max=SERVE_MESH_MAX, bound_mean=SERVE_MESH_MEAN, scale=1.0):
    import numpy as np
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    ok = d.max() <= bound_max * scale and d.mean() <= bound_mean * scale
    check(ok, f"serve_mesh {tag}: max |mesh - one process| {d.max():.3e}, mean {d.mean():.3e} "
          f"(bounds {bound_max * scale:.3e}, {bound_mean * scale:.3e})")
    return d.max(), d.mean()


def _serve_mesh_report(tag, first, second, ref, ref8=None) -> dict:
    """The mesh engine's answers (rank 0's ``first`` and ``second``
    phases) against the one-process engine's (same config, seed and
    bucket); the HTTP round trips; the control or the int8 engine."""
    import io
    import json as json_m
    import numpy as np
    from PIL import Image
    (rec, rec_s), (emb, emb_s) = first["answers"]
    e_rec = _close(f"{tag} reconstruct", rec, ref["reconstruct"])
    scale = float(np.abs(ref["embed"]).max())
    e_emb = _close(f"{tag} embed", emb, ref["embed"], scale=scale)
    http = first["http"]
    ok = (len(http) == 5 and all(st == 200 for _, st, _, _ in http)
          and all(Image.open(io.BytesIO(b)).size == (224, 224) for p, _, _, b in http[:4])
          and json_m.loads(http[4][3])["dim"] == ref["embed"].shape[-1])
    check(ok, f"serve_mesh {tag}: HTTP answers {[(p, st, ct) for p, st, ct, _ in http]}: "
          f"{[b[:300] for _, st, _, b in http if st != 200]}")
    stats = first["stats"]
    check(stats["reconstruct"]["requests"] == 4 and stats["reconstruct"]["errors"] == 0,
          f"serve_mesh {tag}: HTTP stats {stats}")
    line = (f"[serve_mesh] {tag}: buckets {first['buckets']}; reconstruct B=4 ({SERVE_MESH_STEPS} "
            f"Euler steps) {rec_s * 1e3:.1f} ms, max |mesh - one process| {e_rec[0]:.3e}, mean "
            f"{e_rec[1]:.3e}; embed {emb_s * 1e3:.1f} ms, max {e_emb[0]:.3e} (of "
            f"{scale:.3f}); HTTP: 4 concurrent reconstructs and an embed through rank 0's "
            f"server, batches {stats['reconstruct'].get('batch_histogram')}; "
            f"launches on rank 0 {_nonzero(first['launches'])}")
    counts = {f"serve_{tag}": first["launches"]}
    (res2, s2), = second["answers"]
    if ref8 is None:            # the control: each data rank drew its own rows' noise
        d = np.abs(res2.astype(np.float64) - ref["reconstruct"])
        check(d.max() > 10 * SERVE_MESH_MAX, f"serve_mesh {tag}: the control (own noise) "
              f"reads max {d.max():.3e}, not 10x over {SERVE_MESH_MAX}")
        line += (f"; control (each data rank draws its own rows' noise): max {d.max():.3e}, "
                 f"mean {d.mean():.3e}, {d.max() / SERVE_MESH_MAX:.0f}x the bound")
    else:
        e8 = _close(f"{tag} int8", res2, ref8)
        line += (f"; int8 at tp=2 {s2 * 1e3:.1f} ms, max |mesh - one-process int8 engine| "
                 f"{e8[0]:.3e}, mean {e8[1]:.3e}; launches {_nonzero(second['launches'])}")
        counts["serve_int8_tp2"] = second["launches"]
    print(line + f" ({GLOO_NOTE})", flush=True)
    return counts


def _nonzero(c) -> dict:
    return {k: v for k, v in c.items() if v}


def phase_sp_int8_serve(work):
    """SP with the int8 DiT at 1 + 1 blocks and multi-device serving, on
    gloo ranks sharing the card, after the one-process engines in this
    process: two pairs at once, the ``int8_dw`` SP pair
    (``_sp_int8_payload``; its records in host memory) and the serving
    pair (``_serve_mesh_payload``).  The full-depth ``int8_full`` SP pair
    runs beside the int8 training phases (``sp_int8_full_start``).
    Returns {path: launch counts}."""
    import numpy as np
    from genhancer_tpu_torch.serve.engine import InferenceEngine
    check(os.path.isdir(os.path.join(work, "shards")), "sp_int8: no shards")
    _free()
    check(_meminfo_gib("MemAvailable") >= HOST_ROOM_GIB,
          f"sp_int8: host MemAvailable below {HOST_ROOM_GIB} GiB for two pairs: "
          f"{_host_memory()}")
    print(f"[sp_int8] before the launches: {_host_memory()}", flush=True)
    rng = np.random.default_rng(21)
    img = rng.random((4, 224, 224, 3), dtype=np.float32)
    rgb = (rng.random((224, 224, 3)) * 255).astype(np.uint8)
    counts = {}
    with _DitDepth(1, 1) as dit_1_1:
        pass
    # the one-process engines first: the pairs then have the card to themselves
    t0 = time.perf_counter()
    ref = {}
    for quant in ("none", "int8"):
        eng = InferenceEngine.from_config(CONFIG, device="cuda", buckets=(4,),
                                          num_steps=SERVE_MESH_STEPS, quant=quant,
                                          wire_dtype="float32")
        ref[quant] = {"reconstruct": eng.reconstruct(img, seed=SERVE_MESH_SEED),
                      "embed": eng.embed(img)}
        del eng
        _free()
    print(f"[serve_mesh] the one-process engines (bf16, int8) answered in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    with _Wave() as wave:
        t0 = time.perf_counter()
        ld = wave.start(work, "sp-int8-dw", _sp_int8_payload(work, "int8_dw", dit_1_1), 2,
                        timeout=600)
        lb = wave.start(work, "serve-mesh", _serve_mesh_payload(img, rgb), 2, timeout=600)
        served = wave.join(lb)[0]
        print(f"[serve_mesh] four engines on one pair (dp=2, its control, tp=2, int8 tp=2) "
              f"beside the int8_dw SP pair in {time.perf_counter() - t0:.1f} s", flush=True)
        counts.update(_serve_mesh_report("dp2", served[0], served[1], ref["none"]))
        counts.update(_serve_mesh_report("tp2", served[2], served[3], ref["none"],
                                         ref["int8"]["reconstruct"]))
        counts.update(_sp_int8_report(wave.join(ld), "int8_dw", time.perf_counter() - t0,
                                      "beside the serving pair"))
    return counts


def sp_int8_full_start(wave, work):
    """Launch the full-depth ``int8_full`` SP pair (``_sp_int8_payload``,
    its records in host memory) in ``wave``, on shards of its own, so that
    it runs beside the int8 training phases (their peaks, 17 and 21 GiB,
    leave the card room for its two ranks of 13.4 GiB); returns (the
    launch, its start time)."""
    check(_meminfo_gib("MemAvailable") >= HOST_ROOM_GIB,
          f"sp_int8: host MemAvailable below {HOST_ROOM_GIB} GiB for a pair: {_host_memory()}")
    shards = _write_shards(os.path.join(work, "sp-shards"), n_shards=1)
    print(f"[sp_int8] the int8_full SP pair starts; it shares the card and the host with "
          f"phase_train_int8 and phase_fast_stage2 until it joins ({_host_memory()})", flush=True)
    t0 = time.perf_counter()
    return wave.start(work, "sp-int8-full", _sp_int8_payload(work, "int8_full", shards=shards),
                      2, timeout=600), t0


def phase_sp_int8_full(wave, started):
    """Join the ``int8_full`` SP pair that ``sp_int8_full_start`` launched
    and hold it (``_sp_int8_report``).  Returns {path: launch counts}."""
    check(started is not None, "sp_int8: the int8_full pair did not start")
    launch, t0 = started
    return _sp_int8_report(wave.join(launch), "int8_full", time.perf_counter() - t0,
                           "beside phase_train_int8 and phase_fast_stage2")


STAGE2_CONFIG = os.path.join(ROOT, "configs", "MetaCLIP_large_stage2_all.yaml")


def _stage2_want(trainer, steps):
    """Launch counts of ``steps`` optimizer steps of image stage 2, from the
    model: per micro-batch each DiT block runs K1 and K1b (stage2_only too:
    the gradient passes through the frozen DiT to the conditioning) and
    each tower layer K2 and K2b; per step K3 takes each trainable leaf with
    ``fused_optimizer: pallas``."""
    spec, micro = trainer.spec, steps * trainer.accum
    blocks = spec.dit_cfg.depth + spec.dit_cfg.depth_single_blocks
    layers = spec.tower_cfg.vision.num_layers
    fused = trainer.cfg.get("fused_optimizer") == "pallas"
    return {**_no_launches(), "fused_rope_attention": micro * blocks,
            "fused_rope_attention_bwd": micro * blocks, "fused_attention": micro * layers,
            "fused_attention_bwd": micro * layers,
            "fused_adamw": steps * len(trainer.state.trainable) if fused else 0}


class _BwdSpy:
    """Keeps the inputs and outputs of the first ``_bwd_kernel`` launch of a
    run in ``module`` (the short kernels' or the flash kernel's) that
    ``keep`` accepts, so that the step's own call can be held against the
    plain version: K2b (``tables`` None: the tower's first layer's backward
    in the first micro-batch) or K5b (the SigLIP tower's last layer's)."""

    def __init__(self, module, keep=lambda *args: True):
        self.mod, self.keep, self.inner, self.call = module, keep, module._bwd_kernel, None

    def __enter__(self):
        def spy(*args):
            out = self.inner(*args)
            if self.call is None and self.keep(*args):
                self.call = ([x.detach().clone() if x is not None and hasattr(x, "detach")
                              else x for x in args], [x.clone() for x in out])
            return out
        self.mod._bwd_kernel = spy
        return self

    def __exit__(self, *exc):
        self.mod._bwd_kernel = self.inner


def _k2b_spy():
    from genhancer_tpu_torch.core.kernels import short_attention as K
    return _BwdSpy(K, keep=lambda rq, rk, v, o, lse, do, tables: tables is None)


def _export_timer():
    """Wraps ``train.checkpoint.write_hf_tower`` (which the Trainer's
    checkpoint writer calls, on its background thread, with the tower the
    step loop merged on the card and snapshotted) to record (seconds,
    bytes of pytorch_model.bin, dir)."""
    from genhancer_tpu_torch.train import checkpoint as ckpt
    inner, calls = ckpt.write_hf_tower, []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        secs = time.perf_counter() - t0
        calls.append((secs, os.path.getsize(os.path.join(out, "pytorch_model.bin")), out))
        return out

    ckpt.write_hf_tower = timed
    return calls, lambda: setattr(ckpt, "write_hf_tower", inner)


def _check_k2b_call(spy, tag, path):
    """K2b's first call in a stage-2 step (kept by ``_k2b_spy``) against its
    plain version: 2e-2 max (relative to max(1, max|plain|)), 2e-4 mean."""
    from genhancer_tpu_torch.core.kernels import short_attention as K
    check(spy.call is not None, f"{path}: K2b never launched")
    (q, k, v, o, _, do, _), got = spy.call
    do = do.to(q.dtype)
    want = K.fused_attention_bwd_ref(q, k, v, o, do)
    abs_err, rel_err = _grad_errors(got, want)
    means = [_mean_rel(g, w) for g, w in zip(got, want)]
    print(f"{tag} K2b's first call in the step, {tuple(q.shape)} {str(q.dtype)[6:]}: "
          f"max err {abs_err:.3e} (rel {rel_err:.3e}, bound {BOUND['bfloat16']}); mean "
          f"|kernel - plain| / mean|plain| dq {means[0]:.3e}, dk {means[1]:.3e}, dv "
          f"{means[2]:.3e} (bound {ROUNDING_BOUND})", flush=True)
    check(rel_err <= BOUND["bfloat16"] and max(means) <= ROUNDING_BOUND,
          f"{path}: K2b in the stage-2 step disagrees with its plain version")


def _check_export(trainer, exports, tag):
    """The one HF export a stage-2 run wrote (``_export_timer``'s record):
    its seconds and bytes, its files, and ``registry.load_tower`` of it
    against the in-memory merged tower: class tokens (SigLIP: the
    MAP-pooled features) bit for bit and config.json.  Returns the export's
    directory."""
    import numpy as np
    import torch
    from genhancer_tpu_torch import registry
    from genhancer_tpu_torch.tasks.conditioning import normalize, tower_features, tower_stats
    from genhancer_tpu_torch.train import lora
    check(len(exports) == 1, f"{len(exports)} exports, expected 1")
    secs, nbytes, out = exports[0]
    print(f"{tag} HF export {os.path.basename(out)}: pytorch_model.bin of "
          f"{nbytes / 1e9:.3f} GB in {secs:.2f} s ({nbytes / 1e9 / secs:.2f} GB/s); files "
          f"{sorted(os.listdir(out))}", flush=True)
    check(sorted(os.listdir(out)) == ["config.json", "pytorch_model.bin"],
          f"export files {os.listdir(out)}")
    spec, st = trainer.spec, trainer.state
    dev, size = st.modules["clip"]["model"].logit_scale.device, spec.clip_image_size
    loaded, cfg_l = registry.load_tower(spec.tower_kind, spec.tower_cfg, out, device=dev)
    merged = lora.merge(st.modules["clip"]["model"])
    img = torch.from_numpy(np.random.default_rng(9).random((4, size, size, 3),
                                                           dtype=np.float32)).to(dev)
    px = normalize(img, *tower_stats(spec.tower_kind)).to(spec.compute_dtype)
    with torch.no_grad():
        a = tower_features(spec.tower_kind, {"model": loaded}, px, spec.tower_cfg)[0]
        b = tower_features(spec.tower_kind, {"model": merged}, px, spec.tower_cfg)[0]
    same = torch.equal(a, b) and cfg_l == spec.tower_cfg
    print(f"{tag} registry.load_tower(model_dir=export) class tokens "
          f"{'equal' if same else 'DIFFER FROM'} the in-memory merged tower's bit for bit "
          f"({tuple(a.shape)} {str(a.dtype)[6:]}); config.json read back "
          f"{'equal' if cfg_l == spec.tower_cfg else 'different'}", flush=True)
    check(same, "the exported tower does not reproduce the merged tower")
    del loaded, merged
    _free()
    return out


def phase_stage2_train(work, stage1, eval_root=None):
    """The port's Trainer on configs/MetaCLIP_large_stage2_all.yaml at full
    width from the stage-1 files of ``stage1`` (step 10 of phase_train's K3
    run): 7 steps, 3-6 timed and 7 under torch.profiler, K2b's first call
    held against its plain version, the HF export at the end timed and read
    back by ``registry.load_tower`` (then moved into ``eval_root`` for
    phase_eval); then ``stage2_only`` with ``fused_optimizer: pallas`` (K3
    over the LoRA leaves) for 4 steps.  Returns ({path: launch counts},
    the kept export's directory)."""
    import numpy as np
    from genhancer_tpu_torch.train.config import load_config

    check(stage1 is not None and os.path.exists(os.path.join(stage1, "checkpoint-dit-10.bin")),
          f"no stage-1 checkpoint to load from ({stage1})")
    base = load_config(STAGE2_CONFIG)
    base["data_config"]["img_dir"] = os.path.join(work, "shards")
    base.update(load_dir=stage1, load_step=10, log_interval=1, report_to="none",
                checkpointing_steps=0)
    runs, export = {}, None

    cfg = copy.deepcopy(base)
    steps = STAGE2_STEPS["train_stage2_all"]
    cfg.update(output_dir=os.path.join(work, "out-stage2-all"), max_train_steps=steps)
    exports, restore = _export_timer()
    profile = _LastStepProfile()
    try:
        with _k2b_spy() as spy:
            trainer, counts, wall, peak = _trainer_run(cfg, profile=profile)
    finally:
        restore()
    st, hist = trainer.state, trainer.history
    n_par = sum(p.numel() for p in st.trainable.values())
    n_tower = sum(k.startswith("clip.model.") for k in st.trainable)
    check([h["step"] for h in hist] == list(range(1, steps + 1)),
          f"stage2_all: synced steps {[h['step'] for h in hist]}")
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist),
          f"stage2_all: non-finite loss or grad norm: {hist}")
    check(n_tower == 652, f"stage2_all: {n_tower} trainable tower leaves, not 652")
    step_s = statistics.median(h["step_time"] for h in hist[2:6])
    print(f"[stage2] stage2_all: {len(st.trainable)} trainable leaves ({n_tower} LoRA and "
          f"wrapped-bias leaves of the tower), {n_par / 1e9:.4f} B params; {steps} steps in "
          f"{wall:.1f} s incl. the export; losses {[round(h['loss'], 4) for h in hist]}; "
          f"grad norms {[round(h['grad_norm'], 3) for h in hist]}", flush=True)
    print(f"[stage2] stage2_all: median step time of steps 3-6 {step_s * 1e3:.1f} ms = "
          f"{32 / step_s:.2f} img/s (B=16 x accumulation 2); peak device memory "
          f"{peak:.2f} GiB", flush=True)
    _print_device_time(profile.prof, 1, profile.wall_s,
                       tag=f"[stage2] stage2_all (step {steps}, profiled):")
    want = _stage2_want(trainer, steps)
    print(f"[stage2] stage2_all: kernel launches {counts}, expected {want}", flush=True)
    check(counts == want, f"stage2_all: launch counts {counts} != expected {want}")
    runs["train_stage2_all"] = counts

    _check_k2b_call(spy, "[stage2]", "stage2_all")
    del spy
    out = _check_export(trainer, exports, "[stage2]")
    if eval_root is not None:       # the MMVP-VLM eval reads it (phase_eval)
        keep = os.path.join(eval_root, os.path.basename(out))
        shutil.move(out, keep)
        export = keep
    del trainer, st
    _free()
    shutil.rmtree(cfg["output_dir"], ignore_errors=True)

    cfg = copy.deepcopy(base)
    cfg.update(task="image_stage2_only", fused_optimizer="pallas",
               output_dir=os.path.join(work, "out-stage2-only"),
               max_train_steps=STAGE2_STEPS["train_stage2_only"])
    trainer, counts, wall, peak = _trainer_run(cfg)
    st, hist = trainer.state, trainer.history
    steps = STAGE2_STEPS["train_stage2_only"]
    check([h["step"] for h in hist] == list(range(1, steps + 1))
          and all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist),
          f"stage2_only: {hist}")
    check(len(st.trainable) == 652 and all(k.startswith("clip.model.") for k in st.trainable),
          f"stage2_only: {len(st.trainable)} trainable leaves")
    step_s = statistics.median(h["step_time"] for h in hist[1:])
    print(f"[stage2] stage2_only, fused_optimizer: pallas: {steps} steps in {wall:.1f} s; "
          f"losses {[round(h['loss'], 4) for h in hist]}; median step time of steps 2-{steps} "
          f"{step_s * 1e3:.1f} ms = {32 / step_s:.2f} img/s; peak device memory "
          f"{peak:.2f} GiB", flush=True)
    want = _stage2_want(trainer, steps)
    print(f"[stage2] stage2_only: kernel launches {counts}, expected {want}", flush=True)
    check(counts == want, f"stage2_only: launch counts {counts} != expected {want}")
    runs["train_stage2_only"] = counts
    del trainer, st
    _free()
    shutil.rmtree(cfg["output_dir"], ignore_errors=True)
    return runs, export


SIGLIP_CONFIGS = {s: os.path.join(ROOT, "configs", f"SigLIP_384_{s}.yaml")
                  for s in ("stage1", "stage2_all", "stage2_only")}
# optimizer steps of phase_siglip's Trainer runs
SIGLIP_STEPS = {"siglip_stage1": 8, "siglip_stage2_all": 5, "siglip_stage2_only": 3}


def _siglip_want(trainer, steps):
    """Launch counts of ``steps`` optimizer steps of a SigLIP-384 image run,
    from the model: per micro-batch each DiT block runs K1 and K1b at the
    joint L = 577 and each tower layer K5 at L = 729 (and K5b in stage 2,
    where the tower trains); K3 takes each trainable leaf per step with
    ``fused_optimizer: pallas``; K2 and K2b never run."""
    spec, micro = trainer.spec, steps * trainer.accum
    blocks = spec.dit_cfg.depth + spec.dit_cfg.depth_single_blocks
    layers = spec.tower_cfg.vision.num_layers
    fused = trainer.cfg.get("fused_optimizer") == "pallas"
    return {**_no_launches(), "fused_rope_attention": micro * blocks,
            "fused_rope_attention_bwd": micro * blocks, "flash_attention": micro * layers,
            "flash_attention_bwd": micro * layers if spec.stage != "stage1" else 0,
            "fused_adamw": steps * len(trainer.state.trainable) if fused else 0}


def _siglip_report(tag, trainer, counts, wall, peak, steps, timed_from):
    """Check a SigLIP run's synced steps, print its losses, step time, peak
    memory and launches per step, and hold its launch counts to
    ``_siglip_want``."""
    import numpy as np
    hist = trainer.history
    check([h["step"] for h in hist] == list(range(1, steps + 1))
          and all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist),
          f"{tag}: synced steps {hist}")
    step_s = statistics.median(h["step_time"] for h in hist[timed_from - 1:])
    n_par = sum(p.numel() for p in trainer.state.trainable.values())
    print(f"[siglip] {tag}: {len(trainer.state.trainable)} trainable leaves, "
          f"{n_par / 1e9:.4f} B params; {steps} steps in {wall:.1f} s; losses "
          f"{[round(h['loss'], 4) for h in hist]}; median step time of steps {timed_from}-{steps} "
          f"{step_s * 1e3:.1f} ms = {32 / step_s:.2f} img/s (B=16 x accumulation 2); peak "
          f"device memory {peak:.2f} GiB", flush=True)
    want = _siglip_want(trainer, steps)
    per_step = {k: v // steps for k, v in counts.items() if v}
    print(f"[siglip] {tag}: kernel launches per optimizer step {per_step}; expected "
          f"{ {k: v // steps for k, v in want.items() if v} }", flush=True)
    check(counts == want, f"{tag}: launch counts {counts} != expected {want}")
    return step_s


def phase_siglip(work, eval_root=None):
    """The SigLIP-384 paths at full published width (so400m, 27 layers,
    L=729, D=72; the flux-dev DiT at joint L=577, which ``main`` cuts to 1 +
    1 blocks; B=16 x accumulation 2, bf16) on synthetic 384-px shards: the Trainer on
    configs/SigLIP_384_stage1.yaml 8 steps (steps 3-8 timed, 8 profiled);
    an engine serving its step-8 files (one reconstruct at B=1, one embed:
    [1, 1152]); configs/SigLIP_384_stage2_all.yaml from those files 5
    steps (3-5 timed, 5 profiled; K5b's first call in the step held against
    its plain version) with the merged ``siglip-so400m-patch14-384-5/``
    export timed and read back by ``registry.load_tower`` bit for bit
    (moved into ``eval_root`` for phase_eval); then
    configs/SigLIP_384_stage2_only.yaml with ``fused_optimizer: pallas``
    (K3 over the 981 LoRA leaves) 3 steps.  Returns ({path: launch
    counts}, the kept export's directory)."""
    import numpy as np
    import torch
    from genhancer_tpu_torch.core.kernels import flash_attention as F
    from genhancer_tpu_torch.serve.engine import InferenceEngine
    from genhancer_tpu_torch.train.config import load_config

    t0 = time.perf_counter()
    shards = _write_shards(os.path.join(work, "shards"), size=384)
    print(f"[siglip] wrote 4 synthetic shards of 96 384-px JPEGs in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    runs, export = {}, None
    out1 = os.path.join(work, "out-stage1")

    def config(stage, **kw):
        cfg = load_config(SIGLIP_CONFIGS[stage])
        cfg["data_config"]["img_dir"] = shards
        cfg.update(log_interval=1, report_to="none", output_dir=os.path.join(work, f"out-{stage}"),
                   max_train_steps=SIGLIP_STEPS[f"siglip_{stage}"], **kw)
        return cfg

    cfg = config("stage1", checkpointing_steps=SIGLIP_STEPS["siglip_stage1"])
    profile = _LastStepProfile()
    trainer, counts, wall, peak = _trainer_run(cfg, profile=profile)
    tower = trainer.state.modules["clip"]["model"]
    n_tower = sum(p.numel() for p in tower.parameters())
    print(f"[siglip] stage1: tower {type(tower).__name__} {n_tower / 1e6:.1f} M params "
          f"(L={trainer.spec.tower_cfg.vision.grid ** 2}, D=72), DiT joint L="
          f"{(trainer.spec.latent_hw[0] // 2) ** 2 + 1}", flush=True)
    check(n_tower == 428_225_600, f"stage1: the so400m vision tower holds {n_tower} params")
    steps = SIGLIP_STEPS["siglip_stage1"]
    step_s = _siglip_report("stage1", trainer, counts, wall, peak, steps, 3)
    _print_device_time(profile.prof, 1, profile.wall_s,
                       tag=f"[siglip] stage1 (step {steps}, profiled; {step_s * 1e3:.1f} ms "
                           f"unprofiled):")
    runs["siglip_stage1"] = counts
    del trainer, tower
    _free()
    os.remove(os.path.join(out1, f"optimizer-state-{steps}.bin"))

    engine = InferenceEngine.from_config(copy.deepcopy(cfg), device="cuda", load_dir=out1,
                                         load_step=steps, buckets=(1,), num_steps=4)
    img = np.random.default_rng(4).random((1, 384, 384, 3), dtype=np.float32)
    engine.reconstruct(img, seed=0)                     # warm
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = engine.reconstruct(img, seed=0)
    torch.cuda.synchronize()
    rec_ms = (time.perf_counter() - t0) * 1e3
    r_counts = {k: v for k, v in _read_counts().items() if v}
    t0 = time.perf_counter()
    emb = engine.embed(img)
    emb_ms = (time.perf_counter() - t0) * 1e3
    e_counts = {k: v for k, v in _read_counts().items() if v}
    blocks = engine.spec.dit_cfg.depth + engine.spec.dit_cfg.depth_single_blocks
    print(f"[siglip] engine on the stage-1 files: reconstruct B=1 at 384 px (4 Euler steps) "
          f"{rec_ms:.1f} ms, launches {r_counts}; embed {emb_ms:.1f} ms -> {emb.shape} "
          f"{emb.dtype}, launches then {e_counts}", flush=True)
    check(rec.shape == img.shape and np.isfinite(rec).all(), "siglip engine: reconstruct")
    check(emb.shape == (1, 1152) and emb.dtype == np.float32 and np.isfinite(emb).all(),
          f"siglip engine: embed {emb.shape}")
    check(r_counts == {"fused_rope_attention": 4 * blocks, "flash_attention": 27}
          and e_counts == {**r_counts, "flash_attention": 54},
          f"siglip engine: launches {r_counts}, {e_counts}")
    runs["serve_siglip"] = {**_no_launches(), **e_counts}
    del engine
    _free()

    cfg = config("stage2_all", load_dir=out1, load_step=steps, checkpointing_steps=0)
    steps = SIGLIP_STEPS["siglip_stage2_all"]
    exports, restore = _export_timer()
    profile = _LastStepProfile()
    try:
        with _BwdSpy(F) as spy:
            trainer, counts, wall, peak = _trainer_run(cfg, profile=profile)
    finally:
        restore()
    n_tower = sum(k.startswith("clip.model.") for k in trainer.state.trainable)
    check(n_tower == 981, f"stage2_all: {n_tower} trainable tower leaves, not 981")
    step_s = _siglip_report("stage2_all", trainer, counts, wall, peak, steps, 3)
    _print_device_time(profile.prof, 1, profile.wall_s,
                       tag=f"[siglip] stage2_all (step {steps}, profiled; {step_s * 1e3:.1f} ms "
                           f"unprofiled):")
    runs["siglip_stage2_all"] = counts
    check(spy.call is not None, "stage2_all: K5b never launched")
    (q, k, v, o, lse, do), got = spy.call
    want = F.flash_attention_bwd_ref(q, k, v, o, lse, do)
    abs_err, rel_err = _grad_errors(got, want)
    dv_mean = _mean_rel(got[2], want[2])
    print(f"[siglip] K5b's first call in the stage2_all step, {tuple(q.shape)} "
          f"{str(q.dtype)[6:]}: max err {abs_err:.3e} (rel {rel_err:.3e}, bound "
          f"{BOUND['bfloat16']}); dv mean|kernel - plain| / mean|plain| {dv_mean:.3e} "
          f"(bound {ROUNDING_BOUND})", flush=True)
    check(tuple(q.shape) == (16, 729, 16, 72), f"K5b in the step at {tuple(q.shape)}")
    check(rel_err <= BOUND["bfloat16"] and dv_mean <= ROUNDING_BOUND,
          "stage2_all: K5b in the step disagrees with its plain version")
    del spy, q, k, v, o, lse, do, got, want
    out = _check_export(trainer, exports, "[siglip]")
    check(os.path.basename(out) == f"siglip-so400m-patch14-384-{steps}", f"export {out}")
    if eval_root is not None:       # the MMVP-VLM eval reads it (phase_eval)
        export = os.path.join(eval_root, os.path.basename(out))
        shutil.move(out, export)
    del trainer
    _free()
    shutil.rmtree(cfg["output_dir"], ignore_errors=True)

    cfg = config("stage2_only", load_dir=out1, load_step=SIGLIP_STEPS["siglip_stage1"],
                 checkpointing_steps=0, fused_optimizer="pallas")
    steps = SIGLIP_STEPS["siglip_stage2_only"]
    trainer, counts, wall, peak = _trainer_run(cfg)
    check(len(trainer.state.trainable) == 981
          and all(k.startswith("clip.model.") for k in trainer.state.trainable),
          f"stage2_only: {len(trainer.state.trainable)} trainable leaves")
    _siglip_report("stage2_only, fused_optimizer: pallas", trainer, counts, wall, peak, steps, 2)
    runs["siglip_stage2_only"] = counts
    del trainer
    _free()
    shutil.rmtree(cfg["output_dir"], ignore_errors=True)
    return runs, export


def _int8_want(trainer, steps):
    """Launch counts of ``steps`` optimizer steps of an int8 run, from the
    model: per micro-batch each DiT block runs K1/K1b once and each tower
    layer K2; the frozen tower's int8 linears quantize their input once
    (K7) and every SwitchBack linear its input and its gradient (K7 twice),
    with K8 for its dW under ``int8_dw`` (every SwitchBack input has at
    least B = 32 rows: ``dw_supported``'s T >= 8 holds); per step each
    trainable leaf takes one optimizer kernel — K6 on the 8-bit-moment
    leaves, K4 on the cached ones, K6's quant body on both, K3 elsewhere."""
    from genhancer_tpu_torch.core.kernels import int8_dw as K8
    from genhancer_tpu_torch.core.kernels.adamw import Moment8
    from genhancer_tpu_torch.core.nn import Int8Layer
    spec, st = trainer.spec, trainer.state
    cache = set(st.quant)
    m8 = {k for k, m in st.opt_state["mu"].items() if isinstance(m, Moment8)}
    micro = steps * trainer.accum
    tower_int8 = sum(isinstance(m, Int8Layer) for m in st.modules["clip"]["model"].modules())
    blocks = spec.dit_cfg.depth + spec.dit_cfg.depth_single_blocks
    k8 = (sum(K8.dw_supported(32, *st.trainable[k].shape) for k in cache)
          if spec.dit_quant == "int8_dw" else 0)
    return {**_no_launches(), "fused_rope_attention": micro * blocks,
            "fused_rope_attention_bwd": micro * blocks,
            "fused_attention": micro * spec.tower_cfg.vision.num_layers,
            "fused_adamw": steps * (len(st.trainable) - len(cache | m8)),
            "fused_adamw_quant": steps * len(cache - m8),
            "fused_adamw8": steps * len(m8 - cache), "fused_adamw8_quant": steps * len(m8 & cache),
            "rowquant": micro * (tower_int8 + 2 * len(cache)), "int8_dw": micro * k8}


def _int8_report(name, trainer, counts, wall, peak, steps, timed_from, timed_to=None):
    import numpy as np
    from genhancer_tpu_torch.core.nn import Int8Layer
    hist, st = trainer.history, trainer.state
    check([h["step"] for h in hist] == list(range(1, steps + 1)),
          f"{name}: synced steps {[h['step'] for h in hist]}")
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist),
          f"{name}: non-finite loss or grad norm: {hist}")
    timed_to = timed_to or steps
    step_s = statistics.median(h["step_time"] for h in hist[timed_from:timed_to])
    n_lin = sum(isinstance(m, Int8Layer) for m in st.modules["clip"]["model"].modules())
    n_conv = sum(isinstance(m, Int8Layer) for m in st.modules["vae"].modules())
    batch = int(trainer.cfg.get_path("data_config.train_batch_size")) * trainer.accum
    print(f"[int8] {name}: {n_lin} int8 tower linears, {n_conv} int8 VAE encoder convs, "
          f"{len(st.quant)} SwitchBack weights cached; {steps} steps in {wall:.1f} s; losses "
          f"{[round(h['loss'], 4) for h in hist]}; median step time of steps "
          f"{timed_from + 1}-{timed_to} {step_s * 1e3:.1f} ms = {batch / step_s:.2f} img/s "
          f"(B={batch}); peak device memory {peak:.2f} GiB", flush=True)
    want = _int8_want(trainer, steps)
    print(f"[int8] {name}: kernel launches {counts}, expected {want}", flush=True)
    check(counts == want, f"{name}: launch counts {counts} != expected {want}")


# device kernels by what they compute: (label, substrings of the kernel name)
DEVICE_KINDS = (("K1/K2 (short fwd, RoPE pass)", ("short_fwd_kernel", "rope_qk")),
                ("K5 (flash fwd)", ("sm90::fwd_kernel",)),
                ("K1b (short bwd)", ("dkdv_kernel<128, false, true>",
                                     "dkdv_kernel<64, false, true>",
                                     "short_dq_kernel<128, true>", "short_dq_kernel<64, true>")),
                ("K2b (short bwd)", ("dkdv_kernel<128, false, false>",
                                     "dkdv_kernel<64, false, false>",
                                     "short_dq_kernel<128, false>",
                                     "short_dq_kernel<64, false>")),
                ("K5b (flash bwd)", ("sm90::dkdv_kernel", "sm90::dq_kernel")),
                ("D_i rows (K1b/K2b/K5b)", ("dot_rows",)),
                ("K8 (int8_dw)", ("dw_kernel", "colquant_kernel")),
                ("K7 (rowquant)", ("rowquant_warp_kernel", "rowquant_block_kernel",
                                   "rowquant_scalar_kernel")),
                ("K4 (adamw_quant)", ("adamw_quant_kernel", "adamw_quant_l2_kernel")),
                ("K6 (adamw8)", ("adamw8_rows_kernel", "adamw8_kernel")),
                ("K3 (adamw)", ("adamw_kernel",)),
                ("int8 GEMM (_int_mm)", ("gemm_s8", "s8gemm", "imma")),
                ("bf16/f32 GEMM and conv", ("gemm", "nvjet", "xmma", "conv", "cutlass")))


def _print_device_time(prof, steps, step_s, tag="[int8]"):
    """Device time per step by kind of kernel from a torch.profiler run of
    ``steps`` steps; copies (the checkpoint the trainer writes when it
    stops) are left out; the rest is eager elementwise, cast and reduction
    work."""
    by_kind, total = {}, 0.0
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        us = evt.self_cuda_time_total if us is None else us
        if us <= 0 or "Memcpy" in evt.key or "Memset" in evt.key:
            continue
        total += us
        kind = next((k for k, pats in DEVICE_KINDS if any(p in evt.key for p in pats)),
                    "elementwise, casts, reductions")
        by_kind[kind] = by_kind.get(kind, 0.0) + us
    per_step = total / steps / 1e3
    print(f"{tag} device kernel time per step {per_step:.1f} ms of {step_s * 1e3:.1f} ms wall "
          f"(busy {per_step / (step_s * 1e3):.3f}): "
          + ", ".join(f"{k} {v / steps / 1e3:.1f} ms ({v / total:.1%})"
                      for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])), flush=True)


def phase_train_int8(work):
    """The port's Trainer on configs/tpu_fast_stage1.yaml at full width: 8
    steps and a resume for steps 9-10 whose rebuilt int8 cache must equal
    the one K4 emitted at step 8; then the int8_dw + 8-bit-moment variant
    for 5 steps, 2-3 timed and 4-5 profiled.  Returns ({path: launch
    counts}, the int8_full run's output directory, whose step-10 files the
    fast stage-2 paths load)."""
    import torch
    from genhancer_tpu_torch.train.config import load_config
    from genhancer_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    shards = _write_shards(os.path.join(work, "shards"))
    print(f"[int8] wrote 4 synthetic shards of 96 256-px JPEGs in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    base = load_config(INT8_CONFIG)
    base["data_config"]["img_dir"] = shards
    base.update(log_interval=1, report_to="none")
    runs = {}

    cfg = copy.deepcopy(base)
    cfg.update(output_dir=os.path.join(work, "out-int8"), max_train_steps=8,
               checkpointing_steps=8)
    trainer, counts, wall, peak = _trainer_run(cfg, plan="tpu_fast_stage1 (int8_full, K4)")
    _int8_report("int8_full", trainer, counts, wall, peak, 8, 2)
    emitted = {k: (q.cpu(), s.cpu()) for k, (q, s) in trainer.state.quant.items()}
    runs["train_int8"] = counts
    del trainer
    _free()
    cfg2 = copy.deepcopy(cfg)
    cfg2.update(max_train_steps=10, resume_from_checkpoint="latest")
    trainer = Trainer(cfg2, device="cuda")
    check(trainer.state.step == 8, f"int8 resume at step {trainer.state.step}, not 8")
    same = (set(trainer.state.quant) == set(emitted)
            and all(torch.equal(trainer.state.quant[k][0].cpu(), q)
                    and torch.equal(trainer.state.quant[k][1].cpu(), s)
                    for k, (q, s) in emitted.items()))
    print(f"[int8] resume: the int8 cache rebuilt from checkpoint-dit-8.bin "
          f"{'equals' if same else 'DIFFERS FROM'} the one K4 emitted at step 8 "
          f"({len(emitted)} weights)", flush=True)
    check(same, "the cache rebuilt on resume differs from the emitted one")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        trainer.train()
        torch.cuda.synchronize()
    hist2 = trainer.history
    check([h["step"] for h in hist2] == [9, 10], f"int8 resume ran {hist2}")
    print(f"[int8] resume ran steps 9-10 (profiled), losses "
          f"{[round(h['loss'], 4) for h in hist2]}", flush=True)
    _print_device_time(prof, 2, sum(h["step_time"] for h in hist2) / 2)
    del trainer, emitted
    _free()
    stage1 = cfg["output_dir"]      # step 10's files: phase_fast_stage2 loads them

    cfg = copy.deepcopy(base)
    cfg.update(output_dir=os.path.join(work, "out-int8-dw"), max_train_steps=5,
               checkpointing_steps=0, dit_quant="int8_dw", optimizer_moment_bits=8)
    # steps 2-3 timed, 4-5 under the profiler (its start and stop in no timed step)
    profile = _LastStepProfile(steps=2)
    trainer, counts, wall, peak = _trainer_run(cfg, profile=profile)
    _int8_report("int8_dw + 8-bit moments", trainer, counts, wall, peak, 5, 1, timed_to=3)
    _print_device_time(profile.prof, 2, profile.wall_s / 2,
                       tag="[int8] int8_dw + 8-bit moments, steps 4-5 (profiled):")
    runs["train_int8_dw"] = counts
    del trainer
    _free()
    shutil.rmtree(cfg["output_dir"], ignore_errors=True)
    return runs, stage1

def _video_want(spec, steps):
    """Launch counts of ``steps`` optimizer steps (accumulation 2) of a
    video mode: the tower's 24 layers run K2 once per micro-batch (twice
    with ``tower_remat``: the recompute in the backward) and, in stage 2,
    K2b once; each of the 6 DiT blocks runs K1/K1b below 600 joint tokens
    and K5/K5b above, K5 twice with remat (the forward again in the
    backward)."""
    micro, blocks = 2 * steps, spec.dit_cfg.depth + spec.dit_cfg.depth_single_blocks
    layers, stage2 = spec.tower_cfg.vision.num_layers, spec.stage == "stage2_all"
    seq = spec.n_cond * spec.patch_grid ** 2 + (spec.latent_hw[0] // 2) ** 2
    long_ = seq >= 600
    return {**_no_launches(), "fused_rope_attention": 0 if long_ else micro * blocks,
            "fused_rope_attention_bwd": 0 if long_ else micro * blocks,
            "fused_attention": micro * layers * (2 if stage2 and spec.tower_remat else 1),
            "fused_attention_bwd": micro * layers if stage2 else 0,
            "flash_attention": micro * blocks * (2 if spec.remat else 1) if long_ else 0,
            "flash_attention_bwd": micro * blocks if long_ else 0}


# video modes whose stage 1 and 2 (and the fast video stage 2, on
# middle@336's files) run the DiT cut to 1 + 1 blocks, to keep the whole
# run inside 1100 s (sliding keeps full depth:
# K5/K5b's main path and phase_sp_pp's reference)
DEPTH_CUT_MODES = ("next", "next2", "middle")


def _video_depth(mode):
    """The DiT depth cut of ``mode``'s runs while open (or no cut)."""
    return _DitDepth(1, 1) if mode in DEPTH_CUT_MODES else contextlib.nullcontext()


def _write_video_shards(root, frames, n_shards=2):
    from genhancer_tpu_torch.data.testing import make_video_shard
    os.makedirs(root, exist_ok=True)
    for i in range(n_shards):
        make_video_shard(os.path.join(root, f"video-{i:03d}.tar"), len(frames), frames,
                         256, seed=100 + i)
    return root


class _LastStepProfile:
    """Runs a Trainer's last ``steps`` steps under torch.profiler (CUDA
    activity), synchronised on both sides, so that the trace holds those
    steps' device work and no warm-up; ``wall_s`` is their time with the
    profiler on."""

    def __init__(self, steps: int = 1):
        self.steps, self.prof, self.wall_s = steps, None, None
        self.step_peak = 0.0     # GiB allocated at most by the steps (no checkpoint)

    def install(self, trainer):
        import torch
        inner, left = trainer.step_fn, [trainer.max_steps - trainer.state.step]
        t0 = [0.0]

        def step_fn(*args):
            left[0] -= 1
            if left[0] == self.steps - 1:
                torch.cuda.synchronize()
                self.prof = torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA])
                self.prof.start()
                t0[0] = time.perf_counter()
            out = inner(*args)
            if left[0] == 0:
                torch.cuda.synchronize()
                self.wall_s = time.perf_counter() - t0[0]
                self.prof.stop()
            self.step_peak = max(self.step_peak, torch.cuda.max_memory_allocated() / 2**30)
            return out
        trainer.step_fn = step_fn


def _plan_report(tag, got, peak_bytes) -> None:
    """``genhancer-plan-torch``'s static bytes per rank against a live
    state's (``parallel.testing.plan_vs_live``, taken at the Trainer's
    construction): equal, byte for byte; its activation estimate printed
    beside the measured peak, with no bound (a heuristic)."""
    check(got["plan"] == got["live"], f"plan {tag}: static bytes {got['plan']} != the live "
          f"state's {got['live']}")
    live = got["live"]
    static = sum(live.values())
    print(f"[plan] {tag}: the planner's static bytes per rank equal the live state's "
          f"(trainable {live['trainable'] / 2**30:.3f}, frozen {live['frozen'] / 2**30:.3f}, "
          f"optimizer {live['opt_state'] / 2**30:.3f} GiB); its activation estimate "
          f"{got['activations_est'] / 2**30:.2f} GiB ({got['note']}) beside the measured "
          f"peak {peak_bytes / 2**30:.2f} GiB, of which static {static / 2**30:.2f}", flush=True)


def _trainer_run(cfg, steps_done=0, profile=None, record=False, plan=None):
    """Build a Trainer for ``cfg``, zero the counts, train (the last steps
    under ``profile``, a _LastStepProfile, when one is given; with
    ``record`` keeping the host batches in ``trainer.loader.batches``;
    with ``plan`` a tag, the planner held to the built state); returns
    (trainer, launch counts, wall seconds, peak GiB)."""
    import torch
    from genhancer_tpu_torch.parallel.testing import plan_vs_live
    from genhancer_tpu_torch.train.trainer import Trainer
    trainer = Trainer(cfg, device="cuda")
    planned = plan_vs_live(trainer) if plan else None
    if record:
        trainer.loader = _Recording(trainer.loader)
    check(trainer.state.step == steps_done,
          f"{cfg['task']}: Trainer starts at step {trainer.state.step}, not {steps_done}")
    if profile is not None:
        profile.install(trainer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    if planned is not None:
        _plan_report(plan, planned, torch.cuda.max_memory_allocated())
    return (trainer, _read_counts(), time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2**30)


def phase_video_train(work):
    """The port's Trainer on the four published stage-1 video configs at full
    width and published batch (``DEPTH_CUT_MODES`` with the DiT cut to 1 + 1
    blocks); returns ({path: launch counts}, {mode:
    (output dir, step)}: the component files of each mode's last step,
    which phase_video_stage2 loads, and sliding's losses and first host
    batches, which phase_sp_pp replays)."""
    import numpy as np
    from genhancer_tpu_torch.train import checkpoint as ckpt
    from genhancer_tpu_torch.train.config import load_config

    t0 = time.perf_counter()
    # sliding: every third video has 6 frames (3 windows of 8), leaving
    # padded rows; the others 12 (8 windows)
    sliding_dir = _write_video_shards(os.path.join(work, "sliding"),
                                      [6 if i % 3 == 0 else 12 for i in range(12)])
    pair_dir = _write_video_shards(os.path.join(work, "clips"), [4] * 40)
    print(f"[video] wrote synthetic video shards (256-px JPEG frames) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def device_time(profile, step):
        _print_device_time(profile.prof, 1, profile.wall_s,
                           f"[video] {mode} (step {step}, profiled):")

    runs, stage1, sliding_ref = {}, {}, None
    for mode, name in VIDEO_CONFIGS.items():
        with _video_depth(mode):
            cfg = load_config(os.path.join(ROOT, "configs", name))
            cfg["data_config"]["video_dir"] = sliding_dir if mode == "sliding" else pair_dir
            steps = 8 if mode == "sliding" else 3
            # one checkpoint at the last step: sliding's resume and stage 2 load it
            cfg.update(output_dir=os.path.join(work, f"out-{mode}"), max_train_steps=steps,
                       checkpointing_steps=steps, log_interval=1, report_to="none")
            t0 = time.perf_counter()
            # sliding: steps 3-8 timed, the resume's step 10 profiled; the
            # others: step 2 timed, step 3 profiled
            profile = None if mode == "sliding" else _LastStepProfile()
            trainer, counts, wall, peak = _trainer_run(cfg, profile=profile,
                                                       record=mode == "sliding")
            spec, hist = trainer.spec, trainer.history
            if mode == "sliding":       # phase_sp_pp (a) replays these batches
                sliding_ref = {"loss": [h["loss"] for h in hist],
                               "batches": trainer.loader.batches[:2 * SP_PP_STEPS]}
            rows = int(cfg.get_path("data_config.train_batch_size")) * (
                int(cfg.get("max_windows_per_video", 1)) if mode == "sliding" else 1) * 2
            check([h["step"] for h in hist] == list(range(1, steps + 1)),
                  f"{mode}: synced steps {[h['step'] for h in hist]}")
            check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist),
                  f"{mode}: non-finite loss or grad norm: {hist}")
            timed = hist[2:] if mode == "sliding" else hist[1:-1]
            step_s = statistics.median(h["step_time"] for h in timed)
            seq = spec.n_cond * spec.patch_grid ** 2 + (spec.latent_hw[0] // 2) ** 2
            print(f"[video] {mode} ({name}): joint L={seq}, remat {spec.remat}; {steps} steps "
                  f"in {wall:.1f} s (Trainer built in {time.perf_counter() - t0 - wall:.1f} s); "
                  f"losses {[round(h['loss'], 4) for h in hist]}", flush=True)
            rate = f"{rows / step_s:.2f} rows/s ({rows} rows per optimizer step)"
            if mode == "sliding":
                # rows past a short video's windows are padding (valid=False):
                # count the valid ones over the timed steps
                eff = [h["bs_eff"] for h in hist]
                check(min(eff) < 16, f"sliding: no padded rows occurred ({eff})")
                valid_s = sum(2 * h["bs_eff"] for h in timed) / sum(h["step_time"] for h in timed)
                rate = (f"{valid_s:.2f} valid rows/s over steps 3-{steps} ({rows / step_s:.2f} "
                        f"padded rows/s at {rows} rows per optimizer step; valid rows per "
                        f"micro-batch, mean of 2: {eff})")
            print(f"[video] {mode}: median step time of steps {timed[0]['step']}-"
                  f"{timed[-1]['step']} {step_s * 1e3:.1f} ms = {rate}; peak device "
                  f"memory {peak:.2f} GiB", flush=True)
            if profile is not None:
                device_time(profile, steps)
            want = _video_want(spec, steps)
            print(f"[video] {mode}: kernel launches {counts}, expected {want}", flush=True)
            check(counts == want, f"{mode}: launch counts {counts} != expected {want}")
            runs[f"video_{mode}"] = counts
            out = cfg["output_dir"]
            del trainer
            _free()
            if mode == "sliding":
                for pat in ("checkpoint-dit-{}.bin", "checkpoint-project-clip-{}.bin",
                            "checkpoint-visual-adapter-{}.bin", "optimizer-state-{}.bin"):
                    check(os.path.exists(os.path.join(out, pat.format(8))),
                          f"sliding: {pat.format(8)} missing")
                ckpt.prune_checkpoints(out, 1)     # bound the disk: keep step 8 only
                cfg2 = copy.deepcopy(cfg)
                cfg2.update(max_train_steps=10, resume_from_checkpoint="latest")
                profile = _LastStepProfile()
                trainer, _, wall, _ = _trainer_run(cfg2, steps_done=8, profile=profile)
                hist2 = trainer.history
                check([h["step"] for h in hist2] == [9, 10]
                      and all(np.isfinite(h["loss"]) for h in hist2), f"sliding resume: {hist2}")
                print(f"[video] sliding: a second Trainer loaded checkpoint-dit-8, "
                      f"-project-clip-8, -visual-adapter-8 (strict) and optimizer-state-8, "
                      f"resumed at step 8 and ran steps 9-10 in {wall:.1f} s, losses "
                      f"{[round(h['loss'], 4) for h in hist2]}", flush=True)
                device_time(profile, 10)
                del trainer
                _free()
            del profile
            # stage 2 loads the last step's components; the rest goes
            last = ckpt.latest_step(out)
            ckpt.prune_checkpoints(out, 1)
            os.remove(os.path.join(out, f"optimizer-state-{last}.bin"))
            stage1[mode] = (out, last)
    return runs, stage1, sliding_ref


def _video2_report(mode, trainer, counts, wall, peak, profile, steps):
    """Prints and checks one video stage-2 run: synced steps, losses, the
    trainable tower leaves, step time of steps 2-3, rows/s, peak memory (of
    the run and of its steps), the profiled last step and the launch
    counts."""
    import numpy as np
    spec, hist, st = trainer.spec, trainer.history, trainer.state
    n_tower = sum(k.startswith("clip.model.") for k in st.trainable)
    check([h["step"] for h in hist] == list(range(1, steps + 1)),
          f"{mode} stage 2: synced steps {[h['step'] for h in hist]}")
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist),
          f"{mode} stage 2: non-finite loss or grad norm: {hist}")
    check(n_tower == 652, f"{mode} stage 2: {n_tower} trainable tower leaves, not 652")
    timed = hist[1:-1]
    step_s = statistics.median(h["step_time"] for h in timed)
    seq = spec.n_cond * spec.patch_grid ** 2 + (spec.latent_hw[0] // 2) ** 2
    frames = 16 * spec.n_cond      # 16 rows per micro-batch (sliding: 2 videos x 8 windows)
    rate = f"{32 / step_s:.2f} rows/s (32 rows per optimizer step)"
    if mode == "sliding":
        valid_s = sum(2 * h["bs_eff"] for h in timed) / sum(h["step_time"] for h in timed)
        rate = (f"{valid_s:.2f} valid rows/s ({32 / step_s:.2f} padded rows/s; valid rows "
                f"per micro-batch, mean of 2: {[h['bs_eff'] for h in hist]})")
    print(f"[video2] {mode}: joint L={seq}, remat {spec.remat}, tower_remat "
          f"{spec.tower_remat}, {frames} tower frames of L={spec.patch_grid ** 2 + 1} per "
          f"micro-batch; {len(st.trainable)} trainable leaves ({n_tower} of the tower); "
          f"{steps} steps in {wall:.1f} s incl. the export; losses "
          f"{[round(h['loss'], 4) for h in hist]}", flush=True)
    print(f"[video2] {mode}: median step time of steps 2-{steps - 1} {step_s * 1e3:.1f} ms = "
          f"{rate}; peak device memory {peak:.2f} GiB (steps alone {profile.step_peak:.2f} "
          f"GiB)", flush=True)
    _print_device_time(profile.prof, 1, profile.wall_s,
                       f"[video2] {mode} (step {steps}, profiled):")
    want = _video_want(spec, steps)
    print(f"[video2] {mode}: kernel launches {counts}, expected {want}", flush=True)
    check(counts == want, f"{mode} stage 2: launch counts {counts} != expected {want}")


def _peak_of_steps(cfg, n=2):
    """A Trainer for ``cfg`` whose first ``n`` steps run by hand (no
    checkpoint): (peak GiB allocated by them, their seconds), or (None,
    the error) where the card runs out of memory."""
    import numpy as np
    import torch
    from genhancer_tpu_torch.train.trainer import Trainer
    trainer = Trainer(cfg, device="cuda")
    batches = trainer._batches()
    it = iter(batches)
    out = None
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        secs = []
        for i in range(n):
            batch = next(it)
            batch.pop("__extras__", None)
            trainer.generator.manual_seed(i)
            t0 = time.perf_counter()
            trainer.state, m = trainer.step_fn(trainer.state, batch, trainer.generator)
            check(bool(np.isfinite(float(m["loss"]))), "non-finite loss")
            secs.append(time.perf_counter() - t0)
        out = (torch.cuda.max_memory_allocated() / 2**30, secs, trainer.spec)
    except torch.cuda.OutOfMemoryError as e:
        out = (None, str(e)[:200], trainer.spec)
    finally:
        batches.close()
        trainer.loader.close()
        del trainer
        _free()
    return out


def phase_video_stage2(work, stage1, eval_root=None):
    """The port's Trainer on the four published video stage-2 configs at full
    width and published batch x accumulation 2 (LoRA on all 218 linears of
    OpenAI CLIP-L/14, the tower under autograd: K2b; the gates' DiT remat
    and tower_remat), each from its own mode's stage-1 files: 3 steps, 2
    timed, 3 under torch.profiler, K2b's first call held against its plain
    version, the HF export at the end timed and read back; middle@336's
    export kept in ``eval_root`` for phase_eval, its steps' peak memory
    measured again with tower_remat off; next resumed for a fourth step (the
    LoRA factors restart).  Returns ({path: launch counts}, middle@336's
    export)."""
    import numpy as np
    from genhancer_tpu_torch.train.config import load_config
    from genhancer_tpu_torch.train.trainer import Trainer

    runs, export = {}, None
    steps = STAGE2_STEPS["video_middle_stage2"]
    for mode, name in VIDEO2_CONFIGS.items():
        with _video_depth(mode):
            check(mode in stage1, f"{mode}: no stage-1 files to load")
            load_dir, load_step = stage1[mode]
            cfg = load_config(os.path.join(ROOT, "configs", name))
            cfg["data_config"]["video_dir"] = os.path.join(
                work, "sliding" if mode == "sliding" else "clips")
            cfg.update(output_dir=os.path.join(work, f"out2-{mode}"), max_train_steps=steps,
                       checkpointing_steps=0, log_interval=1, report_to="none",
                       load_dir=load_dir, load_step=load_step)
            exports, restore = _export_timer()
            profile = _LastStepProfile()
            try:
                with _k2b_spy() as spy:
                    trainer, counts, wall, peak = _trainer_run(cfg, profile=profile)
            finally:
                restore()
            print(f"[video2] {mode} ({name}): loaded the stage-1 components of step "
                  f"{load_step}", flush=True)
            _video2_report(mode, trainer, counts, wall, peak, profile, steps)
            runs[f"video_{mode}_stage2"] = counts
            _check_k2b_call(spy, f"[video2] {mode}:", f"video {mode} stage 2")
            del spy
            out = _check_export(trainer, exports, f"[video2] {mode}:")
            del trainer
            _free()
            if mode == "middle":
                if eval_root is not None:
                    export = os.path.join(eval_root, os.path.basename(out))
                    shutil.move(out, export)
                on, off = copy.deepcopy(cfg), copy.deepcopy(cfg)
                on.update(output_dir=os.path.join(work, "out2-middle-on"),
                          resume_from_checkpoint=None)
                off.update(output_dir=os.path.join(work, "out2-middle-off"),
                           resume_from_checkpoint=None, tower_remat=False)
                # one step each, to stay inside 1100 s
                on_peak, on_s, _ = _peak_of_steps(on, 1)
                off_peak, off_s, off_spec = _peak_of_steps(off, 1)
                for c in (on, off):
                    shutil.rmtree(c["output_dir"], ignore_errors=True)
                check(not off_spec.tower_remat and on_peak is not None, "middle: remat runs")
                print(f"[video2] middle@336 peak device memory of 1 step by hand: tower_remat on "
                      f"(the gate's) {on_peak:.2f} GiB ({[round(x, 3) for x in on_s]} s), off "
                      + (f"{off_peak:.2f} GiB ({[round(x, 3) for x in off_s]} s)"
                         if off_peak is not None else f"out of memory ({off_s})"), flush=True)
            if mode == "next":
                cfg2 = copy.deepcopy(cfg)
                cfg2.update(max_train_steps=steps + 1)      # resume_from_checkpoint: latest
                trainer = Trainer(cfg2, device="cuda")
                check(trainer.state.step == steps, f"next stage 2: resumed at {trainer.state.step}")
                b_zero = all(not p.any() for k, p in trainer.state.trainable.items()
                             if k.endswith(".lora_B"))
                trainer.train()
                hist2 = trainer.history
                check([h["step"] for h in hist2] == [steps + 1] and b_zero
                      and all(np.isfinite(h["loss"]) for h in hist2),
                      f"next stage 2 resume: {hist2}, LoRA B restarted at 0: {b_zero}")
                print(f"[video2] next: a second Trainer resumed at step {steps} (components and "
                      f"optimizer state; every lora_B back at its initial 0) and ran step "
                      f"{steps + 1}, loss {hist2[0]['loss']:.4f}", flush=True)
                del trainer
                _free()
            shutil.rmtree(cfg["output_dir"], ignore_errors=True)
            if mode != "middle":        # phase_fast_video loads middle@336's
                shutil.rmtree(load_dir, ignore_errors=True)
    return runs, export


def phase_eval(work, exports):
    """``evaluate_model_dir`` at full width on the card, on each stage-2
    export of ``exports`` ({label: (dir, tower, clip_image_size)}): a
    synthetic MMVP-VLM tree of 9 categories x 15 pairs (270 JPEGs) and a
    deterministic tokenizer in place of the HF one (injected as
    ``mmvp.default_tokenizer``: 77 tokens for CLIP, 64 for SigLIP).  Prints
    the seconds, images/s and texts/s (the feature calls, synced) and checks
    nine categories + the average, 135 CSV rows and scores in [0, 100]; the
    first pair's image and text embeddings are held against the CPU's plain
    path on the same export at 1e-4 of their largest.  Returns {path:
    launch counts}."""
    import csv
    import numpy as np
    import torch
    from genhancer_tpu_torch import registry
    from genhancer_tpu_torch.eval import mmvp
    from genhancer_tpu_torch.models.towers import clip as cm
    from genhancer_tpu_torch.models.towers import siglip as sm

    t0 = time.perf_counter()
    bench = _write_mmvp(os.path.join(work, "mmvp"), EVAL_PAIRS, 336)
    print(f"[eval] wrote a synthetic MMVP-VLM tree (9 x {EVAL_PAIRS} pairs, "
          f"{18 * EVAL_PAIRS} 336-px JPEGs) in {time.perf_counter() - t0:.1f} s", flush=True)
    toks = {"clip": _toy_tokenize(77, 49407), "siglip": _toy_tokenize(64, 1)}
    names = ("get_image_features", "get_text_features")
    calls = {n: [] for n in names}

    def timed(inner, name):
        def fn(model, x, cfg, *a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = inner(model, x, cfg, *a)
            torch.cuda.synchronize()
            calls[name].append((time.perf_counter() - t, x.shape[0], out[:2].float().cpu()))
            return out
        return fn

    runs, default_tok = {}, mmvp.default_tokenizer
    mmvp.default_tokenizer = lambda d, k: toks[k]
    try:
        for label, (model_dir, tower, size) in exports.items():
            check(model_dir is not None and os.path.isdir(model_dir), f"{label}: no export")
            kind = "siglip" if tower == "siglip" else "clip"
            mod, tok = (sm if kind == "siglip" else cm), toks[kind]
            inner = {n: getattr(mod, n) for n in names}
            for n in names:
                calls[n] = []
                setattr(mod, n, timed(inner[n], n))
            csv_path = os.path.join(work, f"eval-{size}.csv")
            _zero_counts()
            t0 = time.perf_counter()
            try:
                res = mmvp.evaluate_model_dir(model_dir, bench, tower=tower, clip_image_size=size,
                                              results_csv=csv_path, device="cuda")
            finally:
                for n in names:
                    setattr(mod, n, inner[n])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = _read_counts()
            with open(csv_path) as f:
                rows = list(csv.reader(f))[1:]
            img_s = sum(c[0] for c in calls["get_image_features"])
            txt_s = sum(c[0] for c in calls["get_text_features"])
            n_img = sum(c[1] for c in calls["get_image_features"])
            n_txt = sum(c[1] for c in calls["get_text_features"])
            print(f"[eval] {label}: evaluate_model_dir({os.path.basename(model_dir)}) in "
                  f"{secs:.2f} s (loading, preprocessing, embedding, scoring) = "
                  f"{n_img / secs:.2f} images/s end to end; image features {n_img} in "
                  f"{img_s:.3f} s = {n_img / img_s:.1f} images/s, text features {n_txt} in "
                  f"{txt_s:.3f} s = {n_txt / txt_s:.1f} texts/s (batches of 50, float32, "
                  f"synced); average_score {res['average_score']:.2f}", flush=True)
            tcfg = registry.tower_config(kind, model_dir)
            batches = -(-n_img // 50)
            # the image side: K2 at CLIP's 257 or 577 tokens, K5 at SigLIP's
            # 729; SigLIP's unmasked text side: K2 (CLIP's is masked: einsum)
            want = {**_no_launches(), "fused_attention": tcfg.vision.num_layers * batches}
            if kind == "siglip":
                want.update(flash_attention=tcfg.vision.num_layers * batches,
                            fused_attention=tcfg.text.num_layers * batches)
            print(f"[eval] {label}: kernel launches {counts}, expected {want}", flush=True)
            check(sorted(res) == sorted(mmvp.CATEGORIES + ["average_score"])
                  and all(0.0 <= x <= 100.0 for x in res.values()) and len(rows) == 135
                  and n_img == n_txt == 270, f"{label}: eval result {res}, {len(rows)} rows")
            check(counts == want, f"{label}: launch counts {counts} != expected {want}")
            runs[f"eval_{size}"] = counts
            # the first pair on the CPU's plain path, from the same directory
            model, cfg = registry.load_tower(kind, None, model_dir, device="cpu")
            pair = mmvp.load_pairs(bench)[0]
            px = torch.from_numpy(np.stack([mmvp.preprocess_image(p, kind, size)
                                            for p in (pair.img1, pair.img2)]))
            with torch.no_grad():
                want_i = mod.get_image_features(model, px, cfg)
                want_t = mod.get_text_features(
                    model, torch.from_numpy(tok([pair.text1, pair.text2])[0]), cfg)
            errs = [((calls[n][0][2] - w).abs().max() / w.abs().max()).item()
                    for n, w in (("get_image_features", want_i), ("get_text_features", want_t))]
            print(f"[eval] {label}: the first pair's embeddings card vs cpu: images "
                  f"{errs[0]:.3e}, texts {errs[1]:.3e} of the largest (bound 1e-4)",
                  flush=True)
            check(max(errs) <= 1e-4, f"{label}: the card's embeddings differ by {errs}")
            del model
            _free()
    finally:
        mmvp.default_tokenizer = default_tok
    return runs


# ------------------------------------------------------------- fast stage 2

FAST_CONFIGS = {"stage2_all": os.path.join(ROOT, "configs", "tpu_fast_stage2_all.yaml"),
                "stage2_only": os.path.join(ROOT, "configs", "tpu_fast_stage2_only.yaml"),
                "video": os.path.join(ROOT, "configs", "tpu_fast_video_stage2_all.yaml")}
# optimizer steps of the fast stage-2 Trainer runs (no accumulation: K2b
# launches 24 times per step on each)
FAST_STEPS = {"fast_stage2_all": 5, "fast_stage2_only": 4, "fast_video_stage2_all": 4}
# the widths the static DiT base and QLoRA hand K7: img_in's and
# final_layer's 64, time_in's and guidance_in's 256, vector_in's 768, the
# model's 3072; at T = 16 (the vec linears at B = 16) and T = 3136 (img_in,
# B = 16 x 196 tokens)
K7_STATIC_WIDTHS = (64, 256, 768, 3072)
K7_STATIC_ROWS = (16, 3136)
TEXT_SIDE = ("clip.model.text_model.", "clip.model.text_projection")


def phase_k7_static_widths():
    """K7 at the static DiT base's and QLoRA's widths and rows, bfloat16 and
    float32, with and without column scales: codes and scales bit for bit
    against the plain version; kernel, plain and bound ms of each bfloat16
    call."""
    import torch
    from genhancer_tpu_torch.core.kernels import rowquant as K7
    gen = torch.Generator(device="cuda").manual_seed(23)
    bad, n = [], 0
    for t in K7_STATIC_ROWS:
        for c in K7_STATIC_WIDTHS:
            for dtype in (torch.bfloat16, torch.float32):
                x = _rand(gen, (t, c), dtype)
                for col in (None, torch.rand(c, generator=gen, device="cuda") + 0.5):
                    q, sc = K7.rowquant(x, col)
                    torch.cuda.synchronize()
                    rq, rs = K7.rowquant_ref(x, col)
                    n_diff = int((q != rq).sum()) + int((sc != rs).sum())
                    n += 1
                    if n_diff:
                        bad.append((t, c, str(dtype)[6:], col is not None, n_diff))
            x = _rand(gen, (t, c), torch.bfloat16)
            ms, pms = kernel_vs_plain_ms(lambda: K7.rowquant(x), lambda: K7.rowquant_ref(x))
            bound = (_nbytes(x) + t * c + 4 * t) / HBM_PEAK * 1e3
            print(f"[kernels] rowquant [{t}, {c}] bf16 ({K7.rowquant_tiling(t, c, 2, True).body}"
                  f" body): kernel {ms:.4f} ms, plain {pms:.4f} ms, bound {bound:.5f} ms "
                  f"(bytes), {bound / ms:.1%} of the bound", flush=True)
    print(f"[kernels] rowquant at the static widths {K7_STATIC_WIDTHS} x rows "
          f"{K7_STATIC_ROWS}: {n} calls, {bad or 'every code and scale equal to the plain '
                                                'version'} (bound 0)", flush=True)
    check(not bad, f"K7 at the static widths differs from its plain version: {bad}")


def _tiny_qlora_spec(stage):
    """The tiny int8 spec with a QLoRA tower (width 64, text side too, so
    that every linear reaches QLoRA's 64) and the config's knobs:
    stage2_all int8_full with the cache, stage2_only the static DiT base."""
    from genhancer_tpu_torch.models.towers import clip as cm
    knobs = ({"dit_quant": "int8_full", "dit_quant_cache": True} if stage == "stage2_all"
             else {"dit_quant": "int8", "dit_quant_cache": False})
    base = _tiny_int8_spec("int8_full")
    return dataclasses.replace(
        base, stage=stage, vae_quant="none", lora_r=3, lora_alpha=16.0, lora_dropout=0.1,
        tower_cfg=cm.CLIPConfig(vision=base.tower_cfg.vision, text=cm.CLIPTextConfig(
            hidden_size=64, intermediate_size=128, num_layers=1, num_heads=2, vocab_size=50,
            max_position_embeddings=8), projection_dim=64), **knobs)


def _static_paths(modules):
    """Module paths of the int8 bases beside kept weights (QLoRA's and the
    static DiT's)."""
    return [p for p, m in modules.named_modules()
            if "weight_q" in m._buffers and "weight" in m._parameters]


def _int8_spy(names):
    """(calls, base spy, SwitchBack spy): each records its call's layer path
    (``names``: data pointer of the codes or weight -> path), inputs, codes
    and scales, output, and through identity taps the g, dx (and dW)."""
    import torch
    from genhancer_tpu_torch.core import quant

    class Tap(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, rec, key):
            ctx.rec, ctx.key = rec, key
            return a.clone()

        @staticmethod
        def backward(ctx, g):
            ctx.rec[ctx.key] = g.detach().clone()
            return g, None, None

    calls, base, sb = {"base": [], "sb": []}, quant.linear_int8_base, quant.switchback

    def spy_base(p, x):
        rec = dict(path=names.get(p.weight_q.data_ptr()), x=x.detach().clone(),
                   wq=p.weight_q.clone(), ws=p.w_scale.clone(), w=p.weight.detach().clone())
        y = base(p, Tap.apply(x, rec, "dx"))
        rec["y"] = y.detach().clone()
        calls["base"].append(rec)
        return Tap.apply(y, rec, "g")

    def spy_sb(x, w, wq=None, ws=None, dw="bf16"):
        rec = dict(path=names.get(w.data_ptr()), x=x.detach().clone(), w=w.detach().clone(),
                   dw_kind=dw, wq=None if wq is None else wq.clone(),
                   ws=None if ws is None else ws.clone())
        y = sb(Tap.apply(x, rec, "dx"), Tap.apply(w, rec, "dW"), wq, ws, dw)
        rec["y"] = y.detach().clone()
        calls["sb"].append(rec)
        return Tap.apply(y, rec, "g")

    return calls, spy_base, spy_sb


def _small_qlora_step(stage):
    """A tiny float32 QLoRA step of ``stage`` on the card: one accumulation-2
    step (the fused optimizer: K4 emits the cache in stage2_all), then a
    forward + backward on latent-cache batches whose every int8 call — each
    QLoRA / static base (``linear_int8_base``) and each SwitchBack layer —
    is held against the CPU's plain path on the same inputs and gradient:
    y, dx (and dW) within 1e-5 of max|CPU|, the codes and scales equal to
    ``quantize_weight`` of the layer's master (for the cache: K4's emission)
    bit for bit, the layer sets exactly the static and the cached ones;
    controls (a QLoRA node on its float weight, SwitchBack unquantized) must
    miss by 10x."""
    import types
    import numpy as np
    import torch
    from genhancer_tpu_torch.core import quant
    from genhancer_tpu_torch.tasks.image import (create_state, init_modules, make_loss_fn,
                                                 trainable_predicate)
    from genhancer_tpu_torch.train import optim
    from genhancer_tpu_torch.train.state import with_quant_cache
    from genhancer_tpu_torch.train.step_utils import make_accum_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    spec, bound, lr = _tiny_qlora_spec(stage), 1e-5, 1e-3
    rng = np.random.default_rng(17)
    v, lat = spec.tower_cfg.vision, spec.latent_hw
    n_img, n_tok, z = v.grid ** 2 + 1, (lat[0] // 2) * (lat[1] // 2), spec.vae_cfg.z_channels
    shapes = ([(2, n_img, v.hidden_size)] * 5 + [(2, n_img, v.intermediate_size)]) \
        * v.num_layers + [(2, v.hidden_size)]

    def batch():
        return {"image": rng.random((2, 32, 32, 3), dtype=np.float32),
                "moments": np.concatenate([rng.standard_normal((2, *lat, z)),
                                           -2 + 0.1 * rng.standard_normal((2, *lat, z))],
                                          -1).astype(np.float32)}

    def draw():
        return {"t": rng.random(2, dtype=np.float32),
                "x0": rng.standard_normal((2, n_tok, 4 * z), dtype=np.float32),
                "vae_noise": rng.standard_normal((2, *lat, z), dtype=np.float32),
                "lora_masks": [rng.random(sh) < 0.9 for sh in shapes]}

    def cuda(a):
        return {k: ([torch.from_numpy(x).cuda() for x in v] if isinstance(v, list)
                    else torch.from_numpy(v).cuda()) for k, v in a.items()}

    mods = init_modules(spec, torch.Generator().manual_seed(5))
    _plant_lora_b(mods["clip"]["model"], 6)
    mods = mods.cuda()
    opt = optim.FusedAdamW(optim.make_lr_schedule("constant", lr),
                           emit_quant=stage == "stage2_all")
    state = create_state(mods, trainable_predicate(spec, mods), opt)
    if stage == "stage2_all":
        state = with_quant_cache(state)
    loss_fn = make_loss_fn(spec)
    b0, b1 = batch(), batch()
    stacked = {k: np.stack([b0[k], b1[k]]) for k in b0}
    _zero_counts()
    make_accum_train_step(loss_fn, opt, 2)(state, cuda(stacked), None, [cuda(draw()), cuda(draw())])
    torch.cuda.synchronize()
    step_counts = _read_counts()

    static = _static_paths(mods)
    names = {mods.get_submodule(p).weight_q.data_ptr(): p for p in static}
    names.update({p.data_ptr(): k[: -len(".weight")] for k, p in state.trainable.items()})
    calls, spy_base, spy_sb = _int8_spy(names)
    orig = quant.linear_int8_base, quant.switchback
    quant.linear_int8_base, quant.switchback = spy_base, spy_sb
    try:
        loss_fn(state.modules, cuda(batch()), None, cuda(draw())).backward()
        torch.cuda.synchronize()
    finally:
        quant.linear_int8_base, quant.switchback = orig
    label = f"tiny f32 QLoRA {stage} step"
    want_base = sorted(p for p in static if not p.startswith(TEXT_SIDE))
    got_base = sorted(c["path"] for c in calls["base"])
    want_sb = sorted(k[: -len(".weight")] for k in (state.quant or {}))
    got_sb = sorted(c["path"] for c in calls["sb"])
    check(got_base == want_base and got_sb == want_sb,
          f"{label}: int8 bases ran on {got_base} (want {want_base}), SwitchBack on {got_sb} "
          f"(want {want_sb})")
    rel = lambda a, b: ((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()  # noqa: E731
    worst, gap, codes_ok = {"y": 0.0, "dx": 0.0, "dW": 0.0}, float("inf"), True
    for c in calls["base"] + calls["sb"]:
        w = c["w"].cpu()
        q, s = quant.quantize_weight(w, axis=0)
        is_sb = "dw_kind" in c
        codes_ok &= torch.equal(c["wq"].cpu(), q) and torch.equal(
            c["ws"].cpu().reshape(-1), s.reshape(-1))
        x = c["x"].cpu().requires_grad_("dx" in c)
        if is_sb:
            wr = w.clone().requires_grad_(True)
            y = quant.switchback(x, wr, c["wq"].cpu(), c["ws"].cpu(), c["dw_kind"])
        else:
            y = quant.linear_int8_base(types.SimpleNamespace(weight_q=c["wq"].cpu(),
                                                             w_scale=c["ws"].cpu()), x)
        errs = {"y": rel(c["y"], y.detach())}
        if "g" in c:
            y.backward(c["g"].cpu())
            if "dx" in c:
                errs["dx"] = rel(c["dx"], x.grad)
            if is_sb:
                errs["dW"] = rel(c["dW"], wr.grad)
        worst = {k: max(val, errs.get(k, 0.0)) for k, val in worst.items()}
        gap = min(gap, rel(c["x"].cpu() @ w.t(), y.detach()))
    print(f"[small] {label}: {len(calls['base'])} int8-base and {len(calls['sb'])} SwitchBack "
          f"calls card vs CPU on equal inputs, max|card-cpu|/max|cpu| y {worst['y']:.3e}, dx "
          f"{worst['dx']:.3e}, dW {worst['dW']:.3e} (bound {bound:g}); codes and scales "
          f"{'equal' if codes_ok else 'DIFFERENT FROM'} quantize_weight of the masters"
          f"{' (the cache K4 emitted)' if want_sb else ''}; closest control (the float "
          f"weight) {gap:.3e} (must exceed {10 * bound:g}); launches of the step "
          f"{ {k: step_counts[k] for k in ('rowquant', 'fused_adamw', 'fused_adamw_quant')} }",
          flush=True)
    check(max(worst.values()) <= bound and codes_ok and gap > 10 * bound,
          f"{label}: int8 layers disagree ({worst}, codes {codes_ok}, control {gap})")
    check(step_counts["rowquant"] > 0
          and (step_counts["fused_adamw_quant"] > 0) == (stage == "stage2_all"),
          f"{label}: launches {step_counts}")
    del state, mods
    _free()


def phase_small_qlora():
    """A tiny float32 QLoRA step of stage2_all (int8_full, K4's cache) and
    of stage2_only (the static DiT base), per int8 layer card against CPU
    (``_small_qlora_step``)."""
    for stage in ("stage2_all", "stage2_only"):
        attempt(_small_qlora_step, stage)


def _fast_want(trainer, steps):
    """Launch counts of ``steps`` steps (no accumulation) of a fast stage-2
    run, from the model.  Attention: image — the DiT's 6 blocks K1/K1b at
    the joint L = 197, the tower's 24 layers K2/K2b at 257; video middle@336
    — K5/K5b at L = 1593 (K5 twice with remat), K2/K2b at 577.  K7: each
    int8 base (QLoRA's vision side, in stage2_only the static DiT)
    quantizes its input once and its gradient once where its input carries
    one — all but the vision tower's first q/k/v (fed by the frozen
    embeddings) and, in stage2_only, the DiT's img_in, time_in and
    guidance_in (fed by the noised latent and the timestep and guidance
    embeddings); each cached SwitchBack linear its input and its gradient,
    and with remat a block's its input again in the recompute.  Per step K4
    takes the cached DiT leaves, K3 the rest."""
    spec, st = trainer.spec, trainer.state
    micro = steps * trainer.accum
    blocks = spec.dit_cfg.depth + spec.dit_cfg.depth_single_blocks
    layers = spec.tower_cfg.vision.num_layers
    cache = set(st.quant or {})
    static = [p for p in _static_paths(st.modules) if not p.startswith(TEXT_SIDE)]
    no_grad_in = [p for p in static if p.endswith(tuple(
        f"vision_model.encoder.layers.0.self_attn.{n}" for n in ("q_proj", "k_proj", "v_proj")))
        or p.startswith(("dit.img_in", "dit.time_in.", "dit.guidance_in."))]
    recomputed = (sum(k.startswith(("dit.double_blocks.", "dit.single_blocks.")) for k in cache)
                  if spec.remat else 0)
    long_ = getattr(spec, "n_cond", 0) and (spec.n_cond * spec.patch_grid ** 2
                                            + (spec.latent_hw[0] // 2) ** 2) >= 600
    short = 0 if long_ else micro * blocks
    flash = (micro * blocks * (2 if spec.remat else 1), micro * blocks) if long_ else (0, 0)
    return {**_no_launches(), "fused_rope_attention": short, "fused_rope_attention_bwd": short,
            "flash_attention": flash[0], "flash_attention_bwd": flash[1],
            "fused_attention": micro * layers, "fused_attention_bwd": micro * layers,
            "fused_adamw": steps * (len(st.trainable) - len(cache)),
            "fused_adamw_quant": steps * len(cache),
            "rowquant": micro * (2 * len(static) - len(no_grad_in) + 2 * len(cache)
                                 + recomputed)}


def _fast_report(name, trainer, counts, wall, peak, profile, steps, timed, batch):
    """Prints and checks one fast stage-2 run: synced steps, losses, the int8
    layers, step time of the ``timed`` steps (1-based, inclusive), images
    or rows per second, peak memory, the profiled last step, every save
    (the loop's stall, the writer's seconds) and the launch counts."""
    import numpy as np
    hist, st = trainer.history, trainer.state
    check([h["step"] for h in hist] == list(range(1, steps + 1)),
          f"{name}: synced steps {[h['step'] for h in hist]}")
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist),
          f"{name}: non-finite loss or grad norm: {hist}")
    static = _static_paths(st.modules)
    n_dit = sum(p.startswith("dit.") for p in static)
    step_s = statistics.median(h["step_time"] for h in hist[timed[0] - 1:timed[1]])
    print(f"[fast] {name}: {len(static) - n_dit} QLoRA tower bases (text side included), "
          f"{n_dit} static DiT bases, {len(st.quant or {})} SwitchBack weights cached, "
          f"{len(st.trainable)} trainable leaves; {steps} steps in {wall:.1f} s incl. the "
          f"saves; losses {[round(h['loss'], 4) for h in hist]}; step times "
          f"{[round(h['step_time'] * 1e3, 1) for h in hist]} ms", flush=True)
    print(f"[fast] {name}: median step time of steps {timed[0]}-{timed[1]} "
          f"{step_s * 1e3:.1f} ms = {batch / step_s:.2f} {'rows' if 'video' in name else 'img'}"
          f"/s (B={batch}); peak device memory {peak:.2f} GiB (steps alone "
          f"{profile.step_peak:.2f} GiB)", flush=True)
    _print_device_time(profile.prof, 1, profile.wall_s,
                       tag=f"[fast] {name} (step {steps}, profiled):")
    w = trainer.ckpt_writer
    print(f"[fast] {name}: asynchronous checkpoints at steps {trainer.saved_steps}: the step loop "
          f"stalled {[round(x, 3) for x in w.stalls]} s for the snapshot, the writer took "
          f"{[round(x, 2) for x in w.writes]} s", flush=True)
    want = _fast_want(trainer, steps)
    print(f"[fast] {name}: kernel launches {counts}, expected {want}", flush=True)
    check(counts == want, f"{name}: launch counts {counts} != expected {want}")
    check(w.enabled and len(w.writes) == len(w.stalls) == len(trainer.saved_steps),
          f"{name}: saves {trainer.saved_steps}, stalls {w.stalls}, writes {w.writes}")


def _write_yaml(cfg, path):
    import yaml
    with open(path, "w") as f:
        yaml.safe_dump(json.loads(json.dumps(cfg)), f)
    return path


def phase_fast_stage2(work, stage1):
    """The fast stage-2 path at full width: ``genhancer-precompute-torch
    --mode latents --augment train --variants 2`` over the int8 phase's
    synthetic 224-px shards (images/s, bytes, the first image's moments
    against the trainer's own inline encode of its crops), then
    configs/tpu_fast_stage2_all.yaml (QLoRA tower, int8_full DiT with the
    cache K4 emits, B=16) from the int8_full run's step-10 files on that
    cache, 5 steps with saves at 3 and 5: steps 3-4 timed (4 runs while the
    writer writes step 3's files), 5 profiled, the export read back bit for
    bit; then configs/tpu_fast_stage2_only.yaml (QLoRA tower, static DiT
    base) 4 steps and a resume whose re-derived static factors equal those
    derived at the load.  Returns {path: launch counts}."""
    import numpy as np
    import torch
    from genhancer_tpu_torch.cli import precompute as precompute_cli
    from genhancer_tpu_torch.data import precompute as pre
    from genhancer_tpu_torch.data.transforms import train_image_transform
    from genhancer_tpu_torch.data.wds import ShardStream
    from genhancer_tpu_torch.train.config import load_config
    from genhancer_tpu_torch.train.trainer import Trainer

    check(stage1 is not None and os.path.exists(os.path.join(stage1, "checkpoint-dit-10.bin")),
          f"no int8 stage-1 checkpoint to load from ({stage1})")
    shards, cache = os.path.join(work, "shards"), os.path.join(work, "latents")
    runs = {}
    pre_cfg = load_config(FAST_CONFIGS["stage2_all"])
    pre_cfg["data_config"]["img_dir"] = shards
    res = precompute_cli.main(["--config", _write_yaml(pre_cfg, os.path.join(work, "pre.yaml")),
                               "--output_dir", cache, "--mode", "latents", "--augment", "train",
                               "--variants", "2", "--batch", "32", "--device", "cuda"])
    _free()
    print(f"[fast] genhancer-precompute-torch --mode latents --augment train --variants 2: "
          f"{res['written']} images x 2 crops in {res['seconds']:.2f} s = "
          f"{res['written'] / res['seconds']:.1f} images/s, {res['bytes'] / 1e6:.1f} MB of "
          f"moments and float16 crops in {len(os.listdir(cache))} shards", flush=True)
    check(res["written"] == 384, f"precompute wrote {res['written']} images, not 384")

    base = load_config(FAST_CONFIGS["stage2_all"])
    base["data_config"]["img_dir"] = cache
    base.update(load_dir=stage1, load_step=10, log_interval=1, report_to="none")
    cfg = copy.deepcopy(base)
    steps = FAST_STEPS["fast_stage2_all"]
    cfg.update(output_dir=os.path.join(work, "out-fast-all"), max_train_steps=steps,
               checkpointing_steps=3)
    exports, restore = _export_timer()
    profile = _LastStepProfile()
    try:
        trainer, counts, wall, peak = _trainer_run(cfg, profile=profile)
    finally:
        restore()
    _fast_report("tpu_fast_stage2_all", trainer, counts, wall, peak, profile, steps, (3, 4), 16)
    runs["fast_stage2_all"] = counts
    # the cache's first image against the trainer's own VAE on the CLI's
    # first batch (images 0-15, two crops each, from the per-image generator)
    samples = [s for s, _ in zip(ShardStream(shards, shuffle_buffer=0, repeat=False), range(16))]
    crops = np.stack([train_image_transform(s["jpg"], 224, rng) for s in samples
                      for rng in [np.random.default_rng((0, zlib.crc32(s["__key__"].encode())))]
                      for _ in range(2)])
    spec = trainer.spec
    inline = pre.make_frozen_latent_fn(trainer.state.modules["vae"], spec.vae_cfg,
                                       vae_dtype=spec.vae_dtype)(crops)["moments"][:2]
    import tarfile
    with tarfile.open(os.path.join(cache, "pre-000000.tar")) as tf:
        member = next(m for m in tf.getmembers() if m.name.endswith(".feat.npz"))
        cached = pre.load_feat(tf.extractfile(member).read())
    err = float(np.abs(cached["moments"] - inline).max() / np.abs(inline).max())
    same_px = np.array_equal(cached["pixels"], crops[:2].astype(np.float16))
    print(f"[fast] {member.name}: cached moments {cached['moments'].shape} against the "
          f"trainer's VAE on the same crops, max|diff|/max {err:.3e} "
          f"({'bit for bit' if err == 0 else 'not bit for bit'}; bound "
          f"{BOUND['bfloat16']}); its float16 crops {'equal' if same_px else 'DIFFER FROM'} "
          f"the per-image generator's", flush=True)
    check(err <= BOUND["bfloat16"] and same_px, "the latent cache disagrees with the trainer")
    check(len(exports) == 2, f"{len(exports)} exports, expected 2 (steps 3 and 5)")
    print(f"[fast] the step-3 export took {exports[0][0]:.2f} s in the writer", flush=True)
    _check_export(trainer, exports[1:], "[fast] tpu_fast_stage2_all:")
    del trainer
    _free()
    shutil.rmtree(cfg["output_dir"], ignore_errors=True)

    cfg = copy.deepcopy(base)
    steps = FAST_STEPS["fast_stage2_only"]
    cfg.update(load_config(FAST_CONFIGS["stage2_only"]))
    cfg["data_config"]["img_dir"] = cache
    cfg.update(load_dir=stage1, load_step=10, log_interval=1, report_to="none",
               output_dir=os.path.join(work, "out-fast-only"), max_train_steps=steps,
               checkpointing_steps=0)
    profile = _LastStepProfile()
    trainer, counts, wall, peak = _trainer_run(cfg, profile=profile)
    _fast_report("tpu_fast_stage2_only", trainer, counts, wall, peak, profile, steps, (2, 3), 16)
    runs["fast_stage2_only"] = counts
    at_load = {p: (trainer.state.modules.get_submodule(p).weight_q.clone(),
                   trainer.state.modules.get_submodule(p).w_scale.clone())
               for p in _static_paths(trainer.state.modules)}
    del trainer
    _free()
    cfg2 = copy.deepcopy(cfg)
    cfg2.update(max_train_steps=steps + 1, resume_from_checkpoint="latest")
    resumed = Trainer(cfg2, device="cuda")
    mods = resumed.state.modules
    same = (resumed.state.step == steps and sorted(_static_paths(mods)) == sorted(at_load)
            and all(torch.equal(mods.get_submodule(p).weight_q, q)
                    and torch.equal(mods.get_submodule(p).w_scale, s)
                    for p, (q, s) in at_load.items()))
    print(f"[fast] tpu_fast_stage2_only resume at step {resumed.state.step}: the "
          f"{len(at_load)} static int8 bases re-derived from the loaded masters "
          f"{'equal' if same else 'DIFFER FROM'} those derived at the stage-1 load", flush=True)
    check(same, "the resumed static int8 factors differ from those derived at load")
    del resumed, mods
    _free()
    shutil.rmtree(cfg["output_dir"], ignore_errors=True)
    shutil.rmtree(cache, ignore_errors=True)
    return runs


def phase_fast_video(work, stage1):
    """configs/tpu_fast_video_stage2_all.yaml at full width and its batch of
    4 (middle@336: QLoRA tower at L=577 without tower_remat, the int8_full
    DiT with the cache, remat at the joint L=1593) from middle@336's
    stage-1 files: 4 steps, 2-3 timed, 4 profiled, the export read back.
    Returns {path: launch counts}."""
    from genhancer_tpu_torch.train.config import load_config

    check("middle" in stage1, "no middle@336 stage-1 files to load")
    load_dir, load_step = stage1["middle"]
    steps = FAST_STEPS["fast_video_stage2_all"]
    cfg = load_config(FAST_CONFIGS["video"])
    cfg["data_config"]["video_dir"] = os.path.join(work, "clips")
    cfg.update(output_dir=os.path.join(work, "out-fast-video"), max_train_steps=steps,
               checkpointing_steps=0, log_interval=1, report_to="none", load_dir=load_dir,
               load_step=load_step)
    exports, restore = _export_timer()
    profile = _LastStepProfile()
    try:
        trainer, counts, wall, peak = _trainer_run(cfg, profile=profile)
    finally:
        restore()
    spec = trainer.spec
    print(f"[fast] tpu_fast_video_stage2_all: remat {spec.remat}, tower_remat "
          f"{spec.tower_remat}, joint L="
          f"{spec.n_cond * spec.patch_grid ** 2 + (spec.latent_hw[0] // 2) ** 2}", flush=True)
    check(spec.remat and not spec.tower_remat, "the video config's gates")
    _fast_report("tpu_fast_video_stage2_all", trainer, counts, wall, peak, profile, steps,
                 (2, 3), 4)
    _check_export(trainer, exports, "[fast] tpu_fast_video_stage2_all:")
    del trainer
    _free()
    shutil.rmtree(cfg["output_dir"], ignore_errors=True)
    shutil.rmtree(load_dir, ignore_errors=True)
    return {"fast_video_stage2_all": counts}


# ------------------------------------------------- int8 serving, the extra models

# the bf16 engine's numbers of phase_server, printed beside the int8 engine's
SERVE_BF16 = {}
K7_NAMES = ("rowquant_warp_kernel", "rowquant_block_kernel", "rowquant_scalar_kernel")


# the forward kernels at the shapes the slice's paths give them: K1 at the
# int8 engine's B=1 and the ControlNet / IP-Adapter paths' B=4 (joint L=197),
# K5 at the text-conditioned sample's joint L = 512 + 196 = 708 (one branch
# per call, B=1)
EXTRAS_SHAPES = {"K1 (int8 engine, B=1)": (1, 197, 24, 128),
                 "K1 (ControlNet, IP-Adapter, B=4)": (4, 197, 24, 128),
                 "K5 (T5-conditioned CFG sample)": (1, 708, 24, 128)}
# (rows per image, width) of every int8 linear input of the served DiT and
# tower: img stream 196, single blocks 197, tower 257 tokens, the txt
# stream and the vec/time/guidance/pooled rows one
K7_SERVE = ((196, 64), (1, 256), (1, 768), (257, 1024), (1, 1024), (196, 3072), (197, 3072),
            (1, 3072), (257, 4096), (1, 4096), (196, 12288), (1, 12288), (197, 15360))


def phase_kernels_extras(records):
    """The forward kernels at this slice's shapes, bf16: K1 and K5
    (EXTRAS_SHAPES) against their plain versions (2e-2; o's rounding point
    at ROUNDING_BOUND with its control), timed with the plain version in
    turns, the device time from CUDA graphs, SDPA's call and device time and
    the bound; K7 at every (rows, width) of the int8 engine's linears
    (K7_SERVE) at B = 1 and 8, codes and scales bit for bit against the plain
    version, kernel, plain and bound ms.  The rows go into the records under
    ``extras_shapes`` and ``serve_widths``."""
    import torch
    from genhancer_tpu_torch.core.kernels import flash_attention as F
    from genhancer_tpu_torch.core.kernels import rowquant as K7
    from genhancer_tpu_torch.core.kernels import short_attention as K

    gen = torch.Generator(device="cuda").manual_seed(708)
    for what, (b, l, h, d) in EXTRAS_SHAPES.items():
        q, k, v, do = (_rand(gen, (b, l, h, d), torch.bfloat16) for _ in range(4))
        if what.startswith("K1"):
            name, tables = "fused_rope_attention", _tables(gen, b, l, d)
            o = K._fwd_kernel(q, k, v, tables, False)[0]
            kfn = lambda: K._fwd_kernel(q, k, v, tables, False)  # noqa: E731
            pfn = lambda: K.fused_rope_attention_ref(q, k, v, *tables)  # noqa: E731
            rq, rk = K._fwd_kernel(q, k, v, tables, want_lse=True)[2:]
        else:
            name, tables, rq, rk = "flash_attention", (), q, k
            o = F._fwd_kernel(q, k, v, False)[0]
            kfn = lambda: F._fwd_kernel(q, k, v, False)  # noqa: E731
            pfn = lambda: F.flash_attention_fwd_ref(q, k, v)[0]  # noqa: E731
        torch.cuda.synchronize()
        ro = pfn()
        o_abs, o_rel = _grad_errors((o,), (ro,))
        o_mean, o_ctl = _mean_rel(o, ro), _mean_rel(_round_before_normalise(rq, rk, v), ro)
        check(o_rel <= BOUND["bfloat16"] and o_mean <= ROUNDING_BOUND < o_ctl,
              f"{what}: o max rel {o_rel}, mean {o_mean}, control {o_ctl}")
        lib_f = _sdpa_fwd_bwd(q, k, v, do)[0]
        ms, pms = kernel_vs_plain_ms(kfn, pfn, n=20, rounds=4)
        row = {"shape": [b, l, h, d], "ms": ms, "plain_ms": pms, "device_ms": graph_ms(kfn),
               "library_ms": _library_ms(lib_f), "library_device_ms": graph_ms(lib_f)}
        _set_bound(row, _nbytes(q, k, v, o, *tables), 2.0 * 2 * b * h * l * l * d)
        if records.get(name) is not None:
            records[name].setdefault("extras_shapes", []).append(row)
        share = (f", {100 * row['bound_ms'] / row['device_ms']:.1f}% of the bound"
                 if row["device_ms"] else "")
        print(f"[kernels] {what} [{b}, {l}, {h}, {d}] bf16 forward: o max {o_abs:.3e} (rel "
              f"{o_rel:.3e}, bound 2e-02), mean|kernel-plain|/mean|plain| {o_mean:.3e} (p "
              f"rounded before normalising {o_ctl:.3e}, bound {ROUNDING_BOUND:.0e}); call "
              f"{ms:.4f} ms, plain {pms:.4f} ms; device {_fmt(row['device_ms'])} ms{share}; bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']}); SDPA call {row['library_ms']:.4f} "
              f"ms, device {_fmt(row['library_device_ms'])} ms", flush=True)
        del q, k, v, do, o, ro
    bad, rows = [], []
    for b in (1, 8):
        for t1, c in K7_SERVE:
            t = b * t1
            x = _rand(gen, (t, c), torch.bfloat16)
            q, sc = K7.rowquant(x)
            torch.cuda.synchronize()
            rq, rs = K7.rowquant_ref(x)
            n_diff = int((q != rq).sum()) + int((sc != rs).sum())
            if n_diff:
                bad.append((t, c, n_diff))
            ms, pms = kernel_vs_plain_ms(lambda: K7.rowquant(x), lambda: K7.rowquant_ref(x),
                                         n=20, rounds=4)
            bound = (_nbytes(x) + t * c + 4 * t) / HBM_PEAK * 1e3
            rows.append({"shape": [t, c], "ms": ms, "plain_ms": pms, "bound_ms": bound,
                         "bound_by": "bytes", "body": K7.rowquant_tiling(t, c, 2, True).body})
    if records.get("rowquant") is not None:
        records["rowquant"]["serve_widths"] = rows
    print("[kernels] K7 at the int8 engine's linears (bf16 [T, C]: kernel / plain / bound ms, "
          "body): " + "; ".join(f"[{r['shape'][0]}, {r['shape'][1]}] {r['ms']:.4f} / "
                                f"{r['plain_ms']:.4f} / {r['bound_ms']:.5f} {r['body']}"
                                for r in rows)
          + f"; {bad or 'every code and scale equal to the plain version'} (bound 0)",
          flush=True)
    check(not bad, f"K7 at the serving widths differs from its plain version: {bad}")
    _free()


def _tiny_serve_int8_spec():
    """The tiny serving spec with every int8 kind of the int8 engine: a
    tower of width 64 (its linears reach the engine's 64) and a VAE with a
    256-channel level (its convs reach 256, the mid-block attention's 1x1
    convs too); float32 compute."""
    from genhancer_tpu_torch.models import vae as vm
    from genhancer_tpu_torch.models.towers import clip as cm
    return dataclasses.replace(
        _tiny_spec(),
        vae_cfg=vm.VAEConfig(resolution=32, ch=128, ch_mult=(1, 2), num_res_blocks=1,
                             z_channels=4),
        tower_cfg=cm.CLIPConfig(vision=cm.CLIPVisionConfig(
            hidden_size=64, intermediate_size=128, num_layers=1, num_heads=2, image_size=32,
            patch_size=16), projection_dim=24))


def _int8_call_spy(modules):
    """(calls, spy_base, spy_conv): stand-ins for ``core.quant``'s int8 base
    product and int8 conv that record each call's module path, input,
    stride/padding and output."""
    from genhancer_tpu_torch.core import quant
    names = {id(m): p for p, m in modules.named_modules()}
    calls, base, conv = [], quant.linear_int8_base, quant.conv2d_int8

    def spy_base(p, x):
        y = base(p, x)
        calls.append(dict(kind="linear", path=names[id(p)], x=x.clone(), y=y.clone()))
        return y

    def spy_conv(p, x, stride=1, padding=None):
        y = conv(p, x, stride=stride, padding=padding)
        calls.append(dict(kind="conv", path=names[id(p)], x=x.clone(), y=y.clone(),
                          stride=stride, padding=padding))
        return y

    return calls, spy_base, spy_conv


def phase_small_serve_int8():
    """A tiny int8 engine (``quant="int8"``) on the card against the same
    weights on the CPU.  Every int8 layer call of one reconstruct (B=2, 2
    Euler steps, injected noise) and one embed is recorded on the card with
    its input and held against the CPU's plain path on that input: output
    within 1e-5 of max|CPU|, the activation codes (K7 per row for a linear,
    per tensor for a conv) equal or +-1 at a rate below 5e-3; the layers
    called are exactly the DiT's and the tower's int8 linears and the VAE
    decoder's int8 convs, and K7 launches once per linear call.  Controls on
    the same inputs must miss the bound by 10x: the layer's product in float
    (an int8 conv or linear left unquantized)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from genhancer_tpu_torch.core import quant
    from genhancer_tpu_torch.serve.engine import InferenceEngine
    from genhancer_tpu_torch.tasks.image import init_modules

    bound = 1e-5
    spec = _tiny_serve_int8_spec()
    mods = init_modules(spec, torch.Generator().manual_seed(5))
    sd = {k: v.clone() for k, v in mods.state_dict().items()}
    cpu = InferenceEngine(spec, mods, device="cpu", buckets=(2,), num_steps=2, quant="int8")
    mods_gpu = init_modules(spec, torch.Generator().manual_seed(6))
    mods_gpu.load_state_dict(sd, strict=True)
    gpu = InferenceEngine(spec, mods_gpu, device="cuda", buckets=(2,), num_steps=2,
                          quant="int8")
    check(gpu.int8_layers == cpu.int8_layers and all(gpu.int8_layers.values()),
          f"int8 layer sets: card {gpu.int8_layers}, CPU {cpu.int8_layers}")
    cpu_sd = cpu.modules.state_dict()
    check(all(torch.equal(v.cpu(), cpu_sd[k]) for k, v in gpu.modules.state_dict().items()),
          "the card's int8 factors differ from the CPU's")
    rng = np.random.default_rng(7)
    img = rng.random((2, 32, 32, 3), dtype=np.float32)
    noise = torch.randn((2, *spec.latent_hw, spec.vae_cfg.z_channels),
                        generator=torch.Generator().manual_seed(8))
    calls, spy_base, spy_conv = _int8_call_spy(gpu.modules)
    orig = quant.linear_int8_base, quant.conv2d_int8
    quant.linear_int8_base, quant.conv2d_int8 = spy_base, spy_conv
    try:
        _zero_counts()
        r_gpu = gpu._recon(gpu._place(img), noise.cuda())
        e_gpu = gpu._embed(gpu._place(img))
        torch.cuda.synchronize()
        counts = _read_counts()
    finally:
        quant.linear_int8_base, quant.conv2d_int8 = orig
    want_paths = ({f"dit.{p}" for p in gpu.int8_layers["dit"]}
                  | {f"clip.model.{p}" for p in gpu.int8_layers["tower"]}
                  | {f"vae.{p}" for p in gpu.int8_layers["vae"] if p.startswith("decoder.")})
    called = {c["path"] for c in calls}
    check(called == want_paths, f"int8 calls on {sorted(called ^ want_paths)} "
                                "outside / missing from the layer set")
    n_lin = sum(c["kind"] == "linear" for c in calls)
    check(counts["rowquant"] == n_lin, f"K7 launches {counts['rowquant']} != {n_lin} int8 "
                                       "linear calls")
    worst, gap, flips, n_codes = 0.0, float("inf"), 0, 0
    cmods = cpu.modules
    for c in calls:
        mod, x = cmods.get_submodule(c["path"]), c["x"].cpu()
        if c["kind"] == "linear":
            y = quant.linear_int8_base(mod, x)
            qg, _ = quant.quantize_activation_rows(c["x"])
            qc, _ = quant.quantize_activation_rows(x)
            ctl = torch.matmul(x, (mod.weight_q.to(torch.float32) * mod.w_scale).t())
        else:
            y = quant.conv2d_int8(mod, x, stride=c["stride"], padding=c["padding"])
            qg, _ = quant.quantize_activation_tensor(c["x"])
            qc, _ = quant.quantize_activation_tensor(x)
            k = mod.weight_q.shape[-1]
            w = mod.weight_q.to(torch.float32) * mod.w_scale.reshape(-1, 1, 1, 1)
            ctl = F.conv2d(x, w, mod.bias, stride=c["stride"],
                           padding=k // 2 if c["padding"] is None else c["padding"])
        d = (qg.cpu().to(torch.int32) - qc.to(torch.int32)).abs()
        check(int(d.max()) <= 1, f"{c['path']}: codes differ by {int(d.max())}")
        flips, n_codes = flips + int((d > 0).sum()), n_codes + d.numel()
        scale = y.abs().max().clamp_min(1e-30)
        worst = max(worst, float((c["y"].cpu() - y).abs().max() / scale))
        gap = min(gap, float((ctl - y).abs().max() / scale))
    r_cpu = cpu._recon(cpu._place(img), noise)
    print(f"[small] tiny int8 engine: {len(calls)} int8 calls card vs CPU on equal inputs "
          f"({n_lin} linears, {len(calls) - n_lin} VAE decoder convs; {len(called)} layers: "
          f"{ {k: len(v) for k, v in gpu.int8_layers.items()} } swapped), max|card-cpu|/max|cpu|"
          f" {worst:.3e} (bound {bound:g}); activation codes differing {flips} of {n_codes} "
          f"(rate bound 5e-3, each +-1); closest control (the product in float) {gap:.3e} "
          f"(must exceed {10 * bound:g}); K7 launches {counts['rowquant']}; whole reconstruct "
          f"max|card-cpu| {float((r_gpu.cpu() - r_cpu).abs().max()):.3e}, embed "
          f"{float((e_gpu.cpu() - cpu._embed(cpu._place(img))).abs().max()):.3e} "
          "(the int8 noise, not checked)", flush=True)
    check(worst <= bound, f"tiny int8 engine: int8 layers disagree: {worst}")
    check(flips <= 5e-3 * n_codes, f"tiny int8 engine: {flips} of {n_codes} codes flipped")
    check(gap > 10 * bound, f"tiny int8 engine: a control came within {gap} of the check")
    check(bool(torch.isfinite(r_gpu).all()) and tuple(r_gpu.shape) == (2, 32, 32, 3),
          "tiny int8 engine: reconstruct not finite or misshapen")
    del gpu, cpu, mods, mods_gpu
    _free()


def phase_serve_int8():
    """``InferenceEngine.from_config(MetaCLIP_large_stage1, quant="int8")``
    at full width (flux-dev DiT, MetaCLIP-L/14 at 224 px, FLUX VAE; random
    weights from the config's seed): the int8 layer set, K7/K1/K2 launches of
    one reconstruct and one embed against the set, the K7 kernels of one
    reconstruct counted by torch.profiler, reconstruct at B = 1, 4, 8 (20
    Euler steps, uint8 wire, median of 3) and embed (median of 10) beside
    phase_server's bf16 engine, and the peak device memory.  Returns the
    launch counts of the reconstruct and embed."""
    import numpy as np
    import torch
    from genhancer_tpu_torch.serve.engine import InferenceEngine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = InferenceEngine.from_config(CONFIG, device="cuda", buckets=BUCKETS,
                                         num_steps=NUM_STEPS, wire_dtype="uint8",
                                         quant="int8")
    torch.cuda.synchronize()
    n8 = {k: len(v) for k, v in engine.int8_layers.items()}
    cfg, tower = engine.spec.dit_cfg, engine.spec.tower_cfg.vision
    # the DiT: 10 linears per double block, 3 per single block and 10 more
    # (img_in, txt_in, time_in x 2, vector_in x 2, guidance_in x 2, the final
    # layer's adaLN and linear); the tower: 6 per layer and visual_projection
    want_n = {"dit": 10 * cfg.depth + 3 * cfg.depth_single_blocks + 10,
              "tower": 6 * tower.num_layers + 1}
    print(f"[serve_int8] engine built and quantized in {time.perf_counter() - t0:.1f} s: "
          f"int8 layers {n8} (DiT and tower linears with min(out, in) >= 64, VAE convs with "
          f"in and out >= 256)", flush=True)
    check({k: n8[k] for k in want_n} == want_n and n8["vae"] > 0,
          f"int8 layer counts {n8}, expected {want_n} and VAE convs")
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    print(f"[serve_int8] warmup of buckets {BUCKETS} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    rng = np.random.default_rng(3)
    one = (rng.random((1, 224, 224, 3)) * 255).astype(np.uint8)
    _zero_counts()
    out = engine.reconstruct(one, seed=0)
    emb = engine.embed(one)
    torch.cuda.synchronize()
    counts = _read_counts()
    k7_recon = n8["tower"] + NUM_STEPS * n8["dit"]
    want = {**_no_launches(), "rowquant": k7_recon + n8["tower"],
            "fused_rope_attention": NUM_STEPS * (cfg.depth + cfg.depth_single_blocks),
            "fused_attention": 2 * tower.num_layers}
    print(f"[serve_int8] launches of one reconstruct (B=1) and one embed {counts}, expected "
          f"{want}", flush=True)
    check(counts == want, f"int8 engine launches {counts} != {want}")
    check(out.dtype == np.uint8 and out.shape == (1, 224, 224, 3) and emb.shape == (1, 768)
          and np.isfinite(emb).all(), "int8 engine: output dtype, shape or finiteness")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.reconstruct(one, seed=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    k7_prof = sum(e.count for e in prof.key_averages() if any(n in e.key for n in K7_NAMES))
    print(f"[serve_int8] torch.profiler over one reconstruct (B=1, {NUM_STEPS} steps): K7 "
          f"kernels {k7_prof} (expected {k7_recon} = {n8['tower']} tower + {NUM_STEPS} x "
          f"{n8['dit']} DiT)", flush=True)
    _print_device_time(prof, 1, wall, tag="[serve_int8] reconstruct B=1:")
    check(k7_prof == k7_recon, f"profiled K7 kernels {k7_prof} != {k7_recon}")
    res = {}
    for b in BUCKETS:
        imgs = (rng.random((b, 224, 224, 3)) * 255).astype(np.uint8)
        rec_s, emb_s = [], []
        for r in range(3):
            t0 = time.perf_counter()
            engine.reconstruct(imgs, seed=r)
            rec_s.append(time.perf_counter() - t0)
        for _ in range(10):
            t0 = time.perf_counter()
            engine.embed(imgs)
            emb_s.append(time.perf_counter() - t0)
        res[b] = (statistics.median(rec_s), statistics.median(emb_s))
    peak = torch.cuda.max_memory_allocated() / 2**30
    for b, (rs, es) in res.items():
        bf = SERVE_BF16.get(b)
        beside = (f"; bf16 engine (phase_server) {bf[0] * 1e3:.1f} ms, embed {bf[1] * 1e3:.2f} ms"
                  if bf else "")
        print(f"[serve_int8] bucket {b}: reconstruct {rs * 1e3:.1f} ms/batch = {b / rs:.2f} "
              f"img/s ({NUM_STEPS} steps, uint8 wire, median of 3); embed {es * 1e3:.2f} "
              f"ms/batch = {b / es:.1f} img/s (median of 10){beside}", flush=True)
    print(f"[serve_int8] peak device memory {peak:.2f} GiB (bf16 engine "
          f"{SERVE_BF16.get('peak', float('nan')):.2f} GiB after its warmup)", flush=True)
    del engine
    _free()
    return counts


def _plant(linear, gen, std):
    """Seeded nonzero values in a zero-initialised projection."""
    import torch
    with torch.no_grad():
        linear.weight.copy_(torch.randn(linear.weight.shape, generator=gen,
                                        device=linear.weight.device) * std)
        if linear.bias is not None:
            linear.bias.copy_(torch.randn(linear.bias.shape, generator=gen,
                                          device=linear.bias.device) * std)


def _tiny_text_clip():
    from genhancer_tpu_torch.models.towers import clip as cm
    return cm.CLIPConfig(
        vision=cm.CLIPVisionConfig(hidden_size=16, intermediate_size=32, num_layers=1,
                                   num_heads=2, image_size=32, patch_size=16),
        text=cm.CLIPTextConfig(hidden_size=16, intermediate_size=32, num_layers=1, num_heads=2,
                               vocab_size=50, max_position_embeddings=8),
        projection_dim=24)


def _rel(a, b) -> float:
    return float((a.detach().cpu().float() - b.detach().cpu().float()).abs().max()
                 / b.detach().cpu().float().abs().max().clamp_min(1e-30))


def phase_small_extras():
    """The extra models at tiny sizes, card against CPU on the same weights
    and inputs, float32 at 1e-5 of the largest magnitude: a ControlNet
    reconstruct (depth 3 beside the DiT's double block, planted nonzero
    ``cond_in`` and ``controlnet_blocks``) and its CFG sampler with
    ``neg_controlnet_fn``; a DiT forward with nonzero IP k/v in both block
    kinds, also in bf16 at 1e-4; T5
    ``encoder_forward`` with and without a padding mask, then ``prepare`` and
    ``denoise_euler_cfg`` with ``true_gs`` 3.5."""
    import numpy as np
    import torch
    from genhancer_tpu_torch.eval import reconstruct as recon
    from genhancer_tpu_torch.models import controlnet as cnm
    from genhancer_tpu_torch.models import dit as dm
    from genhancer_tpu_torch.models import ip_adapter as ipm
    from genhancer_tpu_torch.models.towers import clip as cm
    from genhancer_tpu_torch.models.towers import t5 as t5m
    from genhancer_tpu_torch.tasks import text_conditioning as tc
    from genhancer_tpu_torch.tasks.image import init_modules
    from genhancer_tpu_torch.train import flow

    bound = 1e-5
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = _tiny_spec()
    cfg = spec.dit_cfg
    errs, launches = {}, {}
    mods = init_modules(spec, torch.Generator().manual_seed(11))
    gen = torch.Generator().manual_seed(12)
    cn = cnm.init_controlnet(gen, cfg, depth=3)
    for lin in [cn.cond_in, *cn.controlnet_blocks]:
        _plant(lin, gen, 0.05)
    mods_gpu, cn_gpu = copy.deepcopy(mods).cuda(), copy.deepcopy(cn).cuda()
    rng = np.random.default_rng(13)
    image = rng.random((2, 32, 32, 3), dtype=np.float32)
    noise = rng.standard_normal((2, *spec.latent_hw, spec.vae_cfg.z_channels), dtype=np.float32)
    out = {}
    for dev, m, c in (("cpu", mods, cn), ("cuda", mods_gpu, cn_gpu)):
        _zero_counts()
        out[dev] = recon.reconstruct(m, spec, image, num_steps=2, noise=noise,
                                     controlnet_params=c, controlnet_gs=0.8)
        launches[f"controlnet reconstruct {dev}"] = _read_counts()["fused_rope_attention"]
    plain = recon.reconstruct(mods, spec, image, num_steps=2, noise=noise)
    errs["ControlNet reconstruct"] = _rel(torch.from_numpy(out["cuda"]),
                                          torch.from_numpy(out["cpu"]))
    check(np.abs(out["cpu"] - plain).max() > 1e-4, "the planted ControlNet moved nothing")
    check(launches["controlnet reconstruct cuda"] == 2 * (3 + cfg.depth + cfg.depth_single_blocks),
          f"tiny ControlNet reconstruct: K1 launches {launches}")

    # the CFG branch: the negative conditioning runs its own ControlNet pass
    lat = spec.latent_hw
    ids = torch.zeros((2, (lat[0] // 2) * (lat[1] // 2), 3))
    ids[..., 1] = torch.arange(ids.shape[1]) // (lat[1] // 2)
    ids[..., 2] = torch.arange(ids.shape[1]) % (lat[1] // 2)
    x0 = torch.from_numpy(rng.standard_normal((2, ids.shape[1], cfg.in_channels),
                                              dtype=np.float32))
    ctl = torch.from_numpy(rng.standard_normal(x0.shape, dtype=np.float32))
    txt = {s: torch.from_numpy(rng.standard_normal((2, 3, cfg.context_in_dim), dtype=np.float32))
           for s in ("pos", "neg")}
    y = torch.from_numpy(rng.standard_normal((2, cfg.vec_in_dim), dtype=np.float32))
    ts = flow.get_schedule(3, ids.shape[1])

    def cfg_sample(dev, dit, c):
        kw = dict(img_ids=ids.to(dev), txt_ids=torch.zeros((2, 3, 3), device=dev), y=y.to(dev))

        def model(side):
            return lambda x, tv, g, res: dm.dit_forward(
                dit, cfg, img=x, txt=txt[side].to(dev), timesteps=tv, guidance=g,
                controlnet_residuals=res, **kw)

        def control(side):
            return lambda x, tv, g: cnm.controlnet_forward(
                c, cfg, img=x, txt=txt[side].to(dev), timesteps=tv, guidance=g,
                controlnet_cond=ctl.to(dev), **kw)

        with torch.no_grad():
            return flow.denoise_controlnet(model("pos"), control("pos"), x0.to(dev), ts,
                                           guidance=4.0, true_gs=2.5, controlnet_gs=0.7,
                                           neg_model_fn=model("neg"),
                                           neg_controlnet_fn=control("neg"))

    errs["ControlNet CFG sampler"] = _rel(cfg_sample("cuda", mods_gpu["dit"], cn_gpu),
                                          cfg_sample("cpu", mods["dit"], cn))

    # IP-Adapter in both block kinds, float32 and bf16
    ip = ipm.init_ip_params(gen, cfg, context_dim=32, clip_embeddings_dim=24)
    for blk in [*ip.ip_double, *ip.ip_single]:
        _plant(blk.k_proj, gen, 0.1)
        _plant(blk.v_proj, gen, 0.1)
    ip_gpu = copy.deepcopy(ip).cuda()
    embed = torch.from_numpy(rng.standard_normal((2, 24), dtype=np.float32))
    tt = torch.from_numpy(rng.random(2, dtype=np.float32))
    for dtype, name, bnd in ((torch.float32, "IP DiT forward float32", bound),
                             (torch.bfloat16, "IP DiT forward bf16", 1e-4)):
        res = {}
        for dev, dit, ipp in (("cpu", mods["dit"], ip), ("cuda", mods_gpu["dit"], ip_gpu)):
            with torch.no_grad():
                res[dev] = dm.dit_forward(
                    dit, cfg, img=x0.to(dev, dtype), img_ids=ids.to(dev),
                    txt=txt["pos"].to(dev, dtype), txt_ids=torch.zeros((2, 3, 3), device=dev),
                    timesteps=tt.to(dev, dtype), y=y.to(dev, dtype),
                    guidance=torch.full((2,), 4.0, dtype=dtype, device=dev),
                    image_proj=embed.to(dev), ip_params=ipp, ip_scale=0.6)
        errs[name] = _rel(res["cuda"], res["cpu"])
        check(errs[name] <= bnd, f"{name}: card vs CPU {errs[name]} (bound {bnd})")
        if dtype == torch.float32:
            with torch.no_grad():
                off = dm.dit_forward(mods["dit"], cfg, img=x0, img_ids=ids, txt=txt["pos"],
                                     txt_ids=torch.zeros((2, 3, 3)), timesteps=tt, y=y,
                                     guidance=torch.full((2,), 4.0))
            check(_rel(off, res["cpu"]) > 1e-3, "the planted IP k/v moved nothing")

    # T5, prepare and the CFG sampler on a text-conditioned DiT
    t5_cfg = t5m.T5Config(d_model=cfg.context_in_dim, d_kv=8, d_ff=64, num_layers=2,
                          num_heads=4, vocab_size=120, relative_attention_num_buckets=8,
                          relative_attention_max_distance=16)
    t5 = t5m.init_t5(gen, t5_cfg)
    t5_gpu = copy.deepcopy(t5).cuda()
    clip_cfg = _tiny_text_clip()
    clip = cm.CLIPModel(clip_cfg)
    from genhancer_tpu_torch.core.nn import init_weights
    init_weights(clip, gen)
    clip_gpu = copy.deepcopy(clip).cuda()
    t5_ids = torch.from_numpy(rng.integers(0, 120, (2, 9)))
    mask = torch.ones((2, 9), dtype=torch.int64)
    mask[1, 5:] = 0
    clip_ids = torch.from_numpy(rng.integers(0, 50, (2, 8)))
    latent = torch.from_numpy(rng.standard_normal((1, *lat, spec.vae_cfg.z_channels),
                                                  dtype=np.float32))
    ts = flow.get_schedule(3, ids.shape[1])
    samples = {}
    for dev, enc, cl, dit in (("cpu", t5, clip, mods["dit"]),
                              ("cuda", t5_gpu, clip_gpu, mods_gpu["dit"])):
        with torch.no_grad():
            _zero_counts()
            for masked in (False, True):
                seq = tc.t5_sequence_provider(enc, t5_cfg)(
                    t5_ids.to(dev), mask.to(dev) if masked else None)
                samples[(dev, masked)] = seq
            vec = tc.clip_text_pooled_provider(cl, clip_cfg)(clip_ids.to(dev))
            prep = [tc.prepare(seq[i:i + 1], vec[i:i + 1], latent.to(dev)) for i in (0, 1)]

            def model(p):
                return lambda x, tv, g: dm.dit_forward(
                    dit, cfg, img=x, img_ids=p["img_ids"], txt=p["txt"], txt_ids=p["txt_ids"],
                    timesteps=tv, y=p["vec"], guidance=g)
            samples[(dev, "cfg")] = flow.denoise_euler_cfg(
                model(prep[0]), prep[0]["img"], ts, guidance=4.0, true_gs=3.5,
                neg_model_fn=model(prep[1]), timestep_to_start_cfg=1)
            launches[f"text {dev}"] = _read_counts()
    for key, name in ((False, "T5 unmasked"), (True, "T5 masked"), ("cfg", "T5 -> CFG sample")):
        errs[name] = _rel(samples[("cuda", key)], samples[("cpu", key)])
    check(_rel(samples[("cpu", True)], samples[("cpu", False)]) > 1e-3, "the T5 mask changed "
                                                                         "nothing")
    want_k1 = (2 * 3 - 1) * (cfg.depth + cfg.depth_single_blocks)   # 3 steps, CFG from step 1
    check(launches["text cuda"] == {**_no_launches(), "fused_rope_attention": want_k1},
          f"text-conditioned sample: launches {launches['text cuda']}, expected K1 {want_k1}")
    print(f"[small] tiny extras card vs CPU, max|card-cpu|/max|cpu|: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (bound {bound:g} in float32, 1e-4 in bf16); K1 launches "
          f"{ {k: v if isinstance(v, int) else v['fused_rope_attention'] for k, v in launches.items()} }",
          flush=True)
    for k, v in errs.items():
        if "bf16" not in k:
            check(v <= bound, f"tiny extras: {k} card vs CPU {v} (bound {bound})")
    del mods_gpu, cn_gpu, ip_gpu, t5_gpu, clip_gpu
    _free()


def phase_extras():
    """The extra models at full width on the card (random weights from a
    seed, bf16 DiT): a depth-2 ControlNet seeded from the flux-dev DiT with
    its zero projections replaced by seeded random ones, reconstruct at B=4
    (20 steps, median of 3); an IP-Adapter DiT forward at B=4, 224 px
    (context 4096, CLIP embedding 1024, 4 tokens; median of 10); the T5-XXL
    encoder (``google/t5-v1_1-xxl``'s published shape, initialised on the
    card) in bf16 at L=512, B=2 (a positive and a padded negative prompt;
    median of 3) and the MetaCLIP-L/14 text side's pooled vector; a 20-step
    CFG sample conditioned on them (joint L = 512 + 196 = 708: K5) and its VAE
    decode.  Each path's time, peak memory and K1/K2/K5 launches, held equal to
    the counts the models imply.  Returns the launch counts by path."""
    import numpy as np
    import torch
    from genhancer_tpu_torch.core.nn import init_weights
    from genhancer_tpu_torch.core.rope import spatial_ids
    from genhancer_tpu_torch.eval import reconstruct as recon
    from genhancer_tpu_torch.models import controlnet as cnm
    from genhancer_tpu_torch.models import dit as dm
    from genhancer_tpu_torch.models import ip_adapter as ipm
    from genhancer_tpu_torch.models import vae as vm
    from genhancer_tpu_torch.models.towers import clip as cm
    from genhancer_tpu_torch.models.towers import t5 as t5m
    from genhancer_tpu_torch.tasks import factory
    from genhancer_tpu_torch.tasks import text_conditioning as tc
    from genhancer_tpu_torch.tasks.image import init_modules
    from genhancer_tpu_torch.train import flow
    from genhancer_tpu_torch.train.config import load_config

    spec = factory.build_spec(load_config(CONFIG))[0]
    cfg, n_blocks = spec.dit_cfg, spec.dit_cfg.depth + spec.dit_cfg.depth_single_blocks
    gen = torch.Generator(device="cuda").manual_seed(21)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mods = init_modules(spec, gen, device="cuda").eval().requires_grad_(False)
    cn = cnm.init_controlnet_from_dit(gen, mods["dit"], cfg, depth=2, device="cuda",
                                      dtype=torch.bfloat16).requires_grad_(False)
    for lin in [cn.cond_in, *cn.controlnet_blocks]:
        _plant(lin, gen, 0.02)
    torch.cuda.synchronize()
    print(f"[extras] modules and a depth-2 ControlNet seeded from the DiT "
          f"({sum(p.numel() for p in cn.parameters()) / 1e9:.3f} B params) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(22)
    counts, peaks = {}, {}

    def timed(fn, n):
        t = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            t.append(time.perf_counter() - t0)
        return statistics.median(t)

    # ControlNet reconstruct, B=4
    images = rng.random((4, 224, 224, 3), dtype=np.float32)
    run = lambda: recon.reconstruct(mods, spec, images, num_steps=NUM_STEPS, seed=1,  # noqa: E731
                                    controlnet_params=cn)
    out = run()
    plain = recon.reconstruct(mods, spec, images, num_steps=NUM_STEPS, seed=1)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    out2 = run()
    counts["extras_controlnet"] = _read_counts()
    cn_s = timed(run, 3)
    peaks["ControlNet reconstruct"] = torch.cuda.max_memory_allocated() / 2**30
    want = {**_no_launches(), "fused_rope_attention": NUM_STEPS * (n_blocks + 2),
            "fused_attention": spec.tower_cfg.vision.num_layers}
    check(counts["extras_controlnet"] == want,
          f"ControlNet reconstruct launches {counts['extras_controlnet']} != {want}")
    check(np.isfinite(out).all() and out.shape == (4, 224, 224, 3),
          "ControlNet reconstruct: not finite or misshapen")
    print(f"[extras] ControlNet reconstruct B=4, {NUM_STEPS} steps: {cn_s * 1e3:.1f} ms "
          f"(median of 3) = {4 / cn_s:.2f} img/s; peak {peaks['ControlNet reconstruct']:.2f} "
          f"GiB; launches K1 {want['fused_rope_attention']} ({NUM_STEPS} x ({n_blocks} DiT + 2 "
          f"ControlNet blocks)), K2 {want['fused_attention']}; mean |with - without "
          f"ControlNet| {np.abs(out - plain).mean():.4f}, between two runs of one seed "
          f"{np.abs(out - out2).max():.3e}", flush=True)

    # IP-Adapter DiT forward, B=4 at 224 px
    ip = ipm.init_ip_params(gen, cfg, device="cuda").requires_grad_(False)
    for blk in [*ip.ip_double, *ip.ip_single]:
        _plant(blk.k_proj, gen, 0.02)
        _plant(blk.v_proj, gen, 0.02)
    bf = torch.bfloat16
    lat = spec.latent_hw
    n_img = (lat[0] // 2) * (lat[1] // 2)
    kw = dict(img=torch.randn((4, n_img, cfg.in_channels), generator=gen, device="cuda").to(bf),
              img_ids=spatial_ids(lat[0] // 2, lat[1] // 2, device="cuda")[None].expand(4, -1, -1),
              txt=torch.randn((4, 1, cfg.context_in_dim), generator=gen, device="cuda").to(bf),
              txt_ids=torch.zeros((4, 1, 3), device="cuda"),
              timesteps=torch.rand(4, generator=gen, device="cuda").to(bf),
              y=torch.randn((4, cfg.vec_in_dim), generator=gen, device="cuda").to(bf),
              guidance=torch.full((4,), 4.0, dtype=bf, device="cuda"))
    embeds = torch.randn((4, 1024), generator=gen, device="cuda")
    with torch.no_grad():
        fwd = lambda: dm.dit_forward(mods["dit"], cfg, image_proj=embeds, ip_params=ip,  # noqa: E731
                                     ip_scale=0.8, **kw)
        with_ip, without = fwd(), dm.dit_forward(mods["dit"], cfg, **kw)
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        fwd()
        counts["extras_ip"] = _read_counts()
        ip_s = timed(fwd, 10)
        peaks["IP DiT forward"] = torch.cuda.max_memory_allocated() / 2**30
    want = {**_no_launches(), "fused_rope_attention": n_blocks}
    check(counts["extras_ip"] == want, f"IP forward launches {counts['extras_ip']} != {want}")
    check(bool(torch.isfinite(with_ip).all()) and float((with_ip - without).abs().max()) > 0,
          "IP forward: not finite, or the IP residual added nothing")
    print(f"[extras] IP-Adapter DiT forward B=4 (L=197, 4 IP tokens in {cfg.depth} double and "
          f"{cfg.depth_single_blocks} single blocks): {ip_s * 1e3:.2f} ms (median of 10); peak "
          f"{peaks['IP DiT forward']:.2f} GiB; K1 {n_blocks}; mean |with - without IP| "
          f"{float((with_ip - without).float().abs().mean()):.4f}", flush=True)
    del ip, with_ip, without
    _free()

    # T5-XXL at L=512, B=2, and the CLIP text side's pooled vector
    t0 = time.perf_counter()
    t5_cfg = t5m.T5Config()
    t5 = t5m.init_t5(gen, t5_cfg, device="cuda", dtype=bf).requires_grad_(False)
    clip_cfg = spec.tower_cfg
    clip = init_weights(cm.CLIPModel(clip_cfg, device="cuda"), gen).requires_grad_(False)
    torch.cuda.synchronize()
    n_t5 = sum(p.numel() for p in t5.parameters())
    n_mm = sum(p.numel() for n, p in t5.named_parameters()
               if n.endswith((".q.weight", ".k.weight", ".v.weight", ".o.weight", "wi_0.weight",
                              "wi_1.weight", "wo.weight")))
    print(f"[extras] T5-XXL ({n_t5 / 1e9:.3f} B params, bf16) and the MetaCLIP-L/14 CLIPModel "
          f"initialised on the card in {time.perf_counter() - t0:.1f} s", flush=True)
    ids = torch.randint(0, t5_cfg.vocab_size, (2, 512), generator=gen, device="cuda")
    mask = torch.ones((2, 512), dtype=torch.int64, device="cuda")
    mask[1, 77:] = 0                                   # the negative prompt is padded
    clip_ids = torch.randint(0, clip_cfg.text.vocab_size - 2, (2, 77), generator=gen,
                             device="cuda")
    clip_ids[:, 20] = clip_cfg.text.eos_token_id
    encode = tc.t5_sequence_provider(t5, t5_cfg, dtype=bf)
    pooled = tc.clip_text_pooled_provider(clip, clip_cfg)
    with torch.no_grad():
        seq = encode(ids, mask)
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        vec = pooled(clip_ids)
        seq = encode(ids, mask)
        counts["extras_t5"] = _read_counts()
        t5_s = timed(lambda: encode(ids, mask), 3)
        clip_s = timed(lambda: pooled(clip_ids), 3)
        peaks["T5-XXL encode"] = torch.cuda.max_memory_allocated() / 2**30
    check(counts["extras_t5"] == _no_launches(),
          f"T5 and CLIP text launched kernels: {counts['extras_t5']} (their attention is "
          "plain products: T5's position bias, CLIP text's causal mask)")
    check(tuple(seq.shape) == (2, 512, 4096) and seq.dtype == bf and bool(torch.isfinite(seq).all())
          and tuple(vec.shape) == (2, 768), "T5 / CLIP text: shape, dtype or finiteness")
    tok = 2 * 512
    print(f"[extras] T5-XXL encode B=2, L=512 bf16: {t5_s * 1e3:.1f} ms (median of 3) = "
          f"{tok / t5_s:.0f} tokens/s, {2 * n_mm * tok / t5_s / 1e12:.1f} TFLOP/s of the "
          f"linears' products; peak {peaks['T5-XXL encode']:.2f} GiB; CLIP text pooled vector B=2, L=77: "
          f"{clip_s * 1e3:.2f} ms; kernel launches none", flush=True)
    del t5
    _free()

    # a 20-step CFG sample on the T5 sequence and the pooled vector (K5 at L=708)
    noise = torch.randn((1, *lat, spec.vae_cfg.z_channels), generator=gen, device="cuda")
    prep = [tc.prepare(seq[i:i + 1], vec[i:i + 1], noise) for i in (0, 1)]
    ts = flow.get_schedule(NUM_STEPS, n_img)

    def model(p):
        return lambda x, tv, g: dm.dit_forward(
            mods["dit"], cfg, img=x, img_ids=p["img_ids"], txt=p["txt"].to(x.dtype),
            txt_ids=p["txt_ids"], timesteps=tv, y=p["vec"].to(x.dtype), guidance=g)

    sample = lambda: flow.denoise_euler_cfg(  # noqa: E731
        model(prep[0]), prep[0]["img"].to(bf), ts, guidance=4.0, true_gs=3.5,
        neg_model_fn=model(prep[1]))
    with torch.no_grad():
        sample()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        tokens = sample()
        counts["extras_text_cfg"] = _read_counts()
        cfg_s = timed(sample, 3)
        peaks["CFG sample"] = torch.cuda.max_memory_allocated() / 2**30
        img = vm.vae_decode(mods["vae"], spec.vae_cfg,
                            dm.unpack_latent(tokens.float(), lat[0], lat[1]))
    want = {**_no_launches(), "flash_attention": 2 * NUM_STEPS * n_blocks}
    check(counts["extras_text_cfg"] == want,
          f"CFG sample launches {counts['extras_text_cfg']} != {want}")
    check(bool(torch.isfinite(img).all()) and tuple(img.shape) == (1, 224, 224, 3),
          "CFG sample: the decoded image is not finite or misshapen")
    print(f"[extras] text-conditioned CFG sample B=1, {NUM_STEPS} steps (true_gs 3.5, "
          f"joint L={512 + n_img}): {cfg_s * 1e3:.1f} ms (median of 3); peak "
          f"{peaks['CFG sample']:.2f} GiB; K5 {want['flash_attention']} ({NUM_STEPS} steps x 2 "
          f"branches x {n_blocks} blocks), K1 0; decoded image finite, mean "
          f"{float(img.mean()):.4f}", flush=True)
    del mods, cn, clip, seq, vec
    _free()
    return counts


def main():
    t_start = time.perf_counter()
    name = phase_device()
    phase_build()
    records = {**(attempt(phase_kernels) or {}), **(attempt(phase_kernels_bwd) or {}),
               **(attempt(phase_kernels_flash) or {})}
    attempt(phase_kernels_siglip, records)
    records["fused_adamw"] = attempt(phase_adamw)
    records.update(attempt(phase_kernels_int8) or {})
    attempt(phase_k7_static_widths)
    attempt(phase_kernels_extras, records)
    records.update(attempt(phase_adamw_int8) or {})
    attempt(phase_small_reference)
    attempt(phase_small_train)
    attempt(phase_small_video)
    attempt(phase_small_stage2)
    attempt(phase_small_video_stage2)
    attempt(phase_small_siglip)
    work = tempfile.mkdtemp(prefix="chip_smoke_small_")
    try:
        attempt(phase_small_eval, work)
        attempt(phase_small_eval_siglip, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    attempt(phase_small_int8)
    attempt(phase_small_qlora)
    attempt(phase_small_serve_int8)
    attempt(phase_small_extras)
    serve_counts = attempt(phase_server)
    serve_int8_counts = attempt(phase_serve_int8)
    extras_counts = attempt(phase_extras)
    # the stage-2 exports the MMVP-VLM eval reads at the end
    eval_root, exports = tempfile.mkdtemp(prefix="chip_smoke_eval_"), {}
    try:
        work = tempfile.mkdtemp(prefix="chip_smoke_train_")
        try:
            train_counts, n_leaves, stage1, k3_ref = (attempt(phase_train, work)
                                                      or (None, None, None, None))
            dp_counts = attempt(phase_dp, work, k3_ref)
            sp_int8_counts = attempt(phase_sp_int8_serve, work) or {}
            # phase_sp_pp's (b) launches beside phase_tp_fsdp's (d)
            pp_run = {"k3_loss": (k3_ref or {}).get("loss")}
            tp_counts = attempt(phase_tp_fsdp, work, k3_ref, n_leaves, pp_run)
            stage2_counts, exports["image"] = (attempt(phase_stage2_train, work, stage1,
                                                       eval_root) or (None, None))
        finally:
            shutil.rmtree(work, ignore_errors=True)
        work = tempfile.mkdtemp(prefix="chip_smoke_int8_")
        try:
            with _Wave() as wave:
                sp_full = attempt(sp_int8_full_start, wave, work)
                int8_counts, int8_stage1 = attempt(phase_train_int8, work) or (None, None)
                fast_counts = attempt(phase_fast_stage2, work, int8_stage1)
                sp_int8_counts.update(attempt(phase_sp_int8_full, wave, sp_full) or {})
        finally:
            shutil.rmtree(work, ignore_errors=True)
        work = tempfile.mkdtemp(prefix="chip_smoke_video_")
        try:
            video_counts, video1, sliding_ref = (attempt(phase_video_train, work)
                                                 or (None, None, None))
            video2_counts, exports["middle"] = (attempt(phase_video_stage2, work, video1 or {},
                                                        eval_root) or (None, None))
            with _video_depth("middle"):        # it loads middle@336's files
                fast_video_counts = attempt(phase_fast_video, work, video1 or {})
            sp_pp_counts = attempt(phase_sp_pp, work, sliding_ref, pp_run)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        work = tempfile.mkdtemp(prefix="chip_smoke_siglip_")
        try:
            # the DiT cut to 1 + 1 blocks, to stay inside 1100 s
            with _DitDepth(1, 1):
                siglip_counts, exports["siglip"] = (attempt(phase_siglip, work, eval_root)
                                                    or (None, None))
        finally:
            shutil.rmtree(work, ignore_errors=True)
        eval_counts = attempt(phase_eval, eval_root, {
            "image stage 2 export (MetaCLIP-L/14, 224 px)": (exports["image"], "metaclip", 224),
            "middle@336 stage 2 export (CLIP-L/14@336)": (exports["middle"], "openai_clip",
                                                          336),
            "SigLIP stage2_all export (so400m, 384 px)": (exports["siglip"], "siglip", 384)})
    finally:
        shutil.rmtree(eval_root, ignore_errors=True)
    if FAILURES:
        print("FAILED phases:\n  " + "\n  ".join(FAILURES), flush=True)
        sys.exit(1)
    paths = {"serve": serve_counts, "serve_int8": serve_int8_counts, **extras_counts,
             **{f"train_{k}": v for k, v in train_counts.items()},
             **stage2_counts, **dp_counts, **tp_counts, **int8_counts, **video_counts,
             **video2_counts,
             **siglip_counts,
             **eval_counts, **fast_counts, **fast_video_counts, **sp_pp_counts,
             **sp_int8_counts}

    def launches(counts, name):     # K6's record counts both of its bodies
        return counts[name] + (counts["fused_adamw8_quant"] if name == "fused_adamw8" else 0)

    for r in records.values():
        # the path of the slice that ported the kernel or first ran it
        # (K1/K2/K1b/K3: the image training path; K2b: image stage 2)
        r["main_path"] = MAIN_PATH.get(r["name"], "train_pallas")
        r["launches"] = launches(paths[r["main_path"]], r["name"])
        r["launches_by_path"] = {p: launches(c, r["name"]) for p, c in paths.items()}
    for n in ("fused_adamw_quant", "rowquant"):
        check(paths["train_int8"][n] > 0, f"{n} not launched on the int8 path")
    for n in ("fused_adamw8", "fused_adamw8_quant", "int8_dw", "rowquant"):
        check(paths["train_int8_dw"][n] > 0, f"{n} not launched on the int8_dw path")
    check(len(records) == 11 and all(set(REQUIRED_KEYS) <= set(r) for r in records.values()),
          f"kernel records: {sorted(records)}")
    # every kernel of a path ran on it; K2b runs where the tower trains (image
    # and video stage 2), 48 times per optimizer step (24 layers x 2
    # micro-batches), and nowhere else
    # K2 runs on every path but SigLIP's training and serving ones, whose
    # tower (L = 729) runs K5; the SigLIP eval's text side runs K2
    # the extra models' paths run no tower but the ControlNet reconstruct's
    siglip = [p for p in paths if p.startswith("siglip_") or p == "serve_siglip"]
    no_tower = [*siglip, "extras_ip", "extras_t5", "extras_text_cfg"]
    check(all(c["fused_attention"] > 0 for p, c in paths.items() if p not in no_tower)
          and all(paths[p]["fused_attention"] == 0 for p in no_tower),
          "fused_attention not launched on every path with a tower but SigLIP's, or launched "
          "on SigLIP's or a path without a tower")
    for p in siglip:
        for n in ("flash_attention", "fused_rope_attention"):
            check(paths[p][n] > 0, f"{n} not launched on {p}")
    for p in ("siglip_stage1", "siglip_stage2_all", "siglip_stage2_only"):
        check(paths[p]["fused_rope_attention_bwd"] > 0
              and (paths[p]["flash_attention_bwd"] > 0) == (p != "siglip_stage1"),
              f"{p}: K1b/K5b launches {paths[p]}")
    print("[done] SigLIP launches per optimizer step: " + "; ".join(
        f"{p} K5 {paths[p]['flash_attention'] // SIGLIP_STEPS[p]}, K5b "
        f"{paths[p]['flash_attention_bwd'] // SIGLIP_STEPS[p]}, K1 "
        f"{paths[p]['fused_rope_attention'] // SIGLIP_STEPS[p]}, K1b "
        f"{paths[p]['fused_rope_attention_bwd'] // SIGLIP_STEPS[p]}, K2b "
        f"{paths[p]['fused_attention_bwd']}" for p in SIGLIP_STEPS), flush=True)
    k2b = {p: c["fused_attention_bwd"] for p, c in paths.items()}
    check(all(n == (48 * STAGE2_STEPS[p] if p in STAGE2_STEPS
                    else 24 * FAST_STEPS[p] if p in FAST_STEPS else 0) for p, n in k2b.items()),
          f"K2b launches by path {k2b}: 48 per step on the stage-2 paths "
          f"({STAGE2_STEPS} steps), 24 on the fast ones (no accumulation, {FAST_STEPS} "
          "steps), 0 elsewhere")
    for p in FAST_STEPS:        # the fast stage-2 paths run the int8 kernels
        check(paths[p]["rowquant"] > 0, f"rowquant not launched on {p}")
        check((paths[p]["fused_adamw_quant"] > 0) == (p != "fast_stage2_only"),
              f"{p}: K4 launches {paths[p]['fused_adamw_quant']}")
    print(f"[done] K2b launches by path: {k2b}", flush=True)
    check(paths["train_stage2_only"]["fused_adamw"] > 0, "fused_adamw not launched in stage 2")
    for n in ("fused_rope_attention", "fused_rope_attention_bwd"):
        check(all(paths[p][n] > 0 for p in ("train_chain", "train_pallas", "video_next")),
              f"{n} not launched on a path below 600 tokens")
    for n in ("flash_attention", "flash_attention_bwd"):
        check(all(paths[p][n] > 0 for p in ("video_sliding", "video_next2", "video_middle")),
              f"{n} not launched on a path above 600 tokens")
    check(train_counts["pallas"]["fused_adamw"] > 0, "fused_adamw not launched in training")
    import torch
    print(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
