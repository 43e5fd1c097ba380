"""K2 in float32 at the MMVP-VLM eval's shapes (B=50, H=16, D=64, L=257
and 577) on one CUDA card: max|kernel - plain| and mean|kernel - plain| /
mean|plain| against exact float32 (TF32 off), and the device time of the
kernel and of SDPA in float32, each from a CUDA graph of 5 calls (the
median of 4 replays of 5).

It imports ``genhancer_tpu_torch`` from the working directory, so it reads
any checkout of the port, an older one included; run two checkouts in one
call to compare them on one card (parent, change, change, parent):

    cd <checkout> && python3 <this repo>/scripts/torch_k2_f32_probe.py <tag>
"""
import os
import statistics
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from genhancer_tpu_torch.core.kernels import short_attention as K  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def graph_ms(fn, n=5, rounds=4):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 5 / n)
    return statistics.median(times)


tag = sys.argv[1] if len(sys.argv) > 1 else os.path.basename(os.getcwd())
gen = torch.Generator(device="cuda").manual_seed(5)
for l in (257, 577):
    q, k, v = (torch.randn((50, l, 16, 64), generator=gen, device="cuda") for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    out, ref = K.fused_attention(q, k, v), K.fused_attention_ref(q, k, v)
    err = (out - ref).abs().max().item()
    mean = ((out - ref).abs().mean() / ref.abs().mean()).item()
    del out, ref
    dev = graph_ms(lambda: K.fused_attention(q, k, v))
    lib = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    print(f"[{tag}] K2 float32 B=50 L={l} H=16 D=64: max|kernel-plain| {err:.2e}, "
          f"mean|kernel-plain|/mean|plain| {mean:.2e}; device {dev:.4f} ms, SDPA float32 "
          f"device {lib:.4f} ms", flush=True)
