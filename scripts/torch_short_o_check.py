"""K1/K2's bf16 o against their plain versions as mean|kernel - plain| /
mean|plain| (the rounding-point check, bound 2e-4), on one CUDA card.

It imports ``genhancer_tpu_torch`` from the working directory, so it reads
any checkout of the port, an older one included:

    cd <checkout> && python3 <this repo>/scripts/torch_short_o_check.py
"""
import os
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

from genhancer_tpu_torch.core.kernels import short_attention as K  # noqa: E402
from genhancer_tpu_torch.core.rope import multi_axis_rope  # noqa: E402

g = torch.Generator(device="cuda").manual_seed(5)
for name, b, l, h, d in (("K1", 8, 197, 24, 128), ("K1", 1, 600, 24, 128),
                         ("K2", 8, 257, 16, 64), ("K2", 2, 256, 16, 72)):
    q, k, v = (torch.randn((b, l, h, d), generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    if name == "K1":
        ids = torch.randint(0, 16, (b, l, 3), generator=g, device="cuda").float()
        cos, sin = multi_axis_rope(ids, (d // 2, d // 4, d // 4), 10_000)
        out, ref = (K.fused_rope_attention(q, k, v, cos, sin),
                    K.fused_rope_attention_ref(q, k, v, cos, sin))
    else:
        out, ref = K.fused_attention(q, k, v), K.fused_attention_ref(q, k, v)
    torch.cuda.synchronize()
    o, r = out.float(), ref.float()
    print(f"{name} B={b} L={l} H={h} D={d}: max|kernel-plain| {(o - r).abs().max().item():.3e}, "
          f"mean|kernel-plain|/mean|plain| {((o - r).abs().mean() / r.abs().mean()).item():.3e}"
          f" (bound 2e-04)", flush=True)
