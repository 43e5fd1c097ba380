"""Transport of the port's point-to-point rotation on one CUDA card.

    python3 scripts/torch_rotate_probe.py

Starts two gloo ranks sharing card 0 (NCCL refuses two ranks on one
device) and times, for a float32 [16, 482, 24, 128] tensor (94.8 MB: the
ring's dK/dV chunk at sliding@224 on two seq ranks), one exchange with the
peer staged through pageable host memory and one through
``parallel.mesh.rotate`` (pinned host buffers), and a gloo all-reduce of a
256 MB CUDA bucket (the gradient sum's).  Prints rank 0's times of the
calls after the first.
"""

import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rank_main(r: int, store: str) -> None:
    sys.path.insert(0, ROOT)
    from genhancer_tpu_torch.parallel import mesh
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=r, world_size=2)
    mesh.make_mesh(1, 2)
    x = torch.randn(16, 482, 24, 128, device="cuda")

    def pageable(t):
        host = t.cpu()
        out = torch.empty_like(host)
        mesh._p2p(host, out, 1 - r, 1 - r, None)
        return out.to(t.device)

    for name, fn in (("pageable", pageable),
                     ("pinned (mesh.rotate)", lambda t: mesh.rotate(t, mesh.SEQ_AXIS))):
        for i in range(4):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(x)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if r == 0 and i > 0:
                print(f"[rotate] {name} 94.8 MB float32: {dt * 1e3:.1f} ms = "
                      f"{x.numel() * 4 / dt / 1e9:.2f} GB/s", flush=True)
    g = torch.randn((256 << 20) // 4, device="cuda")
    for i in range(3):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(g)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if r == 0 and i > 0:
            print(f"[rotate] gloo all_reduce of a 256 MB CUDA bucket: {dt * 1e3:.1f} ms = "
                  f"{g.numel() * 4 / dt / 1e9:.2f} GB/s", flush=True)
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", flush=True)
        return 1
    store = os.path.join(tempfile.mkdtemp(), "store")
    procs = [subprocess.Popen([sys.executable, __file__, str(r), store]) for r in range(2)]
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    print(f"[rotate] {torch.cuda.get_device_name(0)}; rank exit codes {rcs}", flush=True)
    return max(rcs)


if __name__ == "__main__":
    if len(sys.argv) > 1:
        rank_main(int(sys.argv[1]), sys.argv[2])
    else:
        sys.exit(main())
