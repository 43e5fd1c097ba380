"""Serving CLI: stage-1 inference behind HTTP, on a CUDA device.

``genhancer-serve-torch --config configs/MetaCLIP_large_stage1.yaml \
    --load_dir out/ --load_step 1000 --port 8000 --buckets 1,4,8``

Port of ``genhancer_tpu/cli/serve.py`` with the same flags plus
``--device``.  Startup runs every (endpoint, bucket) once (``warmup``),
which also builds the CUDA kernels, then serves with dynamic
micro-batching.

Several cards: one process per card under torchrun, on the (data, model)
mesh (``serve.engine``)::

    python -m torch.distributed.run --nproc_per_node 4 \
        -m genhancer_tpu_torch.cli.serve --config configs/MetaCLIP_large_stage1.yaml \
        --num_devices 4 --model_parallel 2

Rank 0 runs the HTTP server and the batcher; the other ranks follow its
batches until it stops.  The group's timeout (``SERVE_GROUP_TIMEOUT_S``)
bounds a collective, so a rank that dies fails rank 0's requests instead of
blocking it.
"""

from __future__ import annotations

import argparse
import logging

# Seconds one collective of the serving group may wait before it raises.
SERVE_GROUP_TIMEOUT_S = 600.0


def main(argv=None):
    parser = argparse.ArgumentParser(description="genhancer inference server (PyTorch)")
    parser.add_argument("--config", required=True,
                        help="stage-1 training YAML (model/tower/resolution)")
    parser.add_argument("--load_dir", default=None,
                        help="stage-1 checkpoint dir (checkpoint-dit-N.bin...)")
    parser.add_argument("--load_step", type=int, default=None)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the engine (cuda, cuda:N, cpu)")
    parser.add_argument("--buckets", default="1,4,8",
                        help="comma-separated batch buckets to warm up")
    parser.add_argument("--num_steps", type=int, default=20,
                        help="Euler sampler steps (static per server)")
    parser.add_argument("--guidance", type=float, default=4.0)
    parser.add_argument("--max_wait_ms", type=float, default=5.0,
                        help="micro-batch collection window")
    parser.add_argument("--endpoints", default="reconstruct,embed",
                        help="which endpoints to warm up/serve")
    parser.add_argument("--quant", default="none", choices=("none", "int8"),
                        help="int8: the DiT's and the tower's linears and the VAE's "
                             "convs run int8 (weights quantized at load)")
    parser.add_argument("--num_devices", type=int, default=1,
                        help="cards (processes under torchrun) of the serving mesh")
    parser.add_argument("--model_parallel", type=int, default=1,
                        help="the DiT's TP degree on the mesh (implies num_devices >= it)")
    parser.add_argument("--wire_dtype", default="uint8",
                        choices=("uint8", "float32"),
                        help="pixel dtype crossing host<->device: uint8 "
                             "(default) moves /255 and *255 onto the device; "
                             "float32 keeps exact float [0,1] IO")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    log = logging.getLogger("genhancer.serve")

    from ..parallel import mesh
    from ..serve.engine import InferenceEngine, resolve_device
    from ..serve.http import ServeApp

    mesh.maybe_initialize_distributed(mesh.rank_device(resolve_device(args.device)),
                                      SERVE_GROUP_TIMEOUT_S)

    buckets = [int(b) for b in args.buckets.split(",") if b]
    endpoints = [e.strip() for e in args.endpoints.split(",") if e.strip()]
    log.info("loading engine (config=%s load_dir=%s device=%s)", args.config,
             args.load_dir, args.device)
    engine = InferenceEngine.from_config(
        args.config, device=args.device, load_dir=args.load_dir,
        load_step=args.load_step, num_steps=args.num_steps,
        guidance=args.guidance, buckets=buckets, quant=args.quant,
        num_devices=args.num_devices, model_parallel=args.model_parallel,
        wire_dtype=args.wire_dtype)
    if engine.mesh is not None and mesh.rank() != 0:
        log.info("rank %d following rank 0's batches", mesh.rank())
        engine.follow()
        return
    log.info("warming up %s x buckets %s", endpoints, list(engine.buckets))
    engine.warmup(endpoints)

    app = ServeApp(engine, max_wait_ms=args.max_wait_ms, endpoints=endpoints)
    server = app.make_server(args.host, args.port)
    log.info("serving on %s:%d", *server.server_address[:2])
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        app.close()


def cli() -> None:
    main()


if __name__ == "__main__":
    cli()
