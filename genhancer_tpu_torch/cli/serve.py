"""Serving CLI: stage-1 inference behind HTTP, on a CUDA device.

``genhancer-serve-torch --config configs/MetaCLIP_large_stage1.yaml \
    --load_dir out/ --load_step 1000 --port 8000 --buckets 1,4,8``

Port of ``genhancer_tpu/cli/serve.py`` with the same flags plus
``--device``.  Startup runs every (endpoint, bucket) once (``warmup``),
which also builds the CUDA kernels, then serves with dynamic
micro-batching.
"""

from __future__ import annotations

import argparse
import logging


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
                        help=">1 is not ported yet and is refused")
    parser.add_argument("--model_parallel", type=int, default=1,
                        help=">1 is not ported yet and is refused")
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

    from ..serve.engine import InferenceEngine
    from ..serve.http import ServeApp

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
