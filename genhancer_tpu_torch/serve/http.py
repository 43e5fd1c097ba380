"""Dependency-free HTTP front end for the inference engine.

Carried over from ``genhancer_tpu/serve/http.py``; only the imports point at
this package.

Endpoints:
  * ``POST /v1/reconstruct`` — body: image bytes (jpeg/png/...) or JSON
    ``{"image_b64": "..."}``; optional ``?seed=N``.  Response: JPEG of the
    stage-1 reconstruction (the visual-quality probe of an enhanced tower).
  * ``POST /v1/embed`` — same request format.  Response: JSON
    ``{"embedding": [...], "dim": D}`` — the tower class token, the
    representation MMVP-VLM evaluates.
  * ``GET /healthz`` — liveness + configuration.
  * ``GET /v1/stats`` — request counts, executed-batch histogram,
    latency percentiles per endpoint.

Uses stdlib ``http.server`` (threading) — the concurrency that matters
happens in :mod:`batcher`, which turns concurrent connections into batched
device calls; HTTP threads only block on futures.
"""

from __future__ import annotations

import base64
import io
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from .batcher import MicroBatcher, Overloaded, ServerClosing, Stats
from .engine import InferenceEngine

logger = logging.getLogger(__name__)


def _decode_request(handler: BaseHTTPRequestHandler, img_size: int) -> np.ndarray:
    from ..data.transforms import eval_image_transform
    length = int(handler.headers.get("Content-Length", 0))
    if length <= 0:
        raise ValueError("empty request body")
    if length > 64 << 20:
        raise ValueError("request body too large")
    body = handler.rfile.read(length)
    ctype = (handler.headers.get("Content-Type") or "").split(";")[0].strip()
    if ctype == "application/json":
        payload = json.loads(body)
        if "image_b64" not in payload:
            raise ValueError("JSON body must contain image_b64")
        body = base64.b64decode(payload["image_b64"])
    return eval_image_transform(body, img_size)   # [H, W, 3] float32 [0,1]


def _parse_seed(query: str) -> Optional[int]:
    """'seed=N' from the query string; None when absent; ValueError on junk
    (surfaces as a 500 with the message — a typo'd seed should not silently
    become a random draw)."""
    for part in query.split("&"):
        k, _, v = part.partition("=")
        if k == "seed":
            return int(v)
    return None


def _encode_jpeg(img: np.ndarray) -> bytes:
    """img: float [0,1] (float32-wire engine) or uint8 (uint8-wire)."""
    from PIL import Image
    buf = io.BytesIO()
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    Image.fromarray(img).save(buf, format="JPEG", quality=95)
    return buf.getvalue()


class ServeApp:
    """Engine + per-endpoint batchers + the HTTP server object."""

    def __init__(self, engine: InferenceEngine, *, max_wait_ms: float = 5.0,
                 max_queue: int = 256,
                 endpoints=("reconstruct", "embed")):
        """``endpoints``: which endpoints this server exposes — must match
        what ``engine.warmup`` compiled, or the first request to an un-warmed
        endpoint would compile online (the exact case the engine design
        forbids).  Un-listed endpoints answer 404."""
        self.engine = engine
        self.endpoints = tuple(endpoints)
        fns = {"reconstruct": engine.reconstruct, "embed": engine.embed}
        self.stats = {ep: Stats() for ep in self.endpoints}
        self.batchers = {
            ep: MicroBatcher(fns[ep], engine.max_batch,
                             max_wait_ms=max_wait_ms, max_queue=max_queue,
                             stats=self.stats[ep], name=f"batch-{ep}")
            for ep in self.endpoints}
        self._server: Optional[ThreadingHTTPServer] = None

    # ------------------------------------------------------------- server

    def make_server(self, host: str = "127.0.0.1", port: int = 8000
                    ) -> ThreadingHTTPServer:
        app = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route to logging, not stderr
                logger.debug("%s - %s", self.address_string(), fmt % args)

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code: int, obj):
                self._send(code, json.dumps(obj).encode(), "application/json")

            def do_GET(self):
                if self.path == "/healthz":
                    e = app.engine
                    self._send_json(200, {
                        "status": "ok",
                        "img_size": e.spec.img_size,
                        "tower": e.spec.tower_kind,
                        "num_steps": e.num_steps,
                        "buckets": list(e.buckets),
                        "endpoints": list(app.endpoints),
                    })
                elif self.path == "/v1/stats":
                    self._send_json(200, {k: s.snapshot()
                                          for k, s in app.stats.items()})
                else:
                    self._send_json(404, {"error": "not found"})

            def do_POST(self):
                path, _, query = self.path.partition("?")
                endpoint = {"/v1/reconstruct": "reconstruct",
                            "/v1/embed": "embed"}.get(path)
                if endpoint is None or endpoint not in app.batchers:
                    self._send_json(404, {"error": "not found"})
                    return
                try:
                    seed = _parse_seed(query)
                    img = _decode_request(self, app.engine.spec.img_size)
                except Exception as e:
                    # the body may be partly/fully unread (size guard,
                    # malformed JSON) — a keep-alive connection would parse
                    # the leftover bytes as the next request line, so close
                    self.close_connection = True
                    self._send_json(400, {"error": str(e)})
                    return
                try:
                    t0 = time.perf_counter()
                    if endpoint == "reconstruct" and seed is not None:
                        # seeded = deterministic: runs unbatched (one request
                        # per device call) so the noise is a pure function of
                        # the seed, never of batch composition
                        out = app.engine.reconstruct(img[None], seed=seed)[0]
                        app.stats[endpoint].record(
                            1, [time.perf_counter() - t0])
                    else:
                        fut = app.batchers[endpoint].submit(img)
                        out = fut.result(timeout=600.0)
                except (Overloaded, ServerClosing) as e:
                    # tell clients to back off, not that the server is broken
                    self._send_json(503, {"error": str(e)})
                    return
                except Exception as e:
                    logger.exception("inference failed")
                    self._send_json(500, {"error": str(e)})
                    return
                if endpoint == "reconstruct":
                    self._send(200, _encode_jpeg(out), "image/jpeg")
                else:
                    self._send_json(200, {"embedding": out.tolist(),
                                          "dim": int(out.shape[-1])})

        self._server = ThreadingHTTPServer((host, port), Handler)
        return self._server

    def serve_background(self, host: str = "127.0.0.1", port: int = 0):
        """Start in a daemon thread; returns (server, thread). port=0 picks
        an ephemeral port (server.server_address[1])."""
        server = self.make_server(host, port)
        t = threading.Thread(target=server.serve_forever, daemon=True,
                             name="genhancer-serve")
        t.start()
        return server, t

    def close(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        for b in self.batchers.values():
            b.close()
        stop = getattr(self.engine, "stop", None)
        if stop is not None:    # a mesh engine's followers: released
            stop()
