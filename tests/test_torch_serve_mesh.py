"""Multi-device serving of the port (``serve/engine.py`` with
``num_devices``/``model_parallel``) on gloo ranks, against JAX's
single-device engine.

JAX's five ``TestMultiChipEngine`` cases (``tests/test_serve.py:157-205``):
data parallel, data x model parallel, int8 under TP, ``model_parallel``
alone, and the buckets rounded up to the data axis.  Rank 0 answers; the
other ranks follow its broadcasts.  The one-process reference draws the
bucket's NHWC noise from the seed (``torch.Generator().manual_seed``) and
JAX's single-device program runs on that noise (``jax_reconstruct``);
``embed`` is JAX's engine's.  Bound: JAX's own, atol 2e-5.  The int8 mesh
is held to the port's one-process int8 engine at that bound (its codes
are one process's; the int8 engine against JAX's is held per int8 call in
tests/test_torch_serve_int8.py, since a whole int8 network is chaotic
between two implementations).  One HTTP round trip runs with rank 0
serving and rank 1 following.
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genhancer_tpu.serve.engine import InferenceEngine as JaxEngine
from genhancer_tpu_torch.serve.engine import InferenceEngine

from test_torch_parallel import _launch
from test_torch_parity import jax_params, jax_spec, port_modules, port_spec
from test_torch_serve import jax_reconstruct

torch.set_num_threads(1)

ATOL = 2e-5
STEPS = 2


@pytest.fixture(scope="module")
def case():
    spec = jax_spec()
    params = jax_params(spec, seed=0)
    return spec, params, port_modules(spec, params).state_dict()


def _images(n, seed):
    return np.random.default_rng(seed).random((n, 32, 32, 3), dtype=np.float32)


def _jax_recon(spec, params, img, seed, bucket):
    """JAX's single-device program on the bucket's noise of ``seed``."""
    lat_h, lat_w = spec.latent_hw
    noise = torch.randn((bucket, lat_h, lat_w, spec.vae_cfg.z_channels),
                        generator=torch.Generator().manual_seed(seed)).numpy()
    pad = np.concatenate([img, np.repeat(img[-1:], bucket - img.shape[0], axis=0)])
    out = jax_reconstruct(spec, params, jnp.asarray(pad), jnp.asarray(noise), STEPS,
                          4.0, "float32")
    return out[:img.shape[0]]


def _serve(tmp_path, name, spec, sd, world, requests, **kw):
    payload = {"scenario": "serve", "spec": port_spec(spec), "state_dict": sd,
               "num_steps": STEPS, "requests": requests, "num_devices": kw.pop("num_devices", 1),
               **kw}
    return _launch(tmp_path, name, payload, world)


def test_dp_matches_single_device(case, tmp_path):
    """dp=2: reconstruct and embed equal JAX's single-device engine; then
    one HTTP round trip of each endpoint with rank 0 serving and rank 1
    following (the JPEG answer decodes to the image size, the embedding
    has the tower's width)."""
    spec, params, sd = case
    img = _images(4, 0)
    rgb = (_images(1, 9)[0] * 255).astype(np.uint8)
    outs = _serve(tmp_path, "dp", spec, sd, 2, [("reconstruct", img, 3), ("embed", img, None)],
                  num_devices=2, buckets=(4,), http=True, jpeg_image=rgb)
    (recon, _), (emb, _) = outs[0]["answers"]
    np.testing.assert_allclose(recon, _jax_recon(spec, params, img, 3, 4), atol=ATOL)
    jeng = JaxEngine(spec, jax.tree_util.tree_map(jnp.asarray, params), num_steps=STEPS,
                     buckets=(4,))
    np.testing.assert_allclose(emb, jeng.embed(img), atol=ATOL)
    assert outs[0]["groups"]["data_group"] == [0, 1] and outs[1]["answers"] == []
    (p1, s1, ct1, body1), (p2, s2, ct2, body2) = outs[0]["http"]
    assert (s1, ct1, s2) == (200, "image/jpeg", 200)
    from PIL import Image
    assert Image.open(io.BytesIO(body1)).size == (32, 32)
    emb_http = json.loads(body2)
    assert emb_http["dim"] == 24 and np.isfinite(emb_http["embedding"]).all()


def test_dp_tp_matches_single_device(case, tmp_path):
    """dp2 x tp2 on 4 ranks: the DiT on the trainer's TP layout."""
    spec, params, sd = case
    img = _images(4, 1)
    outs = _serve(tmp_path, "dptp", spec, sd, 4, [("reconstruct", img, 5)],
                  num_devices=4, model_parallel=2, buckets=(4,))
    np.testing.assert_allclose(outs[0]["answers"][0][0], _jax_recon(spec, params, img, 5, 4),
                               atol=ATOL)
    assert any(k.startswith("dit.") for k in outs[0]["layout"])
    assert [o["groups"]["data_index"] for o in outs] == [0, 0, 1, 1]


def test_int8_tp_engine_runs(case, tmp_path):
    """int8 at tp=2: the weights quantized whole and sharded like the
    weights they replace, the int32 products summed over the model axis
    first: the one-process int8 engine's answer."""
    spec, params, sd = case
    img = _images(2, 2)
    ref = InferenceEngine(port_spec(spec), port_modules(spec, params), device="cpu",
                          num_steps=STEPS, buckets=(2,), quant="int8")
    outs = _serve(tmp_path, "int8", spec, sd, 2, [("reconstruct", img, 1)],
                  num_devices=2, model_parallel=2, buckets=(2,), quant="int8")
    want = ref.reconstruct(img, seed=1)
    np.testing.assert_allclose(outs[0]["answers"][0][0], want, atol=ATOL)
    plain = _jax_recon(spec, params, img, 1, 2)
    assert np.abs(want - plain).max() > 10 * ATOL          # int8 is really on


def test_model_parallel_alone_implies_devices(case, tmp_path):
    spec, params, sd = case
    img = _images(2, 3)
    outs = _serve(tmp_path, "mp", spec, sd, 2, [("reconstruct", img, 7)],
                  model_parallel=2, buckets=(2,))
    assert outs[0]["groups"]["model_group"] == [0, 1]
    np.testing.assert_allclose(outs[0]["answers"][0][0], _jax_recon(spec, params, img, 7, 2),
                               atol=ATOL)


def test_buckets_round_up_to_data_axis(case, tmp_path):
    """Buckets (1, 4) on 2 data ranks become (2, 4); a one-image request
    pads to the rounded bucket and answers JAX's."""
    spec, params, sd = case
    img = _images(1, 4)
    outs = _serve(tmp_path, "round", spec, sd, 2, [("reconstruct", img, 0)],
                  num_devices=2, buckets=(1, 4))
    assert outs[0]["buckets"] == [2, 4] == outs[1]["buckets"]
    out = outs[0]["answers"][0][0]
    assert out.shape == (1, 32, 32, 3) and np.isfinite(out).all()
    np.testing.assert_allclose(out, _jax_recon(spec, params, img, 0, 2), atol=ATOL)
