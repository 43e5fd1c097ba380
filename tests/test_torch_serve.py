"""The ported serving slice against the JAX package, on the CPU.

* ``embed`` of the tiny port engine equals the JAX ``InferenceEngine.embed``;
* ``reconstruct``'s device program on injected NHWC noise equals the JAX
  composition of genhancer_tpu/serve/engine.py (tower -> projectors -> Euler
  DiT -> VAE decode -> clamp -> uint8) on the same noise, at both wires;
* bucket padding, oversize rejection and the unported options (int8
  serving is held in tests/test_torch_serve_int8.py, the AE loader in
  tests/test_torch_vae_loader.py);
* an HTTP round trip on an ephemeral port.

Tolerances: float32 compute on bf16 DiT weights (the JAX serving test's
setting) — 1e-4 for embeddings and float pixels (summation order over a few
composed layers); uint8 pixels may differ by one step where a float value
lies within that noise of a rounding boundary.
"""

import io
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genhancer_tpu.models import dit as jdit
from genhancer_tpu.models import vae as jvae
from genhancer_tpu.serve.engine import InferenceEngine as JaxEngine
from genhancer_tpu.tasks import conditioning as jcond
from genhancer_tpu.train import flow as jflow
from genhancer_tpu_torch.core.kernels.short_attention import LAUNCHES
from genhancer_tpu_torch.serve.engine import InferenceEngine, resolve_device
from genhancer_tpu_torch.serve.http import ServeApp

from test_torch_parity import f32, jax_params, jax_spec, port_modules, port_spec, t

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def spec():
    return jax_spec()


@pytest.fixture(scope="module")
def params(spec):
    return jax_params(spec, seed=0)


def make_engine(spec, params, **kw):
    kw.setdefault("buckets", (1, 4))
    kw.setdefault("num_steps", 2)
    return InferenceEngine(port_spec(spec), port_modules(spec, params), device="cpu", **kw)


@pytest.fixture(scope="module")
def engine(spec, params):
    return make_engine(spec, params)


def jax_reconstruct(spec, params, image01, noise, num_steps, guidance, wire):
    """genhancer_tpu/serve/engine.py's recon program with the noise given."""
    cond = jcond.image_conditioning(spec.tower_kind, params["clip"], image01,
                                    spec.tower_cfg, spec.latent_hw,
                                    compute_dtype=spec.compute_dtype)
    lat_h, lat_w = spec.latent_hw
    timesteps = jflow.get_schedule(num_steps, (lat_h // 2) * (lat_w // 2), shift=True)
    img = jdit.pack_latent(noise).astype(spec.compute_dtype)

    def model_fn(x, t_vec, g_vec):
        return jdit.dit_forward(params["dit"], spec.dit_cfg, img=x,
                                img_ids=cond["img_ids"], txt=cond["txt"].astype(x.dtype),
                                txt_ids=cond["txt_ids"], timesteps=t_vec,
                                y=cond["vec"].astype(x.dtype), guidance=g_vec)

    tokens = jflow.denoise_euler(model_fn, img, timesteps, guidance)
    lat = jdit.unpack_latent(tokens.astype(jnp.float32), lat_h, lat_w)
    out = jnp.clip(jvae.vae_decode(params["vae"], spec.vae_cfg, lat) * 0.5 + 0.5, 0.0, 1.0)
    if wire == "uint8":
        out = jnp.round(out * 255.0).astype(jnp.uint8)
    return np.asarray(out)


class TestParity:
    def test_embed_matches_jax_engine(self, spec, params, engine):
        jeng = JaxEngine(spec, jax.tree_util.tree_map(jnp.asarray, params),
                         num_steps=2, buckets=(1, 4))
        img = np.random.default_rng(0).random((3, 32, 32, 3), dtype=np.float32)
        ours = engine.embed(img)
        assert ours.shape == (3, 24) and ours.dtype == np.float32
        np.testing.assert_allclose(ours, jeng.embed(img), rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("wire", ["float32", "uint8"])
    def test_reconstruct_on_injected_noise(self, spec, params, wire):
        eng = make_engine(spec, params, wire_dtype=wire, num_steps=3)
        rng = np.random.default_rng(1)
        img_u8 = (rng.random((2, 32, 32, 3)) * 255).astype(np.uint8)
        lat_h, lat_w = spec.latent_hw
        noise = rng.standard_normal((2, lat_h, lat_w, spec.vae_cfg.z_channels),
                                    dtype=np.float32)
        batch = eng._wire(img_u8)
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        ours = eng._recon(eng._place(batch), t(noise)).numpy()
        assert LAUNCHES == {"fused_rope_attention": 0, "fused_attention": 0,
                            "fused_rope_attention_bwd": 0, "fused_attention_bwd": 0}
        ref = jax_reconstruct(spec, params, jnp.asarray(batch).astype(jnp.float32) / 255.0
                              if wire == "uint8" else jnp.asarray(batch),
                              jnp.asarray(noise), 3, eng.guidance, wire)
        assert ours.shape == (2, 32, 32, 3) and ours.dtype == ref.dtype
        if wire == "uint8":
            diff = np.abs(ours.astype(np.int32) - ref.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 0.01, (diff.max(), (diff > 0).mean())
        else:
            np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


class TestEngine:
    def test_padding_matches_exact_bucket(self, engine):
        img = np.random.default_rng(2).random((4, 32, 32, 3), dtype=np.float32)
        full = engine.reconstruct(img, seed=7)
        part = engine.reconstruct(img[:3], seed=7)
        assert part.shape == (3, 32, 32, 3)
        np.testing.assert_allclose(part, full[:3], atol=1e-5)
        np.testing.assert_allclose(engine.embed(img[:1])[0], engine.embed(img)[0], atol=1e-5)

    def test_oversize_batch_rejected(self, engine):
        with pytest.raises(ValueError, match="exceeds max bucket"):
            engine.reconstruct(np.zeros((5, 32, 32, 3), np.float32))

    def test_seedless_calls_differ_and_stay_in_range(self, engine):
        img = np.random.default_rng(3).random((1, 32, 32, 3), dtype=np.float32)
        a, b = engine.reconstruct(img), engine.reconstruct(img)
        assert np.abs(a - b).max() > 1e-6
        assert a.min() >= 0.0 and a.max() <= 1.0 and np.isfinite(a).all()

    def test_uint8_wire_returns_uint8(self, spec, params):
        eng = make_engine(spec, params, wire_dtype="uint8", buckets=(2,))
        out = eng.reconstruct(np.random.default_rng(4).random((1, 32, 32, 3), dtype=np.float32),
                              seed=1)
        assert out.dtype == np.uint8 and out.shape == (1, 32, 32, 3)
        assert eng.embed(np.zeros((2, 32, 32, 3), np.uint8)).dtype == np.float32

    @pytest.mark.parametrize("kw, exc, match", [
        ({"wire_dtype": "bf16"}, ValueError, "wire_dtype"),
        ({"quant": "fp8"}, ValueError, "quant"),
        # several devices outside a process group of that size: torchrun
        # starts one process per card (tests/test_torch_serve_mesh.py)
        ({"num_devices": 2}, ValueError, "torchrun"),
        ({"model_parallel": 2}, ValueError, "torchrun"),
    ])
    def test_unported_and_bad_options_raise(self, spec, params, kw, exc, match):
        with pytest.raises(exc, match=match):
            make_engine(spec, params, **kw)

    def test_cuda_refused_without_a_gpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")
        assert resolve_device("cpu").type == "cpu"

    def test_build_spec_matches_jax(self):
        """The MetaCLIP-L stage-1 config maps to the same model configs."""
        import dataclasses
        from genhancer_tpu.tasks.factory import build_spec as jax_build_spec
        from genhancer_tpu.train.config import load_config as jax_load_config
        from genhancer_tpu_torch.tasks.factory import build_spec
        from genhancer_tpu_torch.train.config import load_config
        path = "configs/MetaCLIP_large_stage1.yaml"
        ours, kind, ckpt = build_spec(load_config(path))
        ref, rkind, rckpt = jax_build_spec(jax_load_config(path))
        assert (kind, ckpt) == (rkind, rckpt) == ("clip", "image")
        for f in ("dit_cfg", "vae_cfg", "tower_cfg"):
            assert dataclasses.asdict(getattr(ours, f)) == dataclasses.asdict(getattr(ref, f))
        for f in ("img_size", "clip_image_size", "clip_dim", "t5_dim", "guidance", "latent_hw"):
            assert getattr(ours, f) == getattr(ref, f), f
        assert ours.compute_dtype == ours.dit_param_dtype == torch.bfloat16

    @pytest.mark.parametrize("override, error, match", [
        # video stage 2 takes the latent cache; a features cache there is
        # refused, with JAX's message (tests/test_torch_precompute.py)
        pytest.param({"task": "video_middle_stage2_all", "data_config": {"precomputed": True}},
                     ValueError, "stage-1 only", id="override0-not ported"),
        # SigLIP and its int8 tower are ported: the spec is JAX's
        pytest.param({"tower": "siglip", "clip_config": {"clip_image_size": 384},
                      "tower_quant": "int8"}, None, "siglip",
                     id="override1-siglip"),
    ])
    def test_unported_config_paths_raise(self, override, error, match):
        from genhancer_tpu_torch.tasks.factory import build_spec
        from genhancer_tpu_torch.train.config import load_config
        cfg = load_config("configs/MetaCLIP_large_stage1.yaml").merged_with(override)
        if error is None:
            from genhancer_tpu.tasks.factory import build_spec as jax_build_spec
            from genhancer_tpu.train.config import load_config as jax_load_config
            ours = build_spec(cfg)[0]
            ref = jax_build_spec(jax_load_config("configs/MetaCLIP_large_stage1.yaml")
                                 .merged_with(override))[0]
            assert (ours.tower_kind, ours.tower_quant) == (ref.tower_kind, ref.tower_quant) \
                == (match, "int8")
            return
        with pytest.raises(error, match=match):
            build_spec(cfg)
        if error is ValueError:     # the same path with the latent cache runs
            latents = cfg.merged_with({"data_config": {"precomputed": "latents"}})
            assert build_spec(latents)[0].stage == "stage2_all"

    @pytest.mark.parametrize("name", ["SigLIP_384_stage1", "SigLIP_384_stage2_all",
                                      "SigLIP_384_stage2_only"])
    def test_siglip_config_specs_match_jax(self, name):
        """The published SigLIP configs: the same spec as JAX's ``build_spec``
        (so400m at 384 px, 1152-d class tokens into the projectors, SigLIP's
        six LoRA targets)."""
        import dataclasses
        from genhancer_tpu.tasks.factory import build_spec as jax_build_spec
        from genhancer_tpu.train.config import load_config as jax_load_config
        from genhancer_tpu_torch.models.towers.siglip import SiglipVisionConfig
        from genhancer_tpu_torch.tasks.factory import build_spec
        from genhancer_tpu_torch.train.config import load_config
        path = f"configs/{name}.yaml"
        ours, kind, ckpt = build_spec(load_config(path))
        ref, rkind, rckpt = jax_build_spec(jax_load_config(path))
        assert (kind, ckpt) == (rkind, rckpt) == ("siglip", "image")
        for f in ("dit_cfg", "vae_cfg", "tower_cfg"):
            assert dataclasses.asdict(getattr(ours, f)) == dataclasses.asdict(getattr(ref, f))
        for f in ("stage", "img_size", "clip_image_size", "clip_dim", "t5_dim", "guidance",
                  "latent_hw", "tower_hidden", "lora_r", "lora_alpha", "lora_dropout",
                  "lora_targets", "tower_remat"):
            assert getattr(ours, f) == getattr(ref, f), f
        assert ours.tower_cfg.vision == SiglipVisionConfig(image_size=384)
        assert ours.tower_hidden == 1152 and ours.latent_hw == (48, 48)

    def test_model_dir_tower_is_served(self, spec, params, engine, tmp_path, monkeypatch):
        """``clip_config.model_dir``: the engine serves the weights of an HF
        tower directory (the JAX package's ``tower_to_torch`` of the JAX
        tower, text side included), whose ``config.json`` overrides the
        named variant's; its embeddings equal those of the engine holding
        the same tree, and the JAX engine's."""
        import json as json_m
        from genhancer_tpu.weights import hf_convert
        from genhancer_tpu.weights.torch_io import save_torch_state_dict
        from genhancer_tpu_torch import registry
        from genhancer_tpu_torch.models.towers.clip import CLIP_VARIANTS
        from genhancer_tpu_torch.train.config import load_config
        from test_torch_parity import port_cfg
        d = tmp_path / "tower"
        save_torch_state_dict(hf_convert.tower_to_torch(params["clip"]["model"]),
                              str(d / "pytorch_model.bin"))
        (d / "config.json").write_text(json_m.dumps(spec.tower_cfg.to_hf()))
        monkeypatch.setattr(registry, "build_dit_config", lambda name: port_cfg(spec.dit_cfg))
        monkeypatch.setattr(registry, "build_vae_config",
                            lambda name, ae_path=None: port_cfg(spec.vae_cfg))
        cfg = load_config("configs/MetaCLIP_large_stage1.yaml").merged_with(
            {"clip_config": {"model_dir": str(d), "clip_image_size": 32, "clip_dim": 24,
                             "t5_dim": 32},
             "data_config": {"img_size": 32}, "mixed_precision": "no"})
        served = InferenceEngine.from_config(cfg, device="cpu", buckets=(1, 4), num_steps=2)
        assert served.spec.tower_cfg == port_cfg(spec.tower_cfg)
        assert served.spec.tower_cfg != CLIP_VARIANTS["metaclip-l14-fullcc2.5b"]
        img = np.random.default_rng(4).random((3, 32, 32, 3), dtype=np.float32)
        ours = served.embed(img)
        np.testing.assert_array_equal(ours, engine.embed(img))
        jeng = JaxEngine(spec, jax.tree_util.tree_map(jnp.asarray, params),
                         num_steps=2, buckets=(1, 4))
        np.testing.assert_allclose(ours, jeng.embed(img), rtol=1e-4, atol=1e-4)


def test_http_round_trip(engine):
    from PIL import Image
    app = ServeApp(engine, max_wait_ms=200.0)
    server = app.make_server("127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    buf = io.BytesIO()
    rgb = (np.random.default_rng(5).random((40, 48, 3)) * 255).astype(np.uint8)
    Image.fromarray(rgb).save(buf, format="JPEG")
    body = buf.getvalue()
    results = {}

    def post(i, path):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                     headers={"Content-Type": "image/jpeg"})
        with urllib.request.urlopen(req, timeout=120) as r:
            results[(path, i)] = (r.status, r.headers["Content-Type"], r.read())

    try:
        threads = [threading.Thread(target=post, args=(i, p))
                   for i in range(3) for p in ("/v1/reconstruct", "/v1/embed")]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
        assert len(results) == 6
        for (path, _), (status, ctype, data) in results.items():
            assert status == 200
            if path == "/v1/reconstruct":
                assert ctype == "image/jpeg"
                assert Image.open(io.BytesIO(data)).size == (32, 32)
            else:
                emb = json.loads(data)
                assert emb["dim"] == 24 and np.isfinite(emb["embedding"]).all()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/stats", timeout=10) as r:
            stats = json.loads(r.read())
        for ep in ("reconstruct", "embed"):
            assert stats[ep]["requests"] == 3 and stats[ep]["errors"] == 0
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            assert json.loads(r.read())["buckets"] == [1, 4]
    finally:
        app.close()
        thread.join(timeout=10)
    assert not thread.is_alive()
