"""The FLUX AE loader (``ae_path`` / ``$AE``) against the JAX package, on
the CPU.

The file is JAX's own export, ``hf_convert.vae_to_torch(init_vae(...))``,
written as ``.safetensors`` by ``write_safetensors`` below (the format's
8-byte header length, JSON header and raw bytes; no package beyond numpy).
The port loads it through ``registry.load_vae`` — directly, through
``build_spec`` + ``init_modules`` (the trainer's, the precompute CLI's and
the eval's path) and through ``InferenceEngine.from_config`` — and its
encode and decode equal JAX's ``load_vae_params`` of the same file at 1e-5.
A path naming no file logs a warning and leaves the random init, as JAX's
``build_vae`` does.
"""

import json
import logging
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genhancer_tpu.models import vae as jvae
from genhancer_tpu.weights import hf_convert
from genhancer_tpu_torch import registry
from genhancer_tpu_torch.core.nn import init_weights
from genhancer_tpu_torch.models import vae as tvae

from test_torch_parity import TINY_DIT, TINY_VAE, f32, port_cfg

torch.set_num_threads(1)

_ST_NAMES = {"float32": "F32", "float16": "F16", "bfloat16": "BF16", "int64": "I64",
             "int32": "I32", "int8": "I8", "uint8": "U8"}


def write_safetensors(sd, path) -> None:
    """``{name: numpy array}`` -> a ``.safetensors`` file."""
    header, blobs, off = {}, [], 0
    for name in sorted(sd):
        a = np.ascontiguousarray(np.asarray(sd[name]))
        raw = a.tobytes()
        header[name] = {"dtype": _ST_NAMES[a.dtype.name], "shape": list(a.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + b"".join(blobs))


def close(got, want, bound=1e-5):
    got, want = f32(got), f32(want)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= bound, (err, bound)


@pytest.fixture(scope="module")
def ae_file(tmp_path_factory):
    tree = jax.device_get(jvae.init_vae(jax.random.key(3), TINY_VAE))
    path = tmp_path_factory.mktemp("ae") / "ae.safetensors"
    write_safetensors(hf_convert.vae_to_torch(tree), str(path))
    return str(path)


def port_vae(seed=0):
    return init_weights(tvae.AutoEncoder(port_cfg(TINY_VAE)), torch.Generator().manual_seed(seed))


def check_against_jax(vae, ae_file):
    params = hf_convert.load_vae_params(ae_file)
    rng = np.random.default_rng(4)
    x = rng.random((2, 32, 32, 3), dtype=np.float32) * 2 - 1
    z = rng.standard_normal((2, 8, 8, 4), dtype=np.float32)
    with torch.no_grad():
        enc = tvae.vae_encode(vae, port_cfg(TINY_VAE), torch.from_numpy(x), sample=False)
        dec = tvae.vae_decode(vae, port_cfg(TINY_VAE), torch.from_numpy(z))
    close(enc, jvae.vae_encode(params, TINY_VAE, jnp.asarray(x), sample=False))
    close(dec, jvae.vae_decode(params, TINY_VAE, jnp.asarray(z)))


def test_load_vae_matches_jax(ae_file):
    assert registry.vae_weights_path(ae_file) == ae_file
    vae = registry.load_vae(port_vae(), ae_file)
    check_against_jax(vae, ae_file)


def test_missing_path_warns_and_keeps_the_random_init(tmp_path, caplog, monkeypatch):
    monkeypatch.delenv("AE", raising=False)
    assert registry.vae_weights_path(None) is None
    with caplog.at_level(logging.WARNING, logger="genhancer_tpu_torch.registry"):
        assert registry.vae_weights_path(str(tmp_path / "none.safetensors")) is None
    assert "not found" in caplog.text and "random-init VAE" in caplog.text
    monkeypatch.setenv("AE", str(tmp_path / "gone.safetensors"))
    assert registry.vae_weights_path(None) is None


@pytest.mark.parametrize("how", ["ae_path", "AE"])
def test_config_paths_load_the_file(ae_file, how, monkeypatch, tmp_path):
    """``ae_path`` or ``$AE`` -> ``build_spec`` -> ``init_modules`` (the
    trainer, the precompute CLI and the eval build their VAE there) and
    ``InferenceEngine.from_config``; a missing file gives the same modules
    as no path at all."""
    from genhancer_tpu_torch.serve.engine import InferenceEngine
    from genhancer_tpu_torch.tasks import factory
    from genhancer_tpu_torch.tasks.image import init_modules
    from genhancer_tpu_torch.train.config import load_config
    from test_torch_parity import TINY_TOWER
    monkeypatch.setattr(registry, "build_dit_config", lambda name: port_cfg(TINY_DIT))
    monkeypatch.setattr(registry, "build_vae_config",
                        lambda name, ae_path=None: port_cfg(TINY_VAE))
    monkeypatch.setattr(registry, "tower_family_and_config",
                        lambda *a: ("clip", port_cfg(TINY_TOWER)))
    monkeypatch.delenv("AE", raising=False)
    base = load_config("configs/MetaCLIP_large_stage1.yaml").merged_with(
        {"clip_config": {"clip_image_size": 32, "clip_dim": 24, "t5_dim": 32},
         "data_config": {"img_size": 32}, "mixed_precision": "no"})
    if how == "AE":
        monkeypatch.setenv("AE", ae_file)
        cfg = base
    else:
        cfg = base.merged_with({"ae_path": ae_file})
    spec = factory.build_spec(cfg)[0]
    assert spec.vae_path == ae_file
    mods = init_modules(spec, torch.Generator().manual_seed(0))
    check_against_jax(mods["vae"], ae_file)
    engine = InferenceEngine.from_config(cfg, device="cpu", buckets=(1,), num_steps=1)
    for k, v in mods["vae"].state_dict().items():
        assert torch.equal(engine.modules["vae"].state_dict()[k], v), k

    monkeypatch.delenv("AE", raising=False)
    missing = base.merged_with({"ae_path": str(tmp_path / "missing.safetensors")})
    spec_m = factory.build_spec(missing)[0]
    assert spec_m.vae_path is None
    rand = init_modules(spec_m, torch.Generator().manual_seed(0))["vae"].state_dict()
    plain = init_modules(factory.build_spec(base)[0],
                         torch.Generator().manual_seed(0))["vae"].state_dict()
    assert all(torch.equal(rand[k], plain[k]) for k in plain)
    assert not all(torch.equal(rand[k], mods["vae"].state_dict()[k]) for k in plain)


def test_a_file_that_does_not_fit_is_refused(ae_file, tmp_path):
    """The load is strict: another VAE's file raises, never half-loads."""
    small = tvae.AutoEncoder(tvae.VAEConfig(resolution=32, ch=8, ch_mult=(1,),
                                            num_res_blocks=1, z_channels=4))
    with pytest.raises(RuntimeError):
        registry.load_vae(small, ae_file)
