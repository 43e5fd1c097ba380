"""The port's LoRA (genhancer_tpu_torch/train/lora.py, the branch of
core/nn.py ``linear``, its dropout) against the JAX package's
(genhancer_tpu/train/lora.py, genhancer_tpu/core/nn.py), and the port's
HF file readers (weights/hf_io.py).

The wrapped set and the trainable paths must be the JAX lists exactly, on
a tiny tower, at MetaCLIP-L/14 width and on the whole SigLIP so400m with
``SIGLIP_TARGETS`` (the JAX side by ``jax.eval_shape``, the port on the meta
device).  The branch is held with a nonzero B (with
B = 0 it adds nothing and dA is 0) and an alpha/r that bfloat16 cannot
hold (16/3): float32 at 1e-6 relative, bfloat16 bit for bit.  Dropout runs
on the masks JAX draws (``fold_in(key, call)`` + ``bernoulli``, as
``_lora_dropout`` does), injected into the port.  ``merge`` at 1e-6.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genhancer_tpu.core import nn as jnn
from genhancer_tpu.models.towers import clip as jclip
from genhancer_tpu.models.towers import siglip as jsiglip
from genhancer_tpu.train import lora as jlora
from genhancer_tpu_torch.core import nn
from genhancer_tpu_torch.models.towers import clip as tclip
from genhancer_tpu_torch.models.towers import siglip as tsiglip
from genhancer_tpu_torch.train import lora
from genhancer_tpu_torch.weights import hf_io
from genhancer_tpu_torch.weights.convert import tower_state_dict

from test_torch_parity import TINY_TOWER, f32, port_cfg, t

torch.set_num_threads(1)


def _jax_inject_shapes(cfg, targets):
    """JAX ``inject`` on ``init_clip`` (``init_siglip``) traced by
    eval_shape: (tree of ShapeDtypeStructs, wrapped list,
    lora_trainable_paths)."""
    out = {}
    init = jsiglip.init_siglip if isinstance(cfg, jsiglip.SiglipConfig) else jclip.init_clip

    def f(k):
        tree, wrapped = jlora.inject(init(k, cfg), k, targets=targets)
        out["wrapped"], out["paths"] = wrapped, jlora.lora_trainable_paths(tree)
        return tree

    shapes = jax.eval_shape(f, jax.random.key(0))
    return shapes, out["wrapped"], out["paths"]


@pytest.mark.parametrize("width, targets", [("tiny", "all-linear"),
                                            ("tiny", lora.SIGLIP_TARGETS),
                                            ("metaclip-l14", "all-linear"),
                                            ("so400m", lora.SIGLIP_TARGETS)])
def test_wrapped_set_matches_jax(width, targets):
    jcfg = {"tiny": TINY_TOWER, "metaclip-l14": jclip.CLIP_VARIANTS["metaclip-l14-fullcc2.5b"],
            "so400m": jsiglip.SIGLIP_VARIANTS["siglip-so400m-patch14-384"]}[width]
    shapes, wrapped, paths = _jax_inject_shapes(jcfg, targets)
    cls = tsiglip.SiglipModel if width == "so400m" else tclip.CLIPModel
    tower = cls(port_cfg(jcfg), device="meta")
    _, ours = lora.inject(tower, None, targets=targets)
    assert ours == wrapped and lora.wrapped_paths(tower) == wrapped
    assert lora.lora_trainable_paths(tower) == paths
    flat = dict(tower.state_dict())
    for path in wrapped:
        node = shapes
        for part in path.split("."):
            node = node[int(part)] if isinstance(node, list) else node[part]
        for name in ("lora_A", "lora_B", "lora_scale"):
            ref = node[name]
            assert tuple(flat[f"{path}.{name}"].shape) == ref.shape, (path, name)
            assert str(flat[f"{path}.{name}"].dtype) == f"torch.{ref.dtype}", (path, name)
    if width == "metaclip-l14":
        n_vision = sum(p.startswith("vision_model.") or p == "visual_projection"
                       for p in wrapped)
        n_par = sum(tower.get_parameter(p).numel() for p in paths)
        assert (len(wrapped), n_vision, len(paths), n_par) == (218, 145, 652, 10_089_472)
    if width == "so400m":
        # 27 x 6 a side and the head's out_proj, fc1, fc2; never the head's
        # in_proj (its key is not ``weight``) nor text_model.head
        n_vision = sum(p.startswith("vision_model.") for p in wrapped)
        n_par = sum(tower.get_parameter(p).numel() for p in paths)
        assert (len(wrapped), n_vision, len(paths)) == (327, 165, 981)
        assert wrapped[162:165] == ["vision_model.head.attention.out_proj",
                                    "vision_model.head.mlp.fc1", "vision_model.head.mlp.fc2"]
        assert "text_model.head" not in wrapped
        assert n_par == 18_152_112


def test_init_draws_within_the_kaiming_bound():
    """A ~ U(-sqrt(3/in), sqrt(3/in)) in both packages (the JAX draw by
    ``fold_in`` of the path's crc32, the port's from one generator), B = 0,
    scale = alpha/r in the weight's dtype."""
    jcfg = TINY_TOWER
    tree, wrapped = jlora.inject(jclip.init_clip(jax.random.key(0), jcfg),
                                 jax.random.key(1), r=8, alpha=16.0)
    tower = tclip.CLIPModel(port_cfg(jcfg))
    nn.init_weights(tower, torch.Generator().manual_seed(0))
    lora.inject(tower, torch.Generator().manual_seed(1), r=8, alpha=16.0)
    flat = tower_state_dict(jax.device_get(tree), text_side=True)
    for path in wrapped:
        m = tower.get_submodule(path)
        bound = (3.0 / m.weight.shape[1]) ** 0.5
        ja, pa = f32(flat[f"{path}.lora_A"]), f32(m.lora_A)
        for a in (ja, pa):
            assert np.abs(a).max() <= bound and np.abs(a).max() > 0.5 * bound, path
        assert m.lora_A.dtype == torch.float32 and not m.lora_B.any()
        assert not f32(flat[f"{path}.lora_B"]).any()
        assert m.lora_scale.item() == float(flat[f"{path}.lora_scale"]) == 2.0


def _branch_params(dtype, rng, out_dim=24, in_dim=40, r=3, alpha=16.0):
    """A wrapped linear, JAX dict and port module, with a nonzero B and
    alpha/r = 16/3 (bf16 rounds it to 5.3125)."""
    w = rng.standard_normal((out_dim, in_dim)).astype(np.float32) / np.sqrt(in_dim)
    p = {"weight": w, "bias": rng.standard_normal(out_dim).astype(np.float32),
         "lora_A": rng.uniform(-0.3, 0.3, (r, in_dim)).astype(np.float32),
         "lora_B": rng.standard_normal((out_dim, r)).astype(np.float32),
         "lora_scale": np.asarray(alpha / r, np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    m = nn.Linear(in_dim, out_dim)
    with torch.no_grad():
        m.weight.copy_(t(w))
        m.bias.copy_(t(p["bias"]))
    m.lora_A = torch.nn.Parameter(t(p["lora_A"]))
    m.lora_B = torch.nn.Parameter(t(p["lora_B"]))
    m.register_buffer("lora_scale", t(p["lora_scale"]))
    return jp, m


def _close(ours, ref, dtype):
    if dtype == "bfloat16":
        np.testing.assert_array_equal(f32(ours), f32(ref))
    else:
        np.testing.assert_allclose(f32(ours), f32(ref), rtol=1e-6,
                                   atol=1e-6 * np.abs(f32(ref)).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_branch_matches_jax(dtype):
    rng = np.random.default_rng(0)
    jp, m = _branch_params(dtype, rng)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    x = rng.standard_normal((2, 7, 40)).astype(np.float32)
    jx = jnp.asarray(x).astype(jdt)
    tx = t(np.asarray(jx))
    y, vjp = jax.vjp(lambda p, x: jnn.linear(p, x), jp, jx)
    ours = nn.linear(m, tx.requires_grad_(True))
    _close(ours, y, dtype)
    if dtype == "float32":
        g = rng.standard_normal(y.shape).astype(np.float32)
        jg, jgx = vjp(jnp.asarray(g))
        ours.backward(t(g))
        for name in ("lora_A", "lora_B", "bias"):
            ref = np.asarray(jg[name])
            assert np.abs(ref).max() > 0, name      # B != 0: the branch is seen
            _close(getattr(m, name).grad, ref, dtype)
        _close(tx.grad, jgx, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_on_the_jax_masks(dtype):
    """Two wrapped calls inside ``lora_dropout_ctx`` (rate 0.1): the port
    with the masks of ``fold_in(key, 1)``, ``fold_in(key, 2)`` injected
    equals JAX; the division by keep_p rounded to bf16 (0.8984375) shows."""
    rng = np.random.default_rng(1)
    jp, m = _branch_params(dtype, rng)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    xs = [jnp.asarray(rng.standard_normal(s).astype(np.float32)).astype(jdt)
          for s in ((3, 40), (2, 5, 40))]
    key = jax.random.key(5)
    with jnn.lora_dropout_ctx(key, 0.1):
        refs = [jnn.linear(jp, x) for x in xs]
    masks = [t(np.asarray(jax.random.bernoulli(jax.random.fold_in(key, i + 1), 0.9, x.shape)))
             for i, x in enumerate(xs)]
    assert all(0 < (~mk).sum() < mk.numel() for mk in masks)
    with nn.lora_dropout_ctx(None, 0.1, masks):
        ours = [nn.linear(m, t(np.asarray(x))) for x in xs]
    for o, r in zip(ours, refs):
        _close(o, r, dtype)
    with torch.no_grad():
        plain = nn.linear(m, t(np.asarray(xs[0])))
    assert not torch.equal(plain, ours[0])          # the masks did drop
    if dtype == "bfloat16":
        # keep_p taken in float32 instead (0.9) would move the kept inputs
        x = t(np.asarray(xs[0]))
        assert not torch.equal(x / nn._device_scalar(0.9, x.dtype, x.device),
                               (x.float() / 0.9).to(x.dtype))


def test_merge_matches_jax():
    rng = np.random.default_rng(2)
    jcfg = TINY_TOWER
    tree, wrapped = jlora.inject(jclip.init_clip(jax.random.key(0), jcfg),
                                 jax.random.key(1), r=4, alpha=16.0)
    tree = jax.device_get(tree)
    for path in wrapped:            # a nonzero B everywhere
        node = tree
        for part in path.split("."):
            node = node[int(part)] if isinstance(node, list) else node[part]
        node["lora_B"] = rng.standard_normal(node["lora_B"].shape).astype(np.float32)
    tower = tclip.CLIPModel(port_cfg(jcfg))
    lora.inject(tower, None, r=4, alpha=16.0)
    sd = tower_state_dict(tree, text_side=True)
    tower.load_state_dict(sd, strict=True)
    merged = lora.merge(tower)
    ref = tower_state_dict(jax.device_get(jlora.merge(tree)), text_side=True)
    got = merged.state_dict()
    assert set(got) == set(ref) and not any("lora" in k for k in got)
    for k, v in ref.items():
        np.testing.assert_allclose(f32(got[k]), f32(v), rtol=1e-6,
                                   atol=1e-6 * max(np.abs(f32(v)).max(), 1e-30), err_msg=k)
    # the training tower keeps its factors and its base weights
    assert lora.wrapped_paths(tower) == wrapped
    for k, v in sd.items():
        assert torch.equal(tower.state_dict()[k], v), k


def _reference_dict():
    g = torch.Generator().manual_seed(0)
    return {"w.f32": torch.randn((3, 5), generator=g),
            "w.bf16": torch.randn(7, generator=g).to(torch.bfloat16),     # odd: 14 bytes
            "w.f16": torch.randn((2, 3), generator=g).to(torch.float16),
            "ids.i64": torch.arange(5, dtype=torch.int64),
            "codes.i8": torch.randint(-128, 127, (4, 4), generator=g, dtype=torch.int8),
            "bytes.u8": torch.randint(0, 255, (3,), generator=g, dtype=torch.uint8),
            "mask.bool": torch.tensor([True, False, True]),
            "scalar": torch.tensor(2.6592),
            "empty": torch.zeros((0, 4))}


@pytest.mark.parametrize("layout", ["pytorch_model.bin", "model.safetensors",
                                    "model.safetensors.index.json",
                                    "pytorch_model.bin.index.json"])
def test_hf_dir_readers(tmp_path, layout):
    """``load_hf_dir_state_dict`` on each HF layout; the ``.safetensors``
    files written by the ``safetensors`` package and read by hand."""
    st = pytest.importorskip("safetensors.torch") if "safetensors" in layout else None
    ref = _reference_dict()
    if layout == "pytorch_model.bin":
        hf_io.save_state_dict(ref, str(tmp_path / layout))
    elif layout == "model.safetensors":
        st.save_file(ref, str(tmp_path / layout))
    else:
        keys = sorted(ref)
        shards = {f"part-{i}.{'safetensors' if st else 'bin'}": keys[i::2] for i in range(2)}
        for name, ks in shards.items():
            sub = {k: ref[k] for k in ks}
            if st:
                st.save_file(sub, str(tmp_path / name))
            else:
                hf_io.save_state_dict(sub, str(tmp_path / name))
        (tmp_path / layout).write_text(json.dumps(
            {"weight_map": {k: name for name, ks in shards.items() for k in ks}}))
    got = hf_io.load_hf_dir_state_dict(str(tmp_path))
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k


def test_safetensors_reader_refuses_a_truncated_file(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    path = str(tmp_path / "model.safetensors")
    st.save_file({"w": torch.ones(16)}, path)
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:-8])
    with pytest.raises(ValueError, match="offsets"):
        hf_io.load_safetensors(path)
    os.remove(path)
    with pytest.raises(FileNotFoundError, match="no weights"):
        hf_io.load_hf_dir_state_dict(str(tmp_path))
