"""MMVP-VLM evaluation and reconstruction of the port against the JAX
package (genhancer_tpu/models/towers/{encoder,clip}.py, eval/mmvp.py,
eval/reconstruct.py, cli/verify_weights.py, registry.load_tower) at tiny
widths.

The JAX tower's weights are carried into the port's ``CLIPModel`` by
``weights/convert.py``; images, ids and the reconstruction noise are made
with NumPy from a seed and handed to both.  Bounds: float32 1e-5 on the
text forward, the features and the logits; the ``evaluate`` result dicts
and the CSV rows equal, their scores within 1e-5; the reconstruction
within 1e-4.  A float16 HF directory loads as float16 in both packages, bit
for bit, and one forward of each agrees within 1e-3.
"""

import csv
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genhancer_tpu import registry as jregistry
from genhancer_tpu.eval import mmvp as jmmvp
from genhancer_tpu.eval import reconstruct as jrecon
from genhancer_tpu.models.towers import clip as jclip
from genhancer_tpu.models.towers import encoder as jenc
from genhancer_tpu.train import lora as jlora
from genhancer_tpu.weights import hf_convert
from genhancer_tpu_torch import registry
from genhancer_tpu_torch.cli import evaluate as cli_evaluate
from genhancer_tpu_torch.cli import reconstruct as cli_reconstruct
from genhancer_tpu_torch.cli import verify_weights
from genhancer_tpu_torch.eval import mmvp
from genhancer_tpu_torch.eval import reconstruct as recon
from genhancer_tpu_torch.models.towers import clip as tclip
from genhancer_tpu_torch.models.towers import encoder as tenc
from genhancer_tpu_torch.train import lora
from genhancer_tpu_torch.train.trainer import Trainer, hf_export_name
from genhancer_tpu_torch.weights.convert import tower_state_dict

from test_torch_parity import TINY_TOWER, f32, jax_params, jax_spec, port_cfg, port_modules
from test_torch_train_e2e import shards, tiny_models, write_cfg  # noqa: F401 (fixtures)

torch.set_num_threads(1)

# two layers on each side, 12 text positions, eos 49 (the first-EOS rule)
TOWER = jclip.CLIPConfig(
    vision=jclip.CLIPVisionConfig(hidden_size=16, intermediate_size=32, num_layers=2,
                                  num_heads=2, image_size=32, patch_size=16),
    text=jclip.CLIPTextConfig(hidden_size=16, intermediate_size=32, num_layers=2,
                              num_heads=2, vocab_size=50, max_position_embeddings=12,
                              eos_token_id=49),
    projection_dim=24)


@pytest.fixture(scope="module")
def jax_tower():
    """One JAX ``init_clip`` of TOWER for the file, as numpy leaves."""
    return jax.device_get(jclip.init_clip(jax.random.key(0), TOWER))


def _port_tower(tree, cfg=TOWER):
    model = tclip.CLIPModel(port_cfg(cfg))
    model.load_state_dict(tower_state_dict(tree, text_side=True), strict=True)
    return model.eval().requires_grad_(False)


def _ids(rng, n, length, eos):
    """Random ids below the vocabulary's top with an EOS per row (and a
    second one later in row 0, which the first-EOS rule must skip)."""
    ids = rng.integers(3, 48, (n, length)).astype(np.int64)
    for i in range(n):
        ids[i, 4 + i % (length - 5)] = eos
    ids[0, -1] = eos
    return ids


def fake_tokenize(texts, length=12):
    """``tests/test_mmvp.py``'s toy tokenizer: characters hashed into ids,
    id 2 at the end."""
    ids = np.full((len(texts), length), 1, dtype=np.int64)
    for i, t in enumerate(texts):
        for j, ch in enumerate(t[: length - 1]):
            ids[i, j] = 3 + (ord(ch) % 40)
        ids[i, min(len(t), length - 1)] = 2
    return ids, None


def write_benchmark(root, pairs_per_category=2, size=40, seed=0):
    """A synthetic MMVP-VLM tree: ``Questions.csv`` + ``MLLM_VLM Images/
    {category}/{qid}.jpg`` for the nine categories."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    rows, qid = [["qid", "type", "statement"]], 1
    for cat in mmvp.CATEGORIES:
        d = os.path.join(root, "MLLM_VLM Images", cat)
        os.makedirs(d, exist_ok=True)
        for _ in range(pairs_per_category):
            for q in (qid, qid + 1):
                arr = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
                Image.fromarray(arr).save(os.path.join(d, f"{q}.jpg"))
                rows.append([str(q), cat, f"statement {q} of {cat}"])
            qid += 2
    with open(os.path.join(root, "Questions.csv"), "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return str(root)


def _read_csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def assert_same_results(ours, ref, ours_csv, ref_csv):
    """Equal result dicts; equal CSV rows but for the two scores, which agree
    within 1e-5."""
    assert ours == ref
    a, b = _read_csv(ours_csv), _read_csv(ref_csv)
    assert len(a) == len(b) and a[0] == b[0]
    for ra, rb in zip(a[1:], b[1:]):
        assert ra[:6] == rb[:6]
        np.testing.assert_allclose([float(x) for x in ra[6:]], [float(x) for x in rb[6:]],
                                   rtol=0, atol=1e-5)


# ---------------------------------------------------------------- the text side

def test_masks_match_jax():
    np.testing.assert_array_equal(tenc.causal_mask(7).numpy(),
                                  np.asarray(jenc.causal_mask(7)))
    am = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.int64)
    np.testing.assert_array_equal(tenc.padding_mask(torch.from_numpy(am)).numpy(),
                                  np.asarray(jenc.padding_mask(jnp.asarray(am))))


@pytest.mark.parametrize("eos", [49, 2])
@pytest.mark.parametrize("padded", [False, True])
def test_text_side_and_logits_match_jax(jax_tower, eos, padded):
    """text_forward (last state and EOS-pooled output), get_text_features,
    get_image_features and clip_logits at float32 1e-5; eos 2 pools at the
    argmax of the ids, any other at the first EOS."""
    cfg = dataclasses.replace(TOWER, text=dataclasses.replace(TOWER.text, eos_token_id=eos))
    model = _port_tower(jax_tower, cfg)
    pcfg = port_cfg(cfg)
    rng = np.random.default_rng(1)
    ids = _ids(rng, 3, 12, eos)
    am = np.ones_like(ids)
    if padded:
        am[1, 9:] = 0
        am[2, 6:] = 0
    px = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    jmask, pmask = (jnp.asarray(am), torch.from_numpy(am)) if padded else (None, None)

    jlast, jpool = jclip.text_forward(jax_tower["text_model"], jnp.asarray(ids), cfg.text,
                                      jmask)
    with torch.no_grad():
        last, pool = tclip.text_forward(model.text_model, torch.from_numpy(ids), pcfg.text,
                                        pmask)
        pairs = [(last, jlast), (pool, jpool),
                 (tclip.get_text_features(model, torch.from_numpy(ids), pcfg, pmask),
                  jclip.get_text_features(jax_tower, jnp.asarray(ids), cfg, jmask)),
                 (tclip.get_image_features(model, torch.from_numpy(px), pcfg),
                  jclip.get_image_features(jax_tower, jnp.asarray(px), cfg))]
        ours = tclip.clip_logits(model, torch.from_numpy(ids), torch.from_numpy(px), pcfg,
                                 pmask)
    ref = jclip.clip_logits(jax_tower, jnp.asarray(ids), jnp.asarray(px), cfg, jmask)
    pairs += list(zip(ours, ref))
    for got, want in pairs:
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # the pooled row: argmax of the ids for eos 2, else the first EOS
    pos = ids.argmax(-1) if eos == 2 else (ids == eos).argmax(-1)
    np.testing.assert_array_equal(pool.numpy(), last.numpy()[np.arange(3), pos])


# ---------------------------------------------------------------- the float16 fault

def test_a_float16_directory_loads_as_float16_in_both_packages(tmp_path):
    """Both loaders keep a float16 ``pytorch_model.bin``'s dtype (the port's
    used to widen it to float32): the same dtypes, the same weights bit for
    bit, one forward within 1e-3; the port's LoRA A then takes float16 too,
    as JAX's ``inject`` does."""
    tree = jax.device_get(jclip.init_clip(jax.random.key(3), TINY_TOWER))
    sd = {k: torch.from_numpy(np.asarray(v, np.float32)).half()
          for k, v in hf_convert.tower_to_torch(tree).items()}
    torch.save(sd, str(tmp_path / "pytorch_model.bin"))
    (tmp_path / "config.json").write_text(json.dumps(TINY_TOWER.to_hf()))

    jtree, jcfg = jregistry.load_tower("clip", TINY_TOWER, str(tmp_path))
    model, pcfg = registry.load_tower("clip", port_cfg(TINY_TOWER), str(tmp_path))
    flat = tower_state_dict(jax.device_get(jtree), text_side=True)
    ours = model.state_dict()
    assert set(ours) == set(flat)
    for k, v in flat.items():
        assert ours[k].dtype == v.dtype == torch.float16, k
        assert torch.equal(ours[k], v), k
    px = np.random.default_rng(2).random((2, 32, 32, 3), dtype=np.float32)
    ids = _ids(np.random.default_rng(3), 2, 8, 2)
    with torch.no_grad():
        got = [tclip.get_image_features(model, torch.from_numpy(px), pcfg),
               tclip.get_text_features(model, torch.from_numpy(ids), pcfg)]
    want = [jclip.get_image_features(jtree, jnp.asarray(px), jcfg),
            jclip.get_text_features(jtree, jnp.asarray(ids), jcfg)]
    # float32 pixels keep the vision side in float32; the text side runs in
    # the embedding tables' float16
    for g, w, dt in zip(got, want, (torch.float32, torch.float16)):
        assert g.dtype == dt
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(f32(g), w, rtol=1e-3, atol=1e-3 * np.abs(w).max())
    jwrapped, _ = jlora.inject(jtree, jax.random.key(1), r=4, alpha=16.0)
    lora.inject(model, torch.Generator().manual_seed(1), r=4, alpha=16.0)
    jflat = tower_state_dict(jax.device_get(jwrapped), text_side=True)
    for path in lora.wrapped_paths(model):
        m = model.get_submodule(path)
        for name in ("lora_A", "lora_B", "lora_scale"):
            assert getattr(m, name).dtype == jflat[f"{path}.{name}"].dtype == torch.float16


# ---------------------------------------------------------------- MMVP-VLM

def test_evaluate_matches_jax(jax_tower, tmp_path):
    """Both packages' ``evaluate`` on one tiny tower, one synthetic
    benchmark (9 categories x 2 pairs) and the same token ids."""
    bench = write_benchmark(str(tmp_path / "mmvp"))
    cfg = dataclasses.replace(TOWER, text=dataclasses.replace(TOWER.text, eos_token_id=2))
    model = _port_tower(jax_tower, cfg)
    ours = mmvp.evaluate(model, port_cfg(cfg), "clip", bench, fake_tokenize,
                         results_csv=str(tmp_path / "ours.csv"))
    ref = jmmvp.evaluate(jax.tree_util.tree_map(jnp.asarray, jax_tower), cfg, "clip", bench,
                         fake_tokenize, results_csv=str(tmp_path / "ref.csv"))
    assert sorted(ours) == sorted(mmvp.CATEGORIES + ["average_score"])
    assert_same_results(ours, ref, str(tmp_path / "ours.csv"), str(tmp_path / "ref.csv"))
    assert len(_read_csv(str(tmp_path / "ours.csv"))) == 1 + 9 * 2
    assert [p.text1 for p in mmvp.load_pairs(bench)] == \
        [p.text1 for p in jmmvp.load_pairs(bench)]
    pair = mmvp.load_pairs(bench)[0]
    np.testing.assert_array_equal(mmvp.preprocess_image(pair.img1, "clip", 32),
                                  jmmvp.preprocess_image(pair.img1, "clip", 32))


def test_evaluate_model_dir_on_a_stage2_export(tiny_models, tmp_path, shards, monkeypatch):
    """The port's stage-2 trainer writes an export; the port's
    ``evaluate_model_dir`` (on the CPU) scores it as its ``evaluate`` scores
    the in-memory merged tower, and as JAX's ``evaluate_model_dir`` scores
    the same directory; the eval CLI prints the same dict."""
    s1 = Trainer(write_cfg(tmp_path, shards, max_train_steps=2), device="cpu")
    s1.train()
    cfg = write_cfg(tmp_path, shards, task="image_stage2_all",
                    load_dir=s1.cfg["output_dir"], load_step=2,
                    output_dir=str(tmp_path / "out-s2"), max_train_steps=1,
                    lora_config={"r": 4, "lora_alpha": 16, "lora_dropout": 0.1})
    trainer = Trainer(cfg, device="cpu")
    trainer.train()
    export = os.path.join(cfg["output_dir"], hf_export_name(cfg, 1))
    bench = write_benchmark(str(tmp_path / "mmvp"), seed=1)
    tok = lambda texts: fake_tokenize(texts, length=8)  # noqa: E731 (8 text positions)
    monkeypatch.setattr(mmvp, "default_tokenizer", lambda d, k: tok)
    monkeypatch.setattr(jmmvp, "default_tokenizer", lambda d, k: tok)

    ours = mmvp.evaluate_model_dir(export, bench, results_csv=str(tmp_path / "ours.csv"),
                                   device="cpu")
    merged = lora.merge(trainer.state.modules["clip"]["model"]).eval()
    own = mmvp.evaluate(merged, trainer.spec.tower_cfg, "clip", bench, tok,
                        results_csv=str(tmp_path / "own.csv"))
    assert ours == own and _read_csv(str(tmp_path / "ours.csv")) == \
        _read_csv(str(tmp_path / "own.csv"))
    ref = jmmvp.evaluate_model_dir(export, bench, results_csv=str(tmp_path / "ref.csv"))
    assert_same_results(ours, ref, str(tmp_path / "ours.csv"), str(tmp_path / "ref.csv"))
    printed = cli_evaluate.main(["--benchmark_dir", bench, "--model_dir", export,
                                 "--device", "cpu",
                                 "--results_csv", str(tmp_path / "cli.csv")])
    assert printed == ours
    with pytest.raises(FileNotFoundError):
        mmvp.evaluate_model_dir(str(tmp_path / "missing"), bench, device="cpu")


def test_default_tokenizer_and_siglip_refuse_clearly(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_transformers(name, *a, **kw):
        if name == "transformers":
            raise ImportError("no module named transformers")
        return real(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_transformers)
    for kind in ("clip", "siglip"):
        with pytest.raises(ImportError, match="tokenize function"):
            mmvp.default_tokenizer("/nonexistent", kind)
    monkeypatch.setattr(builtins, "__import__", real)
    # SigLIP is ported (tests/test_torch_siglip.py); a missing export is
    # refused before anything random is built
    with pytest.raises(FileNotFoundError, match="random-init"):
        mmvp.evaluate_model_dir("/nonexistent", ".", tower="siglip", clip_image_size=384,
                                device="cpu")
    # reconstruct(controlnet_params=...) is ported: tests/test_torch_controlnet.py


# ---------------------------------------------------------------- reconstruction

def test_reconstruct_matches_jax():
    """The Euler sampler + VAE decode from one image and JAX's own noise."""
    spec = jax_spec(compute_dtype=jnp.float32, dit_param_dtype=jnp.float32)
    params = jax_params(spec)
    image = np.random.default_rng(4).random((2, 32, 32, 3), dtype=np.float32)
    ref = jrecon.reconstruct(jax.tree_util.tree_map(jnp.asarray, params), spec, image,
                             num_steps=3, seed=5)
    h, w = spec.latent_hw
    noise = np.asarray(jax.random.normal(jax.random.key(5), (2, h, w,
                                                             spec.vae_cfg.z_channels)))
    from test_torch_parity import port_spec
    ours = recon.reconstruct(port_modules(spec, params), port_spec(spec), image,
                             num_steps=3, noise=noise)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)


def test_reconstruct_cli_from_a_stage1_checkpoint(tiny_models, tmp_path, shards):
    from PIL import Image
    trainer = Trainer(write_cfg(tmp_path, shards, max_train_steps=2), device="cpu")
    trainer.train()
    img = tmp_path / "in.jpg"
    Image.fromarray(np.random.default_rng(6).integers(0, 255, (48, 40, 3), np.uint8)).save(img)
    out = cli_reconstruct.main(["--config", str(tmp_path / "cfg.yaml"), "--image", str(img),
                                "--load_dir", trainer.cfg["output_dir"], "--load_step", "2",
                                "--output_dir", str(tmp_path / "recon"), "--num_steps", "2",
                                "--device", "cpu"])
    rec = np.asarray(Image.open(out))
    assert rec.shape == (32, 32, 3)
    assert os.path.exists(tmp_path / "recon" / "input.jpg")


# ---------------------------------------------------------------- verify-weights

@pytest.fixture(scope="module")
def hf_clip_dir(tmp_path_factory):
    from test_towers import tiny_hf_clip
    model, _ = tiny_hf_clip()
    d = tmp_path_factory.mktemp("hf_clip")
    model.save_pretrained(str(d), safe_serialization=False)
    return str(d)


def test_parity_digest_against_transformers(hf_clip_dir, monkeypatch, capsys, tmp_path):
    """The port's ``load_tower`` against ``transformers.CLIPModel`` on one
    directory, as tests/test_verify_weights.py holds JAX's; without
    transformers the digest says so."""
    out = verify_weights.parity_digest(hf_clip_dir, "openai_clip", 224, device="cpu")
    assert out["hf_loaded"], out.get("hf_error")
    assert out["image_embed_max_abs_diff"] < 5e-5
    assert out["text_embed_max_abs_diff"] < 5e-5
    assert out["logits_max_abs_diff"] < 5e-5
    bench = write_benchmark(str(tmp_path / "mmvp"), seed=2)
    monkeypatch.setattr(mmvp, "default_tokenizer", lambda d, k: fake_tokenize)
    rc = verify_weights.main(["--model-dir", hf_clip_dir, "--benchmark-dir", bench,
                              "--max-pairs", "2", "--device", "cpu"])
    result = json.loads(capsys.readouterr().out)
    assert rc == 0 and result["ok"] and result["parity"]["within_tol"]
    assert len(result["mmvp"]) == 2            # the first category and the average
    import sys
    monkeypatch.setitem(sys.modules, "transformers", None)
    out = verify_weights.parity_digest(hf_clip_dir, "openai_clip", 224, device="cpu")
    assert out["hf_loaded"] is False and "transformers" in out["hf_error"]
    with pytest.raises(FileNotFoundError):
        verify_weights.parity_digest(str(tmp_path / "missing"), "openai_clip", 224,
                                     device="cpu")
