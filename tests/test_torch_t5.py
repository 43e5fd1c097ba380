"""The ported T5 encoder and text conditioning against the JAX package, on
the CPU.

* ``encoder_forward`` gated (v1.1) and ungated (legacy relu), with and
  without a padding mask, on JAX's parameters: float32, 1e-5 of the largest
  magnitude;
* ``relative_position_buckets`` exactly, up to FLUX's L=512 with 32 buckets
  and max distance 128;
* ``load_t5`` from HF directories the test writes (``model.safetensors``;
  ``pytorch_model.bin`` with a decoder and a tied ``embed_tokens``);
* the providers, ``prepare`` and ``denoise_euler_cfg`` with ``true_gs`` != 1
  on a text-conditioned tiny DiT.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genhancer_tpu.models import dit as jdit
from genhancer_tpu.models.towers import clip as jclip
from genhancer_tpu.models.towers import t5 as jt5
from genhancer_tpu.tasks import text_conditioning as jtc
from genhancer_tpu.train import flow as jflow
from genhancer_tpu.weights import hf_convert
from genhancer_tpu_torch.models import dit as tdit
from genhancer_tpu_torch.models.towers import clip as tclip
from genhancer_tpu_torch.models.towers import t5 as tt5
from genhancer_tpu_torch.tasks import text_conditioning as ttc
from genhancer_tpu_torch.train import flow as tflow
from genhancer_tpu_torch.weights.convert import dit_state_dict, load_jax_params, tower_state_dict

from test_torch_controlnet import CFG, close
from test_torch_parity import TINY_TOWER, f32, port_cfg, t
from test_torch_vae_loader import write_safetensors

torch.set_num_threads(1)


def tiny_cfg(gated=True):
    return jt5.T5Config(d_model=32, d_kv=8, d_ff=64, num_layers=3, num_heads=4, vocab_size=120,
                        relative_attention_num_buckets=8, relative_attention_max_distance=16,
                        gated=gated)


def port_t5_cfg(cfg):
    import dataclasses
    return tt5.T5Config(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module", params=[True, False], ids=["gated", "relu"])
def t5_pair(request):
    cfg = tiny_cfg(request.param)
    tree = jax.device_get(jt5.init_t5(jax.random.key(0), cfg))
    enc = tt5.T5Encoder(port_t5_cfg(cfg))
    load_jax_params({"t5": enc}, {"t5": tree})
    return cfg, tree, enc


def ids_and_mask(seed, b=2, l=11):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, l), np.int64)
    mask[0, 7:] = 0
    mask[1, 4:] = 0
    return rng.integers(0, 120, (b, l)), mask


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_encoder_forward_matches_jax(t5_pair, masked):
    cfg, tree, enc = t5_pair
    ids, mask = ids_and_mask(1)
    want = jt5.encoder_forward(tree, jnp.asarray(ids), cfg,
                               attention_mask=jnp.asarray(mask) if masked else None)
    with torch.no_grad():
        got = tt5.encoder_forward(enc, torch.as_tensor(ids), port_t5_cfg(cfg),
                                  attention_mask=torch.as_tensor(mask) if masked else None)
        other = tt5.encoder_forward(enc, torch.as_tensor(ids), port_t5_cfg(cfg),
                                    attention_mask=None if masked else torch.as_tensor(mask))
    assert got.shape == (2, 11, 32) and got.dtype == torch.float32
    close(got, want)
    assert np.abs(f32(got) - f32(other)).max() > 1e-3        # the mask matters


@pytest.mark.parametrize("q_len, k_len, buckets, max_dist",
                         [(7, 7, 8, 16), (11, 5, 8, 16), (512, 512, 32, 128), (40, 300, 32, 128)])
def test_relative_position_buckets_exactly(q_len, k_len, buckets, max_dist):
    got = tt5.relative_position_buckets(q_len, k_len, buckets, max_dist)
    want = jt5.relative_position_buckets(q_len, k_len, buckets, max_dist)
    assert got.dtype == np.int64 and got.shape == (q_len, k_len)
    np.testing.assert_array_equal(got, want)


def test_load_t5_round_trip(t5_pair, tmp_path):
    cfg, tree, enc = t5_pair
    sd = hf_convert.module_to_torch(tree)
    hf_cfg = {"d_model": cfg.d_model, "d_kv": cfg.d_kv, "d_ff": cfg.d_ff,
              "num_layers": cfg.num_layers, "num_heads": cfg.num_heads,
              "vocab_size": cfg.vocab_size, "relative_attention_num_buckets": 8,
              "relative_attention_max_distance": 16, "layer_norm_epsilon": 1e-6,
              "feed_forward_proj": "gated-gelu" if cfg.gated else "relu"}
    st_dir, bin_dir = tmp_path / "st", tmp_path / "bin"
    for d in (st_dir, bin_dir):
        d.mkdir()
        (d / "config.json").write_text(json.dumps(hf_cfg))
    write_safetensors(sd, str(st_dir / "model.safetensors"))
    # a T5Model's file: a decoder's keys, and the tied embedding under its
    # encoder name only
    full = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    full["encoder.embed_tokens.weight"] = full.pop("shared.weight")
    full["decoder.block.0.layer.0.SelfAttention.q.weight"] = torch.zeros(4, 4)
    torch.save(full, str(bin_dir / "pytorch_model.bin"))
    ids, mask = ids_and_mask(2)
    want = f32(jt5.encoder_forward(tree, jnp.asarray(ids), cfg, attention_mask=jnp.asarray(mask)))
    for d in (st_dir, bin_dir):
        loaded, lcfg = tt5.load_t5(str(d))
        assert lcfg == port_t5_cfg(cfg)
        with torch.no_grad():
            got = tt5.encoder_forward(loaded, torch.as_tensor(ids), lcfg,
                                      attention_mask=torch.as_tensor(mask))
        np.testing.assert_array_equal(f32(got), f32(tt5.encoder_forward(
            enc, torch.as_tensor(ids), lcfg, attention_mask=torch.as_tensor(mask)).detach()))
        close(got, want)
    with pytest.raises(FileNotFoundError):
        tt5.load_t5(str(tmp_path))          # no config.json
    (tmp_path / "config.json").write_text(json.dumps(hf_cfg))
    with pytest.raises(FileNotFoundError, match="no weights"):
        tt5.load_t5(str(tmp_path))


def test_xxl_config_from_hf():
    """google/t5-v1_1-xxl's published config, the encoder FLUX.1 uses."""
    hf = {"d_model": 4096, "d_kv": 64, "d_ff": 10240, "num_layers": 24, "num_heads": 64,
          "vocab_size": 32128, "relative_attention_num_buckets": 32,
          "relative_attention_max_distance": 128, "layer_norm_epsilon": 1e-06,
          "feed_forward_proj": "gated-gelu"}
    cfg = tt5.T5Config.from_hf(hf)
    assert cfg == tt5.T5Config() and cfg.gated
    assert tt5.T5Config.from_hf(hf) == port_t5_cfg(jt5.T5Config.from_hf(hf))
    n = sum(p.numel() for p in tt5.T5Encoder(cfg, device="meta").parameters())
    assert n == 4_762_310_656, n


def test_prepare_and_cfg_sampler_match_jax():
    """T5 sequence + CLIP-text pooled vector -> ``prepare`` -> a 3-step CFG
    sample (``true_gs`` 3.5, the negative prompt from step 1 on) on a tiny
    DiT, float32, against JAX."""
    t5_cfg = jt5.T5Config(d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4,
                          vocab_size=120, relative_attention_num_buckets=8,
                          relative_attention_max_distance=16)
    t5_tree = jax.device_get(jt5.init_t5(jax.random.key(3), t5_cfg))
    clip_tree = jax.device_get(jclip.init_clip(jax.random.key(4), TINY_TOWER))
    dit_tree = jax.device_get(jdit.init_dit(jax.random.key(5), CFG))
    enc = tt5.T5Encoder(port_t5_cfg(t5_cfg))
    load_jax_params({"t5": enc}, {"t5": t5_tree})
    clip = tclip.CLIPModel(port_cfg(TINY_TOWER))
    clip.load_state_dict(tower_state_dict(clip_tree, text_side=True), strict=True)
    dit = tdit.DiT(port_cfg(CFG))
    dit.load_state_dict(dit_state_dict(dit_tree), strict=True)

    rng = np.random.default_rng(6)
    t5_ids, t5_mask = ids_and_mask(7, b=2, l=9)           # row 0 positive, row 1 negative
    clip_ids = rng.integers(0, 50, (2, 8))
    latent = rng.standard_normal((1, 6, 4, 4), dtype=np.float32)
    ts = jflow.get_schedule(3, 6, shift=True)

    def run(jax_side):
        if jax_side:
            seq = jtc.t5_sequence_provider(t5_tree, t5_cfg)(jnp.asarray(t5_ids),
                                                            jnp.asarray(t5_mask))
            vec = jtc.clip_text_pooled_provider(clip_tree, TINY_TOWER)(jnp.asarray(clip_ids))
            prep = [jtc.prepare(seq[i:i + 1], vec[i:i + 1], jnp.asarray(latent))
                    for i in (0, 1)]
            fwd, sampler = jdit.dit_forward, jflow.denoise_euler_cfg
            tree, cfg = dit_tree, CFG
        else:
            seq = ttc.t5_sequence_provider(enc, port_t5_cfg(t5_cfg))(torch.as_tensor(t5_ids),
                                                                    torch.as_tensor(t5_mask))
            vec = ttc.clip_text_pooled_provider(clip, port_cfg(TINY_TOWER))(
                torch.as_tensor(clip_ids))
            prep = [ttc.prepare(seq[i:i + 1], vec[i:i + 1], t(latent)) for i in (0, 1)]
            fwd, sampler = tdit.dit_forward, tflow.denoise_euler_cfg
            tree, cfg = dit, port_cfg(CFG)

        def model(p):
            return lambda x, tv, g: fwd(tree, cfg, img=x, img_ids=p["img_ids"], txt=p["txt"],
                                        txt_ids=p["txt_ids"], timesteps=tv, y=p["vec"],
                                        guidance=g)
        out = sampler(model(prep[0]), prep[0]["img"], ts, guidance=3.0, true_gs=3.5,
                      neg_model_fn=model(prep[1]), timestep_to_start_cfg=1)
        return seq, vec, prep[0], out

    jseq, jvec, jprep, jout = run(True)
    with torch.no_grad():
        tseq, tvec, tprep, tout = run(False)
    close(tseq, jseq)
    close(tvec, jvec)
    for k in ("img", "img_ids", "txt_ids"):
        assert tuple(tprep[k].shape) == jprep[k].shape and tprep[k].dtype == torch.float32
        np.testing.assert_array_equal(f32(tprep[k]), f32(jprep[k]), err_msg=k)
    close(tout, jout)
    with torch.no_grad():        # without the negative branch: plain Euler, and different
        plain = tflow.denoise_euler(
            lambda x, tv, g: tdit.dit_forward(dit, port_cfg(CFG), img=x, img_ids=tprep["img_ids"],
                                              txt=tprep["txt"], txt_ids=tprep["txt_ids"],
                                              timesteps=tv, y=tprep["vec"], guidance=g),
            tprep["img"], ts, 3.0)
    assert np.abs(f32(plain) - f32(tout)).max() > 1e-3
