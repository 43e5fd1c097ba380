"""The ported IP-Adapter against the JAX package, on the CPU.

``dit_forward`` with IP conditioning in both block kinds (planted nonzero
k/v: at init they are zero and the residual vanishes, so a wrong placement
would pass), from a raw image embedding through ``image_proj_model`` and
from pre-projected tokens, with ``ip_scale`` != 1; controls that silence
one block kind must miss the bound.  float32, 1e-5 of the largest
magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genhancer_tpu.models import dit as jdit
from genhancer_tpu.models import ip_adapter as jip
from genhancer_tpu_torch.models import dit as tdit
from genhancer_tpu_torch.models import ip_adapter as tip
from genhancer_tpu_torch.weights.convert import dit_state_dict, load_jax_params

from test_torch_controlnet import B, CFG, close, inputs, jax_in, port_in
from test_torch_parity import f32, port_cfg, t

torch.set_num_threads(1)

CTX, CLIP_DIM, N_TOK = 32, 24, 4


def planted_ip(seed, scale=0.1):
    """An ``init_ip_params`` tree whose every k/v projection is seeded
    nonzero (random, not constant: the IP tokens are LayerNormed, and a
    constant matrix would annihilate them)."""
    tree = jax.device_get(jip.init_ip_params(jax.random.key(1), CFG, context_dim=CTX,
                                             clip_embeddings_dim=CLIP_DIM,
                                             num_tokens=N_TOK))
    rng = np.random.default_rng(seed)
    for blk in tree["ip_double"] + tree["ip_single"]:
        for proj in blk.values():
            for k, v in proj.items():
                proj[k] = scale * rng.standard_normal(np.shape(v)).astype(np.float32)
    return tree


def port_ip(tree):
    ip = tip.IPAdapter(port_cfg(CFG), context_dim=CTX, clip_embeddings_dim=CLIP_DIM,
                       num_tokens=N_TOK)
    load_jax_params({"ip": ip}, {"ip": tree})
    return ip


@pytest.fixture(scope="module")
def trees():
    return jax.device_get(jdit.init_dit(jax.random.key(0), CFG)), planted_ip(3)


@pytest.fixture(scope="module")
def port(trees):
    dit = tdit.DiT(port_cfg(CFG))
    dit.load_state_dict(dit_state_dict(trees[0]), strict=True)
    return dit, port_ip(trees[1])


@pytest.mark.parametrize("embed_kind", ["raw embedding", "tokens"])
def test_dit_forward_with_ip_matches_jax(trees, port, embed_kind):
    dit_tree, ip_tree = trees
    dit, ip = port
    inp = inputs(5)
    rng = np.random.default_rng(6)
    embed = (rng.standard_normal((B, CLIP_DIM), dtype=np.float32) if embed_kind == "raw embedding"
             else rng.standard_normal((B, N_TOK, CTX), dtype=np.float32))
    want = jdit.dit_forward(dit_tree, CFG, image_proj=jnp.asarray(embed), ip_params=ip_tree,
                            ip_scale=0.6, **jax_in(inp))
    with torch.no_grad():
        got = tdit.dit_forward(dit, port_cfg(CFG), image_proj=t(embed), ip_params=ip,
                               ip_scale=0.6, **port_in(inp))
        plain = tdit.dit_forward(dit, port_cfg(CFG), **port_in(inp))
    close(got, want)
    assert np.abs(f32(got) - f32(plain)).max() > 1e-3
    # controls: the IP residual of either block kind silenced must miss
    for kind in ("ip_double", "ip_single"):
        silent = port_ip(ip_tree)
        with torch.no_grad():
            for blk in getattr(silent, kind):
                blk.v_proj.weight.zero_()
            off = tdit.dit_forward(dit, port_cfg(CFG), image_proj=t(embed), ip_params=silent,
                                   ip_scale=0.6, **port_in(inp))
        err = np.abs(f32(off) - f32(want)).max() / np.abs(f32(want)).max()
        assert err > 1e-3, (kind, err)


def test_image_proj_model_and_zero_init(trees, port):
    dit, _ = port
    ip_tree = jax.device_get(jip.init_ip_params(jax.random.key(2), CFG, context_dim=CTX,
                                                clip_embeddings_dim=CLIP_DIM, num_tokens=N_TOK))
    ip = port_ip(ip_tree)
    embed = np.random.default_rng(7).standard_normal((B, CLIP_DIM), dtype=np.float32)
    want = jip.image_proj_model(ip_tree["image_proj_model"], jnp.asarray(embed))
    with torch.no_grad():
        got = tip.image_proj_model(ip.image_proj_model, t(embed))
    assert got.shape == (B, N_TOK, CTX)
    close(got, want)
    # fresh k/v are zero: IP conditioning adds nothing at init
    fresh = tip.init_ip_params(torch.Generator().manual_seed(0), port_cfg(CFG), context_dim=CTX,
                               clip_embeddings_dim=CLIP_DIM, num_tokens=N_TOK)
    inp = port_in(inputs(8))
    with torch.no_grad():
        np.testing.assert_array_equal(
            f32(tdit.dit_forward(dit, port_cfg(CFG), image_proj=t(embed), ip_params=fresh,
                                 **inp)),
            f32(tdit.dit_forward(dit, port_cfg(CFG), **inp)))
    assert all(float(p.abs().max()) == 0.0 for n, p in fresh.named_parameters()
               if n.startswith(("ip_double", "ip_single")))
    # JAX's defaults: context 4096, CLIP embedding 1024, 4 tokens
    default = tip.IPAdapter(port_cfg(CFG), device="meta")
    assert default.image_proj_model.proj.weight.shape == (4 * 4096, 1024)
    assert default.ip_double[0].k_proj.bias is not None and default.ip_single[0].k_proj.bias is None
    with pytest.raises(ValueError, match="num_tokens"):
        load_jax_params({"ip": tip.IPAdapter(port_cfg(CFG), context_dim=CTX,
                                             clip_embeddings_dim=CLIP_DIM, num_tokens=2)},
                        {"ip": ip_tree})
