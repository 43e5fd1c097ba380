"""The ported ControlNet against the JAX package, on the CPU.

* ``controlnet_forward`` and the DiT consuming its residuals, at a
  ControlNet depth of 1 and 3 beside the DiT's 2 double blocks (the cyclic
  index ``i % depth``), with planted nonzero ``cond_in`` and
  ``controlnet_blocks`` (at init both are zero and the residuals vanish, so a
  wrong path would pass);
* the trainable-copy init from a DiT;
* ``denoise_controlnet`` without and with CFG (``neg_controlnet_fn``), and
  JAX's refusal of a negative branch without one;
* the ControlNet's parameter gradients through the DiT against ``jax.grad``;
* ``reconstruct(controlnet_params=...)`` on JAX's own noise.

Everything is float32; the tolerance is 1e-5 of the largest magnitude
(summation order over a few composed layers), gradients 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genhancer_tpu.eval import reconstruct as jrecon
from genhancer_tpu.models import controlnet as jcn
from genhancer_tpu.models import dit as jdit
from genhancer_tpu.train import flow as jflow
from genhancer_tpu_torch.eval import reconstruct as recon
from genhancer_tpu_torch.models import controlnet as tcn
from genhancer_tpu_torch.models import dit as tdit
from genhancer_tpu_torch.train import flow as tflow
from genhancer_tpu_torch.weights.convert import dit_state_dict, load_jax_params

from test_torch_parity import f32, jax_params, jax_spec, port_cfg, port_modules, port_spec, t

torch.set_num_threads(1)

CFG = jdit.DiTConfig(in_channels=16, vec_in_dim=24, context_in_dim=32, hidden_size=64,
                     num_heads=4, depth=2, depth_single_blocks=1, axes_dim=(4, 6, 6))
L_IMG, L_TXT, B = 8, 3, 2


def close(got, want, bound=1e-5):
    got, want = f32(got), f32(want)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= bound, (err, bound)


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    ids = np.zeros((B, L_IMG, 3), np.float32)
    ids[..., 1] = np.arange(L_IMG) // 4
    ids[..., 2] = np.arange(L_IMG) % 4
    return dict(img=rng.standard_normal((B, L_IMG, 16), dtype=np.float32), img_ids=ids,
                txt=rng.standard_normal((B, L_TXT, 32), dtype=np.float32),
                txt_ids=np.zeros((B, L_TXT, 3), np.float32),
                timesteps=rng.random(B, dtype=np.float32),
                y=rng.standard_normal((B, 24), dtype=np.float32),
                guidance=np.full((B,), 4.0, np.float32))


def planted(tree, seed, scale=0.05):
    """``tree`` with seeded nonzero ``cond_in`` and ``controlnet_blocks``."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    tree["cond_in"] = {k: scale * rng.standard_normal(v.shape).astype(np.float32)
                       for k, v in tree["cond_in"].items()}
    tree["controlnet_blocks"] = [
        {k: scale * rng.standard_normal(v.shape).astype(np.float32) for k, v in blk.items()}
        for blk in tree["controlnet_blocks"]]
    return tree


def port_dit(tree):
    dit = tdit.DiT(port_cfg(CFG))
    dit.load_state_dict(dit_state_dict(tree), strict=True)
    return dit


def port_controlnet(tree, depth):
    cn = tcn.ControlNet(port_cfg(CFG), depth)
    load_jax_params({"controlnet": cn}, {"controlnet": tree})
    return cn


@pytest.fixture(scope="module")
def dit_tree():
    return jax.device_get(jdit.init_dit(jax.random.key(1), CFG))


@pytest.fixture(scope="module", params=[1, 3], ids=["depth1", "depth3"])
def cn_pair(request):
    """(depth, JAX tree with planted projections, port ControlNet)."""
    depth = request.param
    tree = planted(jax.device_get(jcn.init_controlnet(jax.random.key(0), CFG, depth)), depth)
    return depth, tree, port_controlnet(tree, depth)


def jax_in(inp):
    return {k: jnp.asarray(v) for k, v in inp.items()}


def port_in(inp):
    return {k: t(v) for k, v in inp.items()}


class TestForward:
    def test_residuals_and_dit_match_jax(self, dit_tree, cn_pair):
        depth, tree, cn = cn_pair
        inp, cond = inputs(1), np.random.default_rng(2).standard_normal(
            (B, L_IMG, 16), dtype=np.float32)
        ref = jcn.controlnet_forward(tree, CFG, controlnet_cond=jnp.asarray(cond),
                                     **jax_in(inp))
        with torch.no_grad():
            ours = tcn.controlnet_forward(cn, port_cfg(CFG), controlnet_cond=t(cond),
                                          **port_in(inp))
        assert len(ours) == len(ref) == depth
        for r, o in zip(ref, ours):
            assert o.shape == (B, L_IMG, CFG.hidden_size) and np.abs(f32(o)).max() > 1e-3
            close(o, r)
        # the DiT adds res[i % depth] after its double block i
        want = jdit.dit_forward(dit_tree, CFG, controlnet_residuals=ref, **jax_in(inp))
        dit = port_dit(dit_tree)
        with torch.no_grad():
            got = tdit.dit_forward(dit, port_cfg(CFG), controlnet_residuals=ours,
                                   **port_in(inp))
            plain = tdit.dit_forward(dit, port_cfg(CFG), **port_in(inp))
        close(got, want)
        assert np.abs(f32(got) - f32(plain)).max() > 1e-4
        # a residual at the wrong index (no cycling) must miss the bound
        if depth == 1:
            with torch.no_grad():
                skew = tdit.dit_forward(dit, port_cfg(CFG),
                                        controlnet_residuals=list(ours) + [0 * ours[0]],
                                        **port_in(inp))
            assert np.abs(f32(skew) - f32(want)).max() > 1e-3

    def test_zero_init_is_a_noop_and_shapes_are_checked(self, dit_tree):
        cn = tcn.init_controlnet(torch.Generator().manual_seed(0), port_cfg(CFG), depth=2)
        inp = port_in(inputs(3))
        with torch.no_grad():
            res = tcn.controlnet_forward(cn, port_cfg(CFG), controlnet_cond=inp["img"], **inp)
            dit = port_dit(dit_tree)
            np.testing.assert_array_equal(
                f32(tdit.dit_forward(dit, port_cfg(CFG), controlnet_residuals=res, **inp)),
                f32(tdit.dit_forward(dit, port_cfg(CFG), **inp)))
        assert all(float(r.abs().max()) == 0.0 for r in res)
        with pytest.raises(ValueError, match="must match"):
            tcn.controlnet_forward(cn, port_cfg(CFG), controlnet_cond=inp["img"][:, :4], **inp)

    def test_init_from_dit_copies_the_trunk_cyclically(self, dit_tree):
        dit = port_dit(dit_tree)
        cn = tcn.init_controlnet_from_dit(torch.Generator().manual_seed(0), dit,
                                          port_cfg(CFG), depth=3)
        ref = jax.device_get(jcn.init_controlnet_from_dit(jax.random.key(0), dit_tree, CFG,
                                                          depth=3))
        want, got = dit_state_dict(ref), cn.state_dict()
        assert sorted(want) == sorted(got)
        for k, v in want.items():
            if k.startswith(("cond_in", "controlnet_blocks")):
                assert float(got[k].abs().max()) == 0.0 == float(v.abs().max()), k
            else:                          # the DiT's prologue and blocks i % 2
                np.testing.assert_array_equal(f32(got[k]), f32(v), err_msg=k)


class TestSampler:
    @pytest.mark.parametrize("cfg_branch", [False, True], ids=["plain", "cfg"])
    def test_denoise_controlnet_matches_jax(self, dit_tree, cn_pair, cfg_branch):
        depth, tree, cn = cn_pair
        inp = inputs(4)
        cond = np.random.default_rng(5).standard_normal((B, L_IMG, 16), dtype=np.float32)
        neg_txt = np.random.default_rng(6).standard_normal((B, L_TXT, 32), dtype=np.float32)
        ts = jflow.get_schedule(3, L_IMG, shift=True)
        dit = port_dit(dit_tree)

        def fns(jax_side, txt):
            pk = dict(jax_in(inp) if jax_side else port_in(inp))
            pk["txt"] = jnp.asarray(txt) if jax_side else t(txt)
            for k in ("img", "timesteps", "guidance"):
                pk.pop(k)
            if jax_side:
                return (lambda x, tv, g, res: jdit.dit_forward(
                            dit_tree, CFG, img=x, timesteps=tv, guidance=g,
                            controlnet_residuals=res, **pk),
                        lambda x, tv, g: jcn.controlnet_forward(
                            tree, CFG, img=x, timesteps=tv, guidance=g,
                            controlnet_cond=jnp.asarray(cond), **pk))
            return (lambda x, tv, g, res: tdit.dit_forward(
                        dit, port_cfg(CFG), img=x, timesteps=tv, guidance=g,
                        controlnet_residuals=res, **pk),
                    lambda x, tv, g: tcn.controlnet_forward(
                        cn, port_cfg(CFG), img=x, timesteps=tv, guidance=g,
                        controlnet_cond=t(cond), **pk))

        kw = dict(guidance=3.0, true_gs=2.5, controlnet_gs=0.7, timestep_to_start_cfg=1)
        jkw, tkw = dict(kw), dict(kw)
        if cfg_branch:
            jkw["neg_model_fn"], jkw["neg_controlnet_fn"] = fns(True, neg_txt)
            tkw["neg_model_fn"], tkw["neg_controlnet_fn"] = fns(False, neg_txt)
        ref = jflow.denoise_controlnet(*fns(True, inp["txt"]), jnp.asarray(inp["img"]), ts,
                                       **jkw)
        with torch.no_grad():
            ours = tflow.denoise_controlnet(*fns(False, inp["txt"]), t(inp["img"]), ts, **tkw)
        close(ours, ref)

    def test_negative_branch_needs_its_controlnet(self):
        with pytest.raises(ValueError, match="neg_controlnet_fn"):
            tflow.denoise_controlnet(None, None, torch.zeros(1, 4, 16), [1.0, 0.0],
                                     neg_model_fn=lambda *a: None)


# the sinusoidal embeddings take 1000 * t and 1000 * guidance (4000 rad),
# where XLA's and torch's float32 sin/cos differ by 1.2e-4 relative: the
# first layer behind them is held at 1e-3, as in tests/test_torch_train_step.py
SINUSOID_LEAVES = {"time_in.in_layer.weight": 1e-3, "guidance_in.in_layer.weight": 1e-3}


def test_parameter_gradients_match_jax(dit_tree):
    """d mean(DiT(x; residuals)^2) / d(ControlNet params) against
    ``jax.grad``, every leaf at 1e-4 of its largest magnitude but the two
    of ``SINUSOID_LEAVES`` (the zero ``cond_in`` of JAX's own check replaced
    by planted values)."""
    tree = planted(jax.device_get(jcn.init_controlnet(jax.random.key(0), CFG, 3)), 9)
    inp = inputs(7)
    cond = np.random.default_rng(8).standard_normal((B, L_IMG, 16), dtype=np.float32)

    def loss(cn_params):
        res = jcn.controlnet_forward(cn_params, CFG, controlnet_cond=jnp.asarray(cond),
                                     **jax_in(inp))
        out = jdit.dit_forward(dit_tree, CFG, controlnet_residuals=res, **jax_in(inp))
        return jnp.mean(jnp.square(out))

    ref = dit_state_dict(jax.device_get(jax.grad(loss)(jax.tree_util.tree_map(jnp.asarray,
                                                                               tree))))
    cn = port_controlnet(tree, 3)
    dit = port_dit(dit_tree).requires_grad_(False)
    res = tcn.controlnet_forward(cn, port_cfg(CFG), controlnet_cond=t(cond), **port_in(inp))
    tdit.dit_forward(dit, port_cfg(CFG), controlnet_residuals=res,
                     **port_in(inp)).square().mean().backward()
    # the last block's txt-stream tail feeds no residual: no gradient reaches
    # it (None here, zeros in JAX)
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
             for k, p in cn.named_parameters()}
    assert sorted(grads) == sorted(ref)
    assert float(grads["cond_in.weight"].abs().max()) > 0
    for k, g in grads.items():
        if float(ref[k].abs().max()) == 0.0:
            assert float(g.abs().max()) == 0.0, k
        else:
            close(g, ref[k], SINUSOID_LEAVES.get(k, 1e-4))


def test_reconstruct_with_controlnet_matches_jax():
    """``reconstruct(controlnet_params=...)``: the control image (a second
    image, then the default: the input) VAE-encoded to its mean and packed,
    the ControlNet sampler on JAX's own noise, the VAE decode."""
    spec = jax_spec(compute_dtype=jnp.float32, dit_param_dtype=jnp.float32)
    cfg = spec.dit_cfg
    params = jax_params(spec, seed=2)
    tree = planted(jax.device_get(jcn.init_controlnet(jax.random.key(3), cfg, 1)), 10, 0.2)
    cn = tcn.ControlNet(port_cfg(cfg), 1)
    load_jax_params({"controlnet": cn}, {"controlnet": tree})
    rng = np.random.default_rng(11)
    image, control = (rng.random((2, 32, 32, 3), dtype=np.float32) for _ in range(2))
    h, w = spec.latent_hw
    noise = np.asarray(jax.random.normal(jax.random.key(5), (2, h, w, spec.vae_cfg.z_channels)))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    mods = port_modules(spec, params)
    outs = {}
    for name, ctl in (("control image", control), ("default", None)):
        ref = jrecon.reconstruct(jparams, spec, image, num_steps=3, seed=5,
                                 controlnet_params=jtree, control_image01=ctl,
                                 controlnet_gs=0.9)
        ours = recon.reconstruct(mods, port_spec(spec), image, num_steps=3, noise=noise,
                                 controlnet_params=cn, control_image01=ctl, controlnet_gs=0.9)
        assert ours.shape == ref.shape == (2, 32, 32, 3)
        close(ours, ref)
        outs[name] = ours
    plain = recon.reconstruct(mods, port_spec(spec), image, num_steps=3, noise=noise)
    assert np.abs(outs["default"] - plain).max() > 1e-4
    assert np.abs(outs["default"] - outs["control image"]).max() > 1e-4
