"""Pipeline parallelism of the port (``genhancer_tpu_torch/parallel/pp.py``,
the pipe axis of ``parallel/mesh.py``) against the JAX package on the CPU.

The ranks are processes of ``genhancer_tpu_torch.parallel.testing`` in a
gloo group through a ``file://`` store under the test's tmp_path, each
launch with its own timeout.  The oracles run in this process: JAX's
``pp.pipeline_dit_forward`` on the virtual CPU mesh and its gradients
(``tests/test_pp.py:48-80``), and JAX's unsharded image stage-1 step.

Bounds: the pipelined DiT's output within 2e-5 of the port's plain
``dit_forward`` and every gradient leaf within 2e-5 of its plain
gradients (JAX's own bounds for its pipeline against its plain forward);
against JAX's pipeline, the output within 2e-5 of its largest element
(the two packages' float32 products round apart: 2.7e-5 at its largest
element 3.8) and each gradient leaf within the data-parallel tests'
bound, 1e-4 of its largest element (1e-3 for the two layers fed by the
1000·t sinusoids);
the step's loss within 1e-4 relative, each gradient leaf within 1e-4 of
its largest element (1e-3 for the two layers fed by the 1000·t
sinusoids), the parameters by the sign rule of the data-parallel tests.
The control must miss the gradient bound by more than 10x.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genhancer_tpu.core.rope import spatial_ids
from genhancer_tpu.models import dit as jdit
from genhancer_tpu.parallel import mesh as jmesh
from genhancer_tpu.parallel import pp as jpp
from genhancer_tpu.tasks import image as jimage
from genhancer_tpu.train import optim as joptim
from genhancer_tpu.train import state as jstate
from genhancer_tpu_torch.parallel import mesh as tmesh
from genhancer_tpu_torch.parallel import pp as tpp
from genhancer_tpu_torch.parallel import testing as ptest
from genhancer_tpu_torch.tasks import image as timage
from genhancer_tpu_torch.weights import hf_io
from genhancer_tpu_torch.weights.convert import dit_state_dict, load_jax_params

from test_torch_parallel import (HYPER, _check_grads, _check_params, _ckpt_cfg, _global_batches,
                                 _grad_bound, _in_process, _jax_accum, _launch)
from test_torch_parity import f32, port_cfg, t
from test_torch_train_e2e import shards  # noqa: F401 (fixture)
from test_torch_train_step import _jax_draws, _port_name, _specs

torch.set_num_threads(1)

# depth 2 + 2: the smallest graph pp2 divides (tests/test_pp.py)
CFG = jdit.DiTConfig(in_channels=8, vec_in_dim=12, context_in_dim=16, hidden_size=64,
                     num_heads=4, depth=2, depth_single_blocks=2, axes_dim=(4, 6, 6))
ATOL = 2e-5


def _port_plain(params, batch):
    """The port's plain dit_forward of the same weights: output, gradients
    of the mean of its squares."""
    from genhancer_tpu_torch.models import dit as tdit
    dit = tdit.DiT(port_cfg(CFG), dtype=torch.float32)
    dit.load_state_dict({k: t(np.asarray(v)) for k, v in dit_state_dict(params).items()})
    out = tdit.dit_forward(dit, port_cfg(CFG), **{k: t(v) for k, v in batch.items()})
    out.square().mean().backward()
    return f32(out), {"dit." + k: f32(v.grad) for k, v in dit.named_parameters()}


@pytest.fixture(scope="module")
def setup():
    """JAX's DiT, its batch of 8 rows and its plain forward (test_pp.py)."""
    params = jdit.init_dit(jax.random.key(0), CFG)
    b, l_img = 8, 16
    rng = np.random.default_rng(0)
    batch = dict(
        img=rng.standard_normal((b, l_img, CFG.in_channels)).astype(np.float32),
        img_ids=np.broadcast_to(np.asarray(spatial_ids(4, 4))[None], (b, l_img, 3))
        .astype(np.float32),
        txt=rng.standard_normal((b, 3, CFG.context_in_dim)).astype(np.float32),
        txt_ids=np.zeros((b, 3, 3), np.float32),
        timesteps=np.full((b,), 0.5, np.float32),
        y=rng.standard_normal((b, CFG.vec_in_dim)).astype(np.float32),
        guidance=np.full((b,), 4.0, np.float32))
    return params, batch


# name -> (world, remat): pp2 alone and dp2 x pp2, with and without remat
RUNS = {"pp2": (2, False), "pp2-remat": (2, True), "dp2xpp2": (4, False),
        "dp2xpp2-remat": (4, True)}


def _jax_pp(params, batch, world, remat):
    mesh = jmesh.make_mesh(world, pipeline_parallel=2, devices=jax.devices()[:world])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def fwd(p):
        return jpp.pipeline_dit_forward(p, CFG, mesh=mesh, n_micro=2, remat=remat, **jb)

    out = jax.jit(fwd)(params)
    grads = jax.jit(jax.grad(lambda p: jnp.mean(fwd(p) ** 2)))(params)
    return np.asarray(out), {"dit." + k: np.asarray(v) for k, v in dit_state_dict(grads).items()}


def _payload(params, batch, world, remat, control=None):
    return {"scenario": "pp_forward", "pp": 2, "cfg": port_cfg(CFG),
            "state_dict": {k: t(np.asarray(v)) for k, v in dit_state_dict(params).items()},
            "inputs": {k: t(v) for k, v in batch.items()}, "n_micro": 2, "remat": remat,
            "control": control}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_pipeline_forward_and_grads_match_jax(setup, tmp_path, name):
    params, batch = setup
    world, remat = RUNS[name]
    outs = _launch(tmp_path, name, _payload(params, batch, world, remat), world)
    want, wgrads = _jax_pp(params, batch, world, remat)
    plain, pgrads = _port_plain(params, batch)
    got = np.concatenate([f32(outs[d * 2]["out"]) for d in range(world // 2)])
    assert np.abs(got - plain).max() <= ATOL
    assert np.abs(got - want).max() <= ATOL * np.abs(want).max()
    for o in outs:
        assert set(o["grads"]) == set(wgrads) == set(pgrads)
        for k, w in wgrads.items():
            g = f32(o["grads"][k])
            assert np.abs(g - pgrads[k]).max() <= ATOL, k
            assert np.abs(g - w).max() <= _grad_bound(k) * max(np.abs(w).max(), 1e-30), k
    for r, o in enumerate(outs):             # rank r: pipe index r % 2, data index r // 2
        g = o["groups"]
        assert (g["pipe_index"], g["data_index"]) == (r % 2, r // 2)
        assert g["pipe_group"] == [r - r % 2, r - r % 2 + 1]
        assert torch.equal(o["out"], outs[r - r % 2]["out"])     # every stage holds it


def test_control_final_layer_summed_over_pipe_misses(setup, tmp_path):
    """The final layer, which every pipe rank computes whole, summed over
    pipe like a stage's blocks: twice its gradient."""
    params, batch = setup
    outs = _launch(tmp_path, "ctl", _payload(params, batch, 2, False, "sum_all_over_pipe"), 2)
    _, wgrads = _jax_pp(params, batch, 2, False)
    key = "dit.final_layer.linear.weight"
    err = np.abs(f32(outs[0]["grads"][key]) - wgrads[key]).max()
    assert err > 10 * ATOL and np.allclose(f32(outs[0]["grads"][key]), 2 * wgrads[key],
                                           atol=ATOL)


# ----------------------------------------------------------- the PP step

def test_pp_zero1_step_matches_jax(tmp_path):
    """The image stage-1 step (accumulation 2, 2 micro-batches per
    pipeline) on dp2 x pp2 with ZeRO-1 against JAX's unsharded step on the
    global batch (tests/test_pp.py:124-178: ZeRO-1 shards over data only)."""
    js, ps = _specs("float32")
    js = dataclasses.replace(js, dit_cfg=dataclasses.replace(js.dit_cfg, depth=2,
                                                             depth_single_blocks=2))
    ps = dataclasses.replace(ps, dit_cfg=port_cfg(js.dit_cfg), pipeline_parallel=2,
                             pipeline_microbatches=2)
    modules = jimage.init_modules(jax.random.key(0), js)
    params = jax.device_get({k: modules[k] for k in ("dit", "vae", "clip")})
    cfg = dict(HYPER, shard_optimizer_state=True)
    jopt = joptim.make_optimizer(cfg)
    jst = jstate.create_state(modules, jimage.trainable_predicate(js, modules), jopt)
    imgs = np.random.default_rng(5).random((2, 8, 32, 32, 3), dtype=np.float32)
    key = jax.random.key(11)
    jl, jgrads, jnew = _jax_accum(jst, jimage.make_loss_fn(js), jopt, {"image": imgs}, key)
    keys = jax.random.split(key, 2)
    mods = timage.build_modules(ps)
    load_jax_params(mods, params)
    outs = _launch(tmp_path, "zero1", {
        "scenario": "step", "task": "image", "spec": ps, "accum": 2, "opt_cfg": cfg,
        "state_dict": mods.state_dict(), "batch": {"image": t(imgs)},
        "draws": [_jax_draws(js, keys[i], 8) for i in range(2)]}, 4)
    for o in outs[1:]:
        assert o["loss"] == outs[0]["loss"]
        for k, v in outs[0]["params"].items():
            assert torch.equal(o["params"][k], v), k
    np.testing.assert_allclose(outs[0]["loss"], jl, rtol=1e-4)
    _check_grads(outs[0]["grads"], jgrads)
    _check_params(outs[0]["params"], jnew, jgrads)
    assert {_port_name(k) for k in jgrads} == set(outs[0]["grads"])


# ----------------------------------------------------------- validation

def test_validation_errors_are_jax_s(setup):
    pcfg = port_cfg(CFG)
    for args in ((3, 1, 8), (2, 3, 8), (2, 0, 8)):
        with pytest.raises(ValueError) as ours:
            tpp.validate_pp(pcfg, *args)
        with pytest.raises(ValueError) as theirs:
            jpp.validate_pp(CFG, *args)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="composes with data parallelism"):
        tmesh.validate_mesh(8, 2, 1, 2)
    with pytest.raises(ValueError, match="composes with data parallelism"):
        tmesh.validate_mesh(8, 1, 2, 2)
    with pytest.raises(ValueError, match="not divisible by"):
        tmesh.validate_mesh(6, 1, 1, 4)
    x = torch.zeros(8, 4, CFG.in_channels)
    kw = dict(img=x, img_ids=torch.zeros(8, 4, 3), txt=torch.zeros(8, 2, 16),
              txt_ids=torch.zeros(8, 2, 3), timesteps=torch.zeros(8), y=torch.zeros(8, 12),
              guidance=torch.zeros(8))
    with pytest.raises(ValueError, match="no 'pipe' axis"):
        tpp.pipeline_dit_forward(None, pcfg, n_micro=1, **kw)
    with pytest.raises(NotImplementedError, match="IP-adapter"):
        tpp.pipeline_dit_forward(None, pcfg, n_micro=1, ip_params={"x": 1}, **kw)


def test_spec_dispatch_rejects_quant_under_pp():
    _, ps = _specs("float32")
    spec = dataclasses.replace(ps, pipeline_parallel=2, dit_quant="int8")
    mesh = tmesh.Mesh(1, None, None, (0,), (0,), pp=2)
    with pytest.raises(ValueError, match="dit_quant"):
        timage.dit_apply_factory(spec, mesh)
    with pytest.raises(ValueError, match="needs the mesh"):
        timage.dit_apply_factory(spec, None)
    with pytest.raises(ValueError, match="mesh pipe axis 1"):
        timage.dit_apply_factory(dataclasses.replace(spec, dit_quant="none"),
                                 tmesh.Mesh(1, None, None, (0,), (0,)))
    fn = timage.dit_apply_factory(dataclasses.replace(spec, dit_quant="none"), mesh)
    assert fn.func is tpp.pipeline_dit_forward and fn.keywords == {"n_micro": 2}
    assert ptest.SCENARIOS["pp_forward"] is ptest.scenario_pp_forward


# ----------------------------------------------------------- the Trainer

def test_trainer_on_the_pp_mesh_writes_one_checkpoint(tmp_path, shards,  # noqa: F811
                                                      monkeypatch):
    """Two ranks of the ``Trainer`` with ``pipeline_parallel: 2`` (the tiny DiT at
    depth 2 + 2) run 2 steps on given global batches: the history's loss
    is the global batch's, within 1e-4 of one process on the same batches,
    on both ranks; rank 0 writes the step-2 checkpoint of the whole
    (replicated) parameters, which equal both ranks'."""
    cfg, reg = _ckpt_cfg(tmp_path, shards, "mesh", max_train_steps=2, pipeline_parallel=2, pipeline_microbatches=2)
    reg["dit"] = dataclasses.replace(reg["dit"], depth=2, depth_single_blocks=2)
    outs = _launch(tmp_path, "mesh", {"scenario": "train", "device": "cpu", "cfg": cfg,
                                      "registry": reg, "batches": _global_batches(2)}, 2)
    one_cfg = {k: v for k, v in cfg.items() if k not in ("pipeline_parallel", "pipeline_microbatches")}
    one_cfg["output_dir"] = str(tmp_path / "one")
    one = _in_process(one_cfg, reg, _global_batches(2), monkeypatch)
    one.train()
    want = [h["loss"] for h in one.history]
    for o in outs:
        assert o["saved_steps"] == [2]
        np.testing.assert_allclose([h["loss"] for h in o["history"]], want, rtol=1e-4)
        for k, v in outs[0]["params"].items():
            assert torch.equal(o["params"][k], v), k
    sd = hf_io.load_state_dict(os.path.join(cfg["output_dir"], "checkpoint-dit-2.bin"))
    for k, v in sd.items():
        assert torch.equal(v, outs[0]["params"]["dit." + k]), k
