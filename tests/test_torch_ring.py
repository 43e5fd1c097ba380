"""Sequence parallelism of the port (``genhancer_tpu_torch/parallel/ring.py``,
the seq axis of ``parallel/mesh.py``) against the JAX package on the CPU.

The ranks are processes of ``genhancer_tpu_torch.parallel.testing`` in a
gloo group through a ``file://`` store under the test's tmp_path, each
launch with its own timeout.  The oracles run in this process: JAX's
``ring.ring_attention`` on the virtual CPU mesh with the same seeded numpy
q, k, v split into the same contiguous chunks, its VJP, and JAX's
unsharded train step.

Bounds: the ring's output in float32 within 1e-5, dq/dk/dv within 1e-5 of
the leaf's largest element; in bf16 within 1.6e-2 (two bf16 ulps at 1:
the two rings round the same float32 sums, whose order differs, to bf16);
the SP step's loss within 2e-4 relative and the grad norm within 5e-4 of
JAX's unsharded step (JAX's own bounds, ``tests/test_ring.py:165-172``),
each trainable leaf within 1e-4 of its largest element of the port's sp=1
step (1e-3 for the two layers fed by the 1000·t sinusoids).  The controls
must miss those leaf bounds by more than 10x.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genhancer_tpu.core.attention import sdpa_xla
from genhancer_tpu.parallel import mesh as jmesh
from genhancer_tpu.parallel import ring as jring
from genhancer_tpu.tasks import image as jimage
from genhancer_tpu.tasks import video as jvideo
from genhancer_tpu.train import optim as joptim
from genhancer_tpu.train import state as jstate
from genhancer_tpu_torch.parallel import ring as tring
from genhancer_tpu_torch.parallel import testing as ptest
from genhancer_tpu_torch.tasks import factory
from genhancer_tpu_torch.tasks import image as timage
from genhancer_tpu_torch.weights import hf_io
from genhancer_tpu_torch.weights.convert import load_jax_params

import test_torch_video as tv
from test_torch_parallel import (HYPER, _cfg, _ckpt_cfg, _global_batches, _grad_bound,
                                 _in_process, _launch)
from test_torch_parity import f32, t
from test_torch_train_e2e import shards  # noqa: F401 (fixture)
from test_torch_train_step import _jax_draws, _port_name, _specs
from test_torch_train_step import jax_init  # noqa: F401 (fixture)

torch.set_num_threads(1)

# name -> (sequence_parallel, world); world > sp puts the rest on the data axis
MESHES = {"sp2": (2, 2), "sp4": (4, 4), "dp2xsp2": (2, 4)}
LENGTHS = (5, 100, 197)
BF16_ATOL = 1.6e-2


def _qkvg(l, dtype, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((4, l, 2, 16)).astype(np.float32).astype(dtype)
            for _ in range(4)]


def _cases():
    """(L, numpy dtype name, q, k, v, g): every length in float32, L=100 in bf16."""
    import ml_dtypes
    out = [(l, "float32", *_qkvg(l, np.float32, l)) for l in LENGTHS]
    out.append((100, "bfloat16", *_qkvg(100, ml_dtypes.bfloat16, 7)))
    return out


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    """One launch per mesh running every case: {name: (cases, ranks' outputs)}."""
    cases = _cases()
    runs = {}
    for name, (sp, world) in MESHES.items():
        payload = {"scenario": "ring", "sp": sp,
                   "cases": [{k: t(x) for k, x in zip("qkvg", c[2:])} for c in cases]}
        runs[name] = (cases, _launch(tmp_path_factory.mktemp(name), name, payload, world))
    return runs


def _whole(outs, i, key, sp, world, l):
    """Case i's ``key`` of every rank back in the whole [B, L, H, D]
    order: the seq chunks concatenated, the data rows stacked."""
    rows = [torch.cat([outs[d * sp + r]["cases"][i][key] for r in range(sp)], dim=1)
            for d in range(world // sp)]
    return f32(torch.cat(rows, dim=0)[:, :l])


def _jax_ring(q, k, v, g, sp, world):
    mesh = jmesh.make_mesh(world, sequence_parallel=sp, devices=jax.devices()[:world])
    batch = jmesh.DATA_AXIS if world > sp else None
    o, vjp = jax.vjp(lambda q, k, v: jring.ring_attention(q, k, v, mesh, batch_axis=batch),
                     *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(x, np.float32) for x in (o, *vjp(jnp.asarray(g)))]


def _jax_ring_bf16(q, k, v, sp, world):
    """JAX's bf16 ring forward, eager, the rows replicated over the data
    axis (XLA:CPU runs no bf16 x bf16 = f32 dot under jit or on a
    data-sharded batch; attention is per row, so the result is the same)."""
    mesh = jmesh.make_mesh(world, sequence_parallel=sp, devices=jax.devices()[:world])
    o = jring.ring_attention(*(jnp.asarray(x) for x in (q, k, v)), mesh, batch_axis=None)
    return np.asarray(o, np.float32)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_indices_groups_and_rotation(ring_runs, name):
    """Rank r has seq index r % sp and data index r // sp; its seq group
    is its data index's ranks; one rotation each way brings the
    neighbours' indices (JAX's ppermute [(i, (i + 1) % n)])."""
    sp, world = MESHES[name]
    for r, o in enumerate(ring_runs[name][1]):
        g = o["groups"]
        assert (g["seq_index"], g["data_index"], g["model_index"]) == (r % sp, r // sp, 0)
        base = r - r % sp
        assert g["seq_group"] == list(range(base, base + sp))
        assert g["data_group"] == list(range(r % sp, world, sp))
        assert o["rotated"] == [base + (r - 1) % sp, base + (r + 1) % sp]


@pytest.mark.parametrize("l", LENGTHS)
@pytest.mark.parametrize("name", sorted(MESHES))
def test_ring_float32_matches_jax(ring_runs, name, l):
    sp, world = MESHES[name]
    cases, outs = ring_runs[name]
    i = next(j for j, c in enumerate(cases) if c[0] == l and c[1] == "float32")
    want = _jax_ring(*cases[i][2:], sp, world)
    for key, w in zip(("o", "dq", "dk", "dv"), want):
        got = _whole(outs, i, key, sp, world, l)
        bound = 1e-5 if key == "o" else 1e-5 * np.abs(w).max()
        assert np.abs(got - w).max() <= bound, (key, np.abs(got - w).max())
    lengths = outs[0]["cases"][i]["lengths"]
    assert sum(lengths) == l and len(lengths) == sp
    if l == 5 and sp == 4:
        assert lengths[-1] == 0          # a fully padded chunk


@pytest.mark.parametrize("name", sorted(MESHES))
def test_ring_bf16_matches_jax(ring_runs, name):
    sp, world = MESHES[name]
    cases, outs = ring_runs[name]
    i = next(j for j, c in enumerate(cases) if c[1] == "bfloat16")
    got = _whole(outs, i, "o", sp, world, 100)
    want = _jax_ring_bf16(*cases[i][2:5], sp, world)
    assert np.abs(got - want).max() <= BF16_ATOL
    # and the ring against the unsharded attention at JAX's own bf16 bound
    q, k, v = (jnp.asarray(x) for x in cases[i][2:5])
    assert np.abs(got - np.asarray(sdpa_xla(q, k, v), np.float32)).max() <= 3e-2


def test_layout_cuts_the_joint_order():
    """sliding@224's joint L = 768 txt + 196 img on two ranks: 482 tokens
    each, rank 0 all text; L = 5 on four: the last chunk is all pad."""
    a, b = (tring.token_layout(768, 196, n=2, r=r) for r in (0, 1))
    assert (a.c, a.txt, a.img, a.lengths) == (482, slice(0, 482), slice(0, 0), (482, 482))
    assert (b.txt, b.img) == (slice(482, 768), slice(0, 196))
    last = tring.token_layout(1, 4, n=4, r=3)
    assert last.lengths == (2, 2, 1, 0) and last.n_real == 0


# ----------------------------------------------------------- the SP step

def _image_case(jax_init):  # noqa: F811
    js, ps = _specs("float32")
    modules, params = jax_init
    jopt = joptim.make_optimizer(dict(HYPER))
    jst = jstate.create_state(modules, jimage.trainable_predicate(js, modules), jopt)
    batch = {"image": np.random.default_rng(5).random((4, 32, 32, 3), dtype=np.float32)}
    mods = timage.build_modules(ps)
    load_jax_params(mods, params)
    return js, ps, jst, jimage.make_loss_fn(js), batch, mods


@pytest.fixture(scope="module")
def sliding_init():
    js = dataclasses.replace(tv.jax_spec("sliding"), img_size=32)
    modules = jvideo.init_modules(jax.random.key(0), js)
    return js, modules, jax.device_get(modules)


def _sliding_case(sliding_init):
    js, modules, params = sliding_init
    ps = tv.port_spec(js)
    jopt = joptim.make_optimizer(dict(HYPER))
    jst = jstate.create_state(modules, jvideo.trainable_predicate(js, modules), jopt)
    rng = np.random.default_rng(6)
    # the last window is padding (valid False), as the sliding loader pads
    batch = {"cond": rng.random((4, 3, 32, 32, 3), dtype=np.float32),
             "target": rng.random((4, 32, 32, 3), dtype=np.float32),
             "valid": np.array([True, True, True, False])}
    mods = tv.tvideo.build_modules(ps)
    load_jax_params(mods, params)
    return js, ps, jst, jvideo.make_loss_fn(js), batch, mods


def _jax_step(js, jst, jloss, batch, key):
    """JAX's unsharded step: (loss, grad norm, grads by port path)."""
    loss, grads = jax.jit(jax.value_and_grad(
        lambda tp, fr, b, k: jloss(tp, fr, b, k)))(jst.trainable, jst.frozen,
                                                   {k: jnp.asarray(v) for k, v in batch.items()},
                                                   key)
    import optax
    return float(loss), float(optax.global_norm(grads)), grads


def _payload(task, ps, mods, batch, draws, **spec_over):
    return {"scenario": "step", "task": task, "opt_cfg": dict(HYPER),
            "spec": dataclasses.replace(ps, **spec_over), "state_dict": mods.state_dict(),
            "batch": {k: t(v) for k, v in batch.items()}, "draws": [draws]}


def _misses(ours, ref) -> float:
    """The largest leaf error over its bound (1e-4 of the leaf's largest
    element, 1e-3 for the sinusoid-fed layers)."""
    return max(np.abs(f32(ours[k]) - f32(g)).max()
               / (_grad_bound(k) * max(np.abs(f32(g)).max(), 1e-30)) for k, g in ref.items())


SP_MESHES = {"sp2": (2, 1, 2), "dp2xsp2": (2, 1, 4), "tp2xsp2": (2, 2, 4)}


@pytest.fixture(scope="module")
def sp_refs(jax_init, sliding_init):  # noqa: F811
    """Per task: the case, JAX's unsharded step and the port's sp=1 step."""
    out = {}
    for task, case in (("image", _image_case(jax_init)), ("video", _sliding_case(sliding_init))):
        js, ps, jst, jloss, batch, mods = case
        key = jax.random.key(11)
        draws = (_jax_draws if task == "image" else tv._jax_draws)(js, key, 4)
        one = ptest.scenario_step(_payload(task, ps, mods, batch, draws))
        out[task] = (case, _jax_step(js, jst, jloss, batch, key), draws, one)
    return out


@pytest.mark.parametrize("mesh_name", sorted(SP_MESHES))
@pytest.mark.parametrize("task", ["image", "video"], ids=["image", "sliding"])
def test_sp_step_matches_jax_and_sp1(sp_refs, tmp_path, task, mesh_name):
    (js, ps, jst, jloss, batch, mods), (jl, jnorm, jgrads), draws, one = sp_refs[task]
    sp, tp, world = SP_MESHES[mesh_name]
    payload = dict(_payload(task, ps, mods, batch, draws, sequence_parallel=sp),
                   model_parallel=tp)
    outs = _launch(tmp_path, mesh_name, payload, world)
    for o in outs[1:]:
        assert o["loss"] == outs[0]["loss"]
    np.testing.assert_allclose(outs[0]["loss"], jl, rtol=2e-4)
    np.testing.assert_allclose(outs[0]["grad_norm"], jnorm, rtol=5e-4)
    assert {_port_name(k) for k in jgrads} == set(one["grads"])
    assert _misses(outs[0]["grads"], one["grads"]) <= 1.0
    g = outs[0]["groups"]
    assert (g["seq_index"], g["model_index"]) == (0, 0) and len(g["seq_group"]) == sp


@pytest.mark.parametrize("control, task", [("per_rank_mean", "video"), ("no_seq_sum", "image")],
                         ids=["per_rank_mean_padded_window", "grads_not_summed_over_seq"])
def test_sp_controls_miss(sp_refs, tmp_path, control, task):
    """A loss that is each seq rank's own mean (with a padded window), and
    gradients left unsummed over seq, miss the sp=1 step by more than 10x."""
    (js, ps, jst, jloss, batch, mods), _, draws, one = sp_refs[task]
    payload = dict(_payload(task, ps, mods, batch, draws, sequence_parallel=2), control=control)
    outs = _launch(tmp_path, control, payload, 2)
    assert _misses(outs[0]["grads"], one["grads"]) > 10.0


# ----------------------------------------------------------- validation

def test_sp_needs_the_mesh_and_refuses_dit_quant(jax_init):  # noqa: F811
    """SP needs the mesh; with ``dit_quant`` it builds, as JAX's
    ``validate_parallelism`` lets it (the int8 step under SP is held by
    tests/test_torch_sp_int8.py)."""
    _, ps = _specs("float32")
    opt = ptest._Recorder(None)
    with pytest.raises(ValueError, match="needs the mesh"):
        timage.make_train_step(dataclasses.replace(ps, sequence_parallel=2), opt)
    spec, _, _ = factory.build_spec(_cfg(sequence_parallel=2, dit_quant="int8_dw"))
    assert (spec.sequence_parallel, spec.dit_quant) == (2, "int8_dw")


# ----------------------------------------------------------- the Trainer

def test_trainer_on_the_sp_mesh_writes_one_checkpoint(tmp_path, shards,  # noqa: F811
                                                      monkeypatch):
    """Two ranks of the ``Trainer`` with ``sequence_parallel: 2`` (the tiny DiT at
    depth 2 + 2) run 2 steps on given global batches: the history's loss
    is the global batch's, within 1e-4 of one process on the same batches,
    on both ranks; rank 0 writes the step-2 checkpoint of the whole
    (replicated) parameters, which equal both ranks'."""
    cfg, reg = _ckpt_cfg(tmp_path, shards, "mesh", max_train_steps=2, sequence_parallel=2)
    reg["dit"] = dataclasses.replace(reg["dit"], depth=2, depth_single_blocks=2)
    outs = _launch(tmp_path, "mesh", {"scenario": "train", "device": "cpu", "cfg": cfg,
                                      "registry": reg, "batches": _global_batches(2)}, 2)
    one_cfg = {k: v for k, v in cfg.items() if k not in ("sequence_parallel", "pipeline_microbatches")}
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
