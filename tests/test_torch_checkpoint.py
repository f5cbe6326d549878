"""The port's checkpoints (utils/checkpoint.py) on the CPU.

* A render state written by tracy_tpu's save_render_state loads in the
  port, and one the port writes loads in tracy_tpu's load_render_state:
  the same npz keys (accum, frame), arrays equal bit for bit.
* A progressive render checkpointed after 2 frames and resumed for 2 more
  equals an uninterrupted 4-frame render bit for bit (the counter RNG is
  keyed by the frame index).
* TrainableParams round-trip.
* A training run of 3 Adam steps, checkpointed after 2 (parameters, Adam's
  step count and moments in tracy_tpu's layout, the step) and resumed in a
  fresh train step, ends with parameters and Adam state equal bit for bit
  to the uninterrupted run's.
* The training state crosses packages: optax.adam's state flattens to
  count, then mu and nu in TrainableParams field order (checked against
  optax.adam(...).init), the betas and eps of the port's Adam are
  optax.adam's; a state saved by tracy_tpu after 2 steps resumes in the
  port for a third, which agrees with the port's uninterrupted 3 steps,
  and the same the other way, within rtol 1e-5 (the two packages' float32
  gradients differ by rounding, tests/test_torch_gradients.py).
* save_pytree / load_pytree files cross both ways (dicts in jax's sorted
  key order), and load_npy_state reads tracy_tpu's .npy images.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tracy_tpu.config import RenderConfig as JConfig
from tracy_tpu.diff import TrainableParams as JTrainableParams
from tracy_tpu.diff import extract_params as j_extract_params
from tracy_tpu.diff import make_train_step as j_make_train_step
from tracy_tpu.render.renderer import RenderState as JRenderState
from tracy_tpu.scene.scn_parser import load_scene as j_load_scene
from tracy_tpu.utils import checkpoint as jck
from tracy_tpu.utils.checkpoint import load_render_state as j_load_render_state
from tracy_tpu.utils.checkpoint import save_render_state as j_save_render_state
from tracy_tpu.utils.image_io import save_image as j_save_image
from tracy_tpu_torch import RenderConfig
from tracy_tpu_torch.diff import (
    TrainableParams, extract_params, make_train_step, make_training_intersector)
from tracy_tpu_torch.render.renderer import RenderState, Renderer, init_state
from tracy_tpu_torch.scene import default_scene, from_jax_arrays
from tracy_tpu_torch.utils.checkpoint import (
    load_params, load_pytree, load_render_state, load_train_state, save_params, save_pytree,
    save_render_state, save_train_state)
from tracy_tpu_torch.utils.image_io import load_npy_state

torch.set_num_threads(2)


@pytest.mark.parametrize("writer", ["tracy_tpu", "port"])
def test_render_state_crosses_packages(tmp_path, writer):
    path = str(tmp_path / "state.npz")
    accum = np.random.default_rng(1).uniform(0, 4, (12, 16, 3)).astype(np.float32)
    if writer == "tracy_tpu":
        j_save_render_state(path, JRenderState(accum=jnp.asarray(accum),
                                               frame=jnp.asarray(7, jnp.int32)))
        st = load_render_state(path, device="cpu")
        assert isinstance(st.frame, int) and st.frame == 7
        np.testing.assert_array_equal(st.accum.numpy(), accum)
    else:
        save_render_state(path, RenderState(accum=torch.as_tensor(accum), frame=7))
        st = j_load_render_state(path)
        assert int(st.frame) == 7
        np.testing.assert_array_equal(np.asarray(st.accum), accum)


def test_render_resume_bit_identical(tmp_path):
    scene = default_scene(16, 12).build(device="cpu")
    cfg = RenderConfig(width=16, height=12, spp=1, max_bounces=2, tonemap="none", accel="bvh")
    full, _ = Renderer(cfg).step_many(scene, init_state(cfg, "cpu"), 4)
    half, _ = Renderer(cfg).step_many(scene, init_state(cfg, "cpu"), 2)
    path = str(tmp_path / "ckpt.npz")
    save_render_state(path, half)
    resumed = load_render_state(path, device="cpu")
    assert resumed.frame == 2
    resumed, _ = Renderer(cfg).step_many(scene, resumed, 2)
    assert resumed.frame == 4
    assert torch.equal(resumed.accum, full.accum)


def test_params_roundtrip(tmp_path):
    params = extract_params(default_scene(8, 8).build(device="cpu"))
    path = str(tmp_path / "params.npz")
    save_params(path, params)
    loaded = load_params(path, TrainableParams, device="cpu")
    for a, b in zip(params, loaded):
        assert torch.equal(a, b)


def test_adam_resume_bit_identical(tmp_path):
    scene = default_scene(8, 6).build(device="cpu")
    cfg = RenderConfig(width=8, height=6, spp=1, max_bounces=2, tonemap="none",
                       russian_roulette=False)
    mask = TrainableParams(*(False,) * 8)._replace(albedo=True, roughness=True)
    target = torch.full((6, 8, 3), 0.3)

    def fresh():
        isect = make_training_intersector(scene, cfg, needs_geometry_grads=False)
        return make_train_step(scene, cfg, intersect_fn=isect, trainable_mask=mask)

    step, params, opt = fresh()
    for i in range(3):
        params, opt, _ = step(params, opt, target, i)

    step2, params2, opt2 = fresh()
    for i in range(2):
        params2, opt2, _ = step2(params2, opt2, target, i)
    path = str(tmp_path / "train.npz")
    save_train_state(path, params2, opt2, 2)
    with np.load(path) as data:
        # tracy_tpu's layout: count, then mu and nu of the 8 fields.
        assert set(data.files) == ({f"p_{k}" for k in TrainableParams._fields} | {"step"}
                                   | {f"o_leaf{i}" for i in range(17)})
        assert int(data["o_leaf0"]) == 2 and not data["o_leaf3"].any()  # metalness: untrained

    step3, params3, opt3 = fresh()
    params3, opt3, start = load_train_state(path, params3, opt3)
    assert start == 2
    for i in range(start, 3):
        params3, opt3, _ = step3(params3, opt3, target, i)
    for a, b in zip(params, params3):
        assert torch.equal(a, b)
    sa, sb = opt.state_dict()["state"], opt3.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in sa[i]:
            assert torch.equal(torch.as_tensor(sa[i][k]), torch.as_tensor(sb[i][k]))


FURNACE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "scn",
                       "furnace.scn")


@pytest.fixture(scope="module")
def adam_runs():
    """3 Adam steps (lr 1e-2) of tracy_tpu's make_train_step (optax.adam)
    and of the port's (torch.optim.Adam) on furnace.scn at 16x12, training
    the grey sphere's albedo: each side's state after 2 and after 3 steps,
    and the port's fresh train step."""
    kw = dict(width=16, height=12, spp=1, max_bounces=2, tonemap="none",
              russian_roulette=False, accel="none")
    jb = j_load_scene(FURNACE)
    jb.width, jb.height = 16, 12
    js = jb.build()
    base = j_extract_params(js)
    jmask = jax.tree_util.tree_map(lambda x: jnp.zeros_like(x, bool), base)
    jmask = jmask._replace(albedo=jmask.albedo.at[1].set(True))
    jstep, jopt = j_make_train_step(js, JConfig(**kw), optax.adam(1e-2), trainable_mask=jmask)
    target = np.full((12, 16, 3), 0.6, np.float32)
    jrun, jparams = [], base
    for i in range(3):
        jparams, jopt, _ = jstep(jparams, jopt, jnp.asarray(target), jnp.asarray(i, jnp.int32))
        jrun.append((jparams, jopt))

    scene = from_jax_arrays(js, device="cpu")
    cfg = RenderConfig(**kw)
    mask = TrainableParams(*(torch.zeros(x.shape, dtype=torch.bool)
                             for x in extract_params(scene)))
    mask.albedo[1] = True

    def fresh():
        return make_train_step(scene, cfg, trainable_mask=mask)

    step, params, opt = fresh()
    run = []
    for i in range(3):
        params, opt, _ = step(params, opt, torch.as_tensor(target), i)
        run.append(([p.detach().clone() for p in params], opt.state_dict()))
    return dict(jstep=jstep, jrun=jrun, run=run, fresh=fresh, target=target, base=base)


def test_adam_state_layout_is_optax_adams():
    jp = JTrainableParams(*(jnp.full((2,), float(i)) for i in range(8)))
    leaves = jax.tree_util.tree_leaves(optax.adam(1e-2).init(jp))
    assert len(leaves) == 17 and leaves[0].dtype == jnp.int32 and leaves[0].shape == ()
    # mu then nu, each in field order (zeros at init: tell them apart by a step)
    grads = JTrainableParams(*(jnp.full((2,), float(i + 1)) for i in range(8)))
    _, st = optax.adam(1e-2).update(grads, optax.adam(1e-2).init(jp), jp)
    leaves = jax.tree_util.tree_leaves(st)
    np.testing.assert_allclose([float(x[0]) for x in leaves[1:9]],
                               [0.1 * (i + 1) for i in range(8)], rtol=1e-6)
    np.testing.assert_allclose([float(x[0]) for x in leaves[9:17]],
                               [0.001 * (i + 1) ** 2 for i in range(8)], rtol=1e-5)
    # The port's Adam: optax.adam's betas and eps.
    _, params, opt = make_train_step(default_scene(8, 6).build(device="cpu"),
                                     RenderConfig(width=8, height=6))
    assert opt.defaults["betas"] == (0.9, 0.999) and opt.defaults["eps"] == 1e-8


@pytest.mark.parametrize("writer", ["tracy_tpu", "port"])
def test_train_state_crosses_packages(tmp_path, adam_runs, writer):
    path = str(tmp_path / "train.npz")
    jrun, run, target = adam_runs["jrun"], adam_runs["run"], adam_runs["target"]
    if writer == "tracy_tpu":
        jck.save_train_state(path, jrun[1][0], jrun[1][1], 2)
        step, params, opt = adam_runs["fresh"]()
        params, opt, start = load_train_state(path, params, opt)
        assert start == 2
        params, opt, _ = step(params, opt, torch.as_tensor(target), start)
        got = [p.detach() for p in params]
        want = run[2][0]
    else:
        step, params, opt = adam_runs["fresh"]()
        params, opt, _ = step(params, opt, torch.as_tensor(target), 0)
        params, opt, _ = step(params, opt, torch.as_tensor(target), 1)
        save_train_state(path, params, opt, 2)
        like = optax.adam(1e-2).init(adam_runs["base"])
        jparams, jopt, start = jck.load_train_state(path, JTrainableParams, like)
        assert start == 2 and int(jax.tree_util.tree_leaves(jopt)[0]) == 2
        jparams, jopt, _ = adam_runs["jstep"](jparams, jopt, jnp.asarray(target),
                                              jnp.asarray(start, jnp.int32))
        got = [torch.tensor(np.asarray(x)) for x in jparams]
        want = [torch.tensor(np.asarray(x)) for x in jrun[2][0]]
    for name, g, w in zip(TrainableParams._fields, got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=0, err_msg=name)
    # The step moved the trained entry; the rest kept the scene's values.
    assert not np.array_equal(got[0].numpy()[1], np.asarray(adam_runs["base"].albedo)[1])
    assert np.array_equal(got[0].numpy()[0], np.asarray(adam_runs["base"].albedo)[0])


@pytest.mark.parametrize("writer", ["tracy_tpu", "port"])
def test_pytree_crosses_packages(tmp_path, writer):
    path = str(tmp_path / "tree.npz")
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in ((3,), (2, 2), (4,))]
    count = np.asarray(5, np.int32)
    # Keys inserted out of order: both packages flatten a dict by sorted key.
    def tree(a, c):
        return {"z": [a[0], (a[1], c)], "a": JTrainableParams(*([a[2]] * 8))}

    jtree = tree([jnp.asarray(a) for a in arrays], jnp.asarray(count))
    ttree = tree([torch.as_tensor(a) for a in arrays], torch.as_tensor(count))
    if writer == "tracy_tpu":
        jck.save_pytree(path, jtree)
        got = load_pytree(path, tree([torch.zeros(a.shape) for a in arrays],
                                     torch.zeros((), dtype=torch.int32)))
        assert got["z"][1][1].dtype == torch.int32
        pairs = zip(jax.tree_util.tree_leaves(jtree), jax.tree_util.tree_leaves(
            tree([got["z"][0], got["z"][1][0], got["a"].albedo], got["z"][1][1])))
    else:
        save_pytree(path, ttree)
        got = jck.load_pytree(path, jtree)
        pairs = zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jtree))
    for a, b in pairs:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert type(got["a"]) is JTrainableParams and list(got) == ["a", "z"]


def test_load_npy_state_reads_tracy_tpus_npy(tmp_path):
    path = str(tmp_path / "img.npy")
    img = np.random.default_rng(4).uniform(0, 2, (6, 8, 3)).astype(np.float32)
    j_save_image(img, path)  # 8-bit, as tracy_tpu writes a display image
    got = load_npy_state(path)
    np.testing.assert_array_equal(got, np.clip(img * 255.99, 0, 255).astype(np.uint8))

