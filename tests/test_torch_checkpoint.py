"""The port's checkpoints (utils/checkpoint.py) on the CPU.

* A render state written by tracy_tpu's save_render_state loads in the
  port, and one the port writes loads in tracy_tpu's load_render_state:
  the same npz keys (accum, frame), arrays equal bit for bit.
* A progressive render checkpointed after 2 frames and resumed for 2 more
  equals an uninterrupted 4-frame render bit for bit (the counter RNG is
  keyed by the frame index).
* TrainableParams round-trip.
* A training run of 3 Adam steps, checkpointed after 2 (parameters, Adam's
  step counts and moments, the step) and resumed in a fresh train step,
  ends with parameters and Adam state equal bit for bit to the
  uninterrupted run's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracy_tpu.render.renderer import RenderState as JRenderState
from tracy_tpu.utils.checkpoint import load_render_state as j_load_render_state
from tracy_tpu.utils.checkpoint import save_render_state as j_save_render_state
from tracy_tpu_torch import RenderConfig
from tracy_tpu_torch.diff import (
    TrainableParams, extract_params, make_train_step, make_training_intersector)
from tracy_tpu_torch.render.renderer import RenderState, Renderer, init_state
from tracy_tpu_torch.scene import default_scene
from tracy_tpu_torch.utils.checkpoint import (
    load_params, load_render_state, load_train_state, save_params, save_render_state,
    save_train_state)

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
        assert {"p_albedo", "o_0_exp_avg", "o_0_exp_avg_sq", "o_1_step", "step"} <= set(
            data.files)

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
