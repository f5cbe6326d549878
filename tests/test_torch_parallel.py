"""The port's mesh (tracy_tpu_torch/parallel/mesh.py) on CPU cells.

torch has no virtual CPU devices like XLA's, so a mesh here names the CPU
for every cell and the cells run one after the other. Contracts:

* along 'data' the sharded frame equals the port's single-device frame
  bit for bit (RNG keyed by global pixel ids), on the brute-force path
  and on the packet path (K1's plain version, compacted, bounce 0
  peeled); along 'sample' within atol 3e-6, rtol 1e-5 (float32
  summation order, as tests/test_sharding.py holds tracy_tpu); the rays
  equal the single-device count at every shape;
* a 4x2 mesh against tracy_tpu's make_sharded_render_step on its 8
  virtual devices, same scene arrays: the block-mean contract of
  tests/test_torch_render.py (an ulp of torch against XLA can flip a
  discrete decision), rays within 0.1%;
* sharded gradients within rtol 1e-4, atol 1e-6 of the port's
  single-device gradients (which tests/test_torch_gradients.py holds
  against tracy_tpu), and a sharded Adam run that lowers the loss;
* the analytic per-band overhead at 1080p of tests/test_sharding.py for
  the port's pick_tile and pick_compact_group.
"""

import os

import jax
import numpy as np
import pytest
import torch

from tracy_tpu.config import RenderConfig as JRenderConfig
from tracy_tpu.parallel import make_render_mesh as j_make_render_mesh
from tracy_tpu.parallel import make_sharded_render_step as j_make_sharded_render_step
from tracy_tpu.parallel import replicate_scene as j_replicate_scene
from tracy_tpu.render.renderer import init_state as j_init_state
from tracy_tpu.scene.scn_parser import load_scene as j_load_scene
from tracy_tpu_torch import RenderConfig
from tracy_tpu_torch.accel.reorder import pick_compact_group
from tracy_tpu_torch.diff import TrainableParams, apply_params, extract_params, make_train_step
from tracy_tpu_torch.ops import intersect as k1
from tracy_tpu_torch.parallel import (
    make_render_mesh, make_sharded_render_step, make_sharded_train_step, replicate_scene)
from tracy_tpu_torch.parallel.distributed import host_rows
from tracy_tpu_torch.render.renderer import Renderer, init_state, pick_tile, sample_radiance
from tracy_tpu_torch.scene import default_scene, from_jax_arrays, load_scene
from tracy_tpu_torch.utils.parity import block_means

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FURNACE = os.path.join(REPO, "tests", "goldens", "scn", "furnace.scn")
CPU8 = ["cpu"] * 8


def furnace(w=16, h=16):
    b = load_scene(FURNACE)
    b.width, b.height = w, h
    return b.build(device="cpu")


@pytest.fixture(scope="module")
def scene():
    return furnace()


def single(scene, cfg, frames):
    return Renderer(cfg).step_many(scene, init_state(cfg, "cpu"), frames)


def sharded(scene, cfg, mesh, frames):
    step = make_sharded_render_step(cfg, mesh)
    sc = replicate_scene(scene, mesh)
    st, total = init_state(cfg, "cpu"), 0
    for _ in range(frames):
        st, rays = step(sc, st)
        total += int(rays)
    return st, total


@pytest.mark.parametrize("n_data,n_sample", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_render_matches_single_device(scene, n_data, n_sample):
    cfg = RenderConfig(width=16, height=16, spp=8, max_bounces=2, tonemap="none",
                       accel="none")
    st, rays = sharded(scene, cfg, make_render_mesh(n_data, n_sample, devices=CPU8), 1)
    ref, ref_rays = single(scene, cfg, 1)
    if n_sample == 1:
        assert torch.equal(st.accum, ref.accum)
    else:
        np.testing.assert_allclose(st.accum.numpy(), ref.accum.numpy(), atol=3e-6, rtol=1e-5)
    assert rays == ref_rays and st.frame == 1


def test_sharded_progressive_frames(scene):
    cfg = RenderConfig(width=16, height=16, spp=2, max_bounces=2, tonemap="none",
                       accel="none")
    st, _ = sharded(scene, cfg, make_render_mesh(4, 2, devices=CPU8), 3)
    ref, _ = single(scene, cfg, 3)
    np.testing.assert_allclose(st.accum.numpy(), ref.accum.numpy(), atol=3e-6, rtol=1e-5)
    assert st.frame == 3


def test_sharded_packet_path_bit_identical():
    """cfg's single-device stages on every cell: K1's plain version over
    the 4-wide tables, compacted, bounce 0 peeled, K2's plain version."""
    sc = default_scene(32, 32).build(device="cpu")
    cfg = RenderConfig(width=32, height=32, spp=1, max_bounces=3, tonemap="none",
                       accel="packet", wave_compact_group=1024)
    ref, ref_rays = single(sc, cfg, 1)
    k1.COUNT.reset()
    st, rays = sharded(sc, cfg, make_render_mesh(4, 1, devices=["cpu"] * 4), 1)
    assert torch.equal(st.accum, ref.accum) and rays == ref_rays
    assert k1.COUNT.plain == 4 * cfg.max_bounces and k1.COUNT.kernel == 0


def test_4x2_matches_tracy_tpu_sharded_step():
    assert len(jax.devices()) == 8
    jb = j_load_scene(FURNACE)
    jb.width = jb.height = 16
    jscene = jb.build()
    jcfg = JRenderConfig(width=16, height=16, spp=2, max_bounces=2, tonemap="none",
                         accel="none")
    jmesh = j_make_render_mesh(4, 2)
    jst, jrays = jax.jit(j_make_sharded_render_step(jcfg, jmesh))(
        j_replicate_scene(jscene, jmesh), j_init_state(jcfg))
    cfg = RenderConfig(width=16, height=16, spp=2, max_bounces=2, tonemap="none",
                       accel="none")
    st, rays = sharded(from_jax_arrays(jscene, device="cpu"), cfg,
                       make_render_mesh(4, 2, devices=CPU8), 1)
    got, ref = st.accum.numpy(), np.asarray(jst.accum)
    assert np.isfinite(got).all() and abs(rays - int(jrays)) <= 1e-3 * int(jrays)
    d = np.abs(block_means(got) - block_means(ref))
    assert abs(float(got.mean()) - float(ref.mean())) <= 1e-3
    assert float(np.percentile(d, 95)) <= 5e-3 and float(d.max()) <= 0.05


@pytest.mark.parametrize("n_data", [1, 2, 4, 8])
def test_scaling_shape_overhead_1080p(n_data):
    """Per-band overhead at 1080p under 5% for any data split: dead tile
    rows (pick_tile) and compaction padding (pick_compact_group), counted
    from the functions the renderer uses, as tests/test_sharding.py
    counts tracy_tpu's."""
    w, h = 1920, 1080
    rows = h // n_data
    th, tw = pick_tile(rows, w)
    assert th > 0 and th * tw == 1024 and w % tw == 0
    padded = n_data * (rows + (-rows) % th) * w
    assert padded / (w * h) - 1.0 < 0.05, (n_data, th, tw)
    g = pick_compact_group(rows * w)
    assert (-(-(rows * w) // g) * g) / (rows * w) - 1.0 < 0.05, (n_data, g)


def test_host_rows_of_one_process_cover_the_image():
    mesh = make_render_mesh(4, 2, devices=CPU8)
    assert host_rows(32, mesh) == (0, 32)
    assert [c[:2] for c in mesh.cells()] == [(d, s) for d in range(4) for s in range(2)]
    assert mesh.home == torch.device("cpu")


def train_cfg(spp=2):
    return RenderConfig(width=16, height=16, spp=spp, max_bounces=2, tonemap="none",
                        accel="none", russian_roulette=False)


def test_sharded_gradients_match_single_device(scene):
    cfg = train_cfg()
    target = torch.full((16, 16, 3), 0.25)
    sgd = lambda ps: torch.optim.SGD(ps, lr=1.0)  # noqa: E731
    step1, p1, o1 = make_train_step(scene, cfg, optimizer=sgd)
    step1(p1, o1, target, 0)
    step2, p2, o2 = make_sharded_train_step(scene, cfg, make_render_mesh(2, 2, devices=CPU8[:4]),
                                            optimizer=sgd)
    step2(p2, o2, target, 0)
    for name, a, b in zip(TrainableParams._fields, p1, p2):
        assert (a.grad is None) == (b.grad is None), name
        if a.grad is not None:
            np.testing.assert_allclose(b.grad.numpy(), a.grad.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=name)
            np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=name)


def test_sharded_train_step_descends(scene):
    cfg = train_cfg(spp=1)
    params = extract_params(scene)
    truth = params.albedo.clone()
    truth[1] = 0.9
    with torch.no_grad():
        target, _ = sample_radiance(apply_params(scene, params._replace(albedo=truth)), cfg, 3)
    mask = TrainableParams(*(False,) * 8)._replace(albedo=torch.tensor([[False], [True]]))
    step, params, opt = make_sharded_train_step(
        scene, cfg, make_render_mesh(2, 1, devices=CPU8[:2]),
        optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-1), trainable_mask=mask)
    losses = []
    for _ in range(8):
        params, opt, loss = step(params, opt, target, 3)
        losses.append(float(loss))
    assert losses[-1] < 0.5 * losses[0]
    assert float(params.albedo[1, 0].detach()) > float(scene.materials.albedo[1, 0]) + 0.1
    assert torch.equal(params.albedo[0], scene.materials.albedo[0])  # masked out


@pytest.mark.parametrize("shape,devices,message", [
    ((3, 1), CPU8[:4], "mesh 3x1 != 4 devices"),
    ((None, 3), CPU8[:4], "!= 4 devices"),
    ((3, 1), CPU8[:3], "height 16 not divisible by data axis 3"),
    ((1, 3), CPU8[:3], "spp 2 not divisible by sample axis 3"),
    ((None, 0), CPU8[:4], "each axis needs at least one cell"),
])
def test_mesh_refusals(scene, shape, devices, message):
    cfg = RenderConfig(width=16, height=16, spp=2, accel="none")
    with pytest.raises(ValueError, match=message):
        make_sharded_render_step(cfg, make_render_mesh(*shape, devices=devices))


def test_stage_functions_need_one_device(monkeypatch, scene):
    """A given stage runs on every cell, so it needs the cells on one
    device; cards are asked for by name and never replaced by the CPU."""
    mesh = make_render_mesh(2, 1, devices=["cpu", "meta"])
    cfg = RenderConfig(width=16, height=16, spp=1, accel="none")
    with pytest.raises(ValueError, match="2 devices"):
        make_sharded_render_step(cfg, mesh, intersect_fn=lambda o, d, a: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_render_mesh(1, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_render_mesh(1, 1, devices=["cuda:0"])
