"""Checkpoints under the port's mesh (parallel/mesh.py, utils/checkpoint.py)
on CPU cells.

The accumulator is the whole image and the RNG streams are keyed by
global pixel and sample ids, so a render state saved under one mesh shape
resumes under another: bit for bit when the sample axis keeps its size,
within atol 3e-6, rtol 1e-5 on one device (the sample mean's summation
order). A tracy_tpu checkpoint written under its 8-device mesh loads into
the port's mesh and continues within the block-mean contract of
tests/test_torch_render.py against tracy_tpu's own continuation. The
training state (parameters, Adam's moments, the step) resumes bit for bit
under the same mesh and within atol 1e-7, rtol 1e-6 under another (the
gradient sum's order), as tests/test_elastic.py holds tracy_tpu.
"""

import os

import jax
import numpy as np
import torch

from tracy_tpu.config import RenderConfig as JRenderConfig
from tracy_tpu.parallel import make_render_mesh as j_make_render_mesh
from tracy_tpu.parallel import make_sharded_render_step as j_make_sharded_render_step
from tracy_tpu.parallel import replicate_scene as j_replicate_scene
from tracy_tpu.render.renderer import init_state as j_init_state
from tracy_tpu.scene.scn_parser import load_scene as j_load_scene
from tracy_tpu.utils.checkpoint import save_render_state as j_save_render_state
from tracy_tpu_torch import RenderConfig
from tracy_tpu_torch.apps import render_cli
from tracy_tpu_torch.parallel import (
    make_render_mesh, make_sharded_render_step, make_sharded_train_step, replicate_scene)
from tracy_tpu_torch.render.renderer import Renderer, init_state
from tracy_tpu_torch.scene import from_jax_arrays
from tracy_tpu_torch.utils.checkpoint import (
    load_render_state, load_train_state, save_render_state, save_train_state)
from tracy_tpu_torch.utils.parity import block_means
from test_torch_parallel import CPU8, FURNACE, furnace

torch.set_num_threads(2)


def cfg_of(w=16, h=16, spp=2):
    return RenderConfig(width=w, height=h, spp=spp, max_bounces=2, tonemap="none",
                        accel="none")


def run(step, sc, st, frames):
    for _ in range(frames):
        st, _ = step(sc, st)
    return st


def test_render_restore_across_mesh_shapes(tmp_path):
    """4x2 for 2 frames, checkpoint, then 2 more (the uninterrupted run);
    the checkpoint on a 2x2 mesh for 2 frames equals it bit for bit, and
    on one device within the sample mean's summation order."""
    scene, cfg = furnace(), cfg_of()
    path = str(tmp_path / "elastic.npz")
    mesh_a = make_render_mesh(4, 2, devices=CPU8)
    step_a = make_sharded_render_step(cfg, mesh_a)
    sc_a = replicate_scene(scene, mesh_a)
    st = run(step_a, sc_a, init_state(cfg, mesh_a.home), 2)
    save_render_state(path, st)
    full = run(step_a, sc_a, st, 2).accum

    mesh_b = make_render_mesh(2, 2, devices=CPU8[:4])
    st_b = load_render_state(path, mesh=mesh_b)
    assert st_b.frame == 2 and st_b.accum.device == mesh_b.home
    st_b = run(make_sharded_render_step(cfg, mesh_b), replicate_scene(scene, mesh_b), st_b, 2)
    assert st_b.frame == 4 and torch.equal(st_b.accum, full)

    st_c, _ = Renderer(cfg).step_many(scene, load_render_state(path, device="cpu"), 2)
    np.testing.assert_allclose(st_c.accum.numpy(), full.numpy(), atol=3e-6, rtol=1e-5)


def test_train_resume_across_mesh_shapes(tmp_path):
    scene, cfg = furnace(8, 8), cfg_of(8, 8)
    target = torch.full((8, 8, 3), 0.25)
    path = str(tmp_path / "train.npz")
    adam = lambda ps: torch.optim.Adam(ps, lr=2e-2)  # noqa: E731

    def steps(mesh):
        return make_sharded_train_step(scene, cfg, mesh, optimizer=adam)

    mesh_a = make_render_mesh(4, 2, devices=CPU8)
    step_a, params, opt = steps(mesh_a)
    for i in range(2):
        params, opt, _ = step_a(params, opt, target, i)
    save_train_state(path, params, opt, 2)
    for i in range(2, 4):
        params, opt, _ = step_a(params, opt, target, i)
    full = [p.detach().clone() for p in params]

    for mesh, exact in ((mesh_a, True), (make_render_mesh(2, 2, devices=CPU8[:4]), False)):
        step, p, o = steps(mesh)
        p, o, start = load_train_state(path, p, o)
        assert start == 2
        for i in range(start, 4):
            p, o, _ = step(p, o, target, i)
        for a, b in zip(full, p):
            if exact:
                assert torch.equal(a, b.detach())
            else:
                np.testing.assert_allclose(b.detach().numpy(), a.numpy(), atol=1e-7, rtol=1e-6)


def test_tracy_tpu_mesh_checkpoint_resumes_on_the_port_mesh(tmp_path):
    assert len(jax.devices()) == 8
    jb = j_load_scene(FURNACE)
    jb.width = jb.height = 16
    jscene = jb.build()
    jcfg = JRenderConfig(width=16, height=16, spp=2, max_bounces=2, tonemap="none",
                         accel="none")
    jmesh = j_make_render_mesh(4, 2)
    jstep = jax.jit(j_make_sharded_render_step(jcfg, jmesh))
    jsc = j_replicate_scene(jscene, jmesh)
    jst = j_init_state(jcfg)
    for _ in range(2):
        jst, _ = jstep(jsc, jst)
    path = str(tmp_path / "tracy_tpu.npz")
    j_save_render_state(path, jst)
    saved = np.asarray(jst.accum)
    jst, _ = jstep(jsc, jst)

    mesh = make_render_mesh(2, 2, devices=CPU8[:4])
    st = load_render_state(path, mesh=mesh)
    assert st.frame == 2
    np.testing.assert_array_equal(st.accum.numpy(), saved)
    st = run(make_sharded_render_step(cfg_of(), mesh),
             replicate_scene(from_jax_arrays(jscene, device="cpu"), mesh), st, 1)
    got, ref = st.accum.numpy(), np.asarray(jst.accum)
    assert st.frame == 3 and np.isfinite(got).all()
    d = np.abs(block_means(got) - block_means(ref))
    assert abs(float(got.mean()) - float(ref.mean())) <= 1e-3
    assert float(np.percentile(d, 95)) <= 5e-3 and float(d.max()) <= 0.05


def test_render_cli_mesh_crash_and_resume(tmp_path):
    """-mesh 4x1 'crashes' after 2 frames; -mesh 2x1 resumes the
    checkpoint to 4; the accumulator equals an uninterrupted 4-frame run
    on one device bit for bit."""
    base = ["-cpu", "-width", "24", "-height", "16", "-bounces", "2", "-tonemap", "none",
            "-checkpoint-every", "1", "-out", str(tmp_path / "x.ppm")]
    resumed, straight = str(tmp_path / "resumed.npz"), str(tmp_path / "straight.npz")
    assert render_cli.main(base + ["-mesh", "4x1", "-frames", "2", "-checkpoint", resumed]) == 0
    assert render_cli.main(base + ["-mesh", "2x1", "-frames", "4", "-checkpoint", resumed]) == 0
    assert render_cli.main(base + ["-frames", "4", "-checkpoint", straight]) == 0
    with np.load(resumed) as a, np.load(straight) as b:
        assert int(a["frame"]) == int(b["frame"]) == 4
        np.testing.assert_array_equal(a["accum"], b["accum"])
    assert os.path.getsize(tmp_path / "x.ppm") > 24 * 16 * 3
