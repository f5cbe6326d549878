"""The port's differentiable rendering (tracy_tpu_torch.diff) on the CPU.

* Against jax.grad of tracy_tpu's render_loss on the same scene arrays,
  target and frame (tracy_tpu under jax.jit with its brute-force
  intersector): the port's render_loss through its brute-force
  intersector (accel 'none') and through the training intersector (K1's
  plain version under nondiff_intersector, GeometryDiffIntersector for
  the vertices). Albedo, emissive, roughness and metalness on
  default_scene's beauty (16x12, 3 bounces, RR off); the texels on a
  textured sphere; the vertices through the depth and normals AOVs (a
  beauty frame's radiance does not depend on the vertices: both packages
  give them a zero gradient there). Tolerance: rtol 1e-3 where |g| >=
  1e-3 max|g|, absolute 1e-6 max|g| elsewhere.
* Against central differences (h = 1e-3, rtol 2e-2, as
  tests/test_gradients.py): the albedo gradient on furnace.scn (in-repo
  copy) through the training intersector, and the vertex gradient of the
  depth AOV through GeometryDiffIntersector; the counter RNG gives both
  evaluations the same random numbers.
* GeometryDiffIntersector's recomputed t, barycentrics, normal and
  material equal its base's at hit lanes (t within 1e-5).
* Compaction (group 1024 against none) leaves the loss and the material
  and vertex gradients bit for bit as they were.
* make_train_step: 3 Adam steps against tracy_tpu's make_train_step with
  optax.adam at the same learning rate; the trained entries follow the
  same trajectory (their gradients are well above float noise, see
  ROADMAP's hazards on Adam's first step), masked-out leaves stay bit for
  bit the scene's.
* Russian roulette on: every gradient finite.
* A textured loss (beauty or AOV) gathers its texels with K3's plain
  version, chosen by render_loss.
* A small inverse rendering recovers the grey sphere's albedo.
* core/math.py::sqrt's gradient is 0.5 / sqrt(x), and finite where the
  clamp in front of it reads 0.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tracy_tpu.config import RenderConfig as JConfig
from tracy_tpu.diff import extract_params as j_extract_params
from tracy_tpu.diff import make_train_step as j_make_train_step
from tracy_tpu.diff import render_loss as j_render_loss
from tracy_tpu.scene.scene import SceneBuilder as JSceneBuilder
from tracy_tpu.scene.scn_parser import default_scene as j_default_scene
from tracy_tpu.scene.scn_parser import load_scene as j_load_scene
from tracy_tpu_torch import RenderConfig
from tracy_tpu_torch.core import math as tm
from tracy_tpu_torch.diff import (
    GeometryDiffIntersector,
    TrainableParams,
    extract_params,
    make_train_step,
    make_training_intersector,
    params_from_jax,
    render_loss,
)
from tracy_tpu_torch.ops import intersect as k1
from tracy_tpu_torch.ops import shade as k2
from tracy_tpu_torch.ops import texfetch as k3
from tracy_tpu_torch.scene import SceneBuilder, from_jax_arrays

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FURNACE = os.path.join(REPO, "tests", "goldens", "scn", "furnace.scn")
W, H = 16, 12
BEAUTY = dict(spp=1, max_bounces=3, tonemap="none", russian_roulette=False)


def jax_grads(jscene, kw, target, frame):
    cfg = JConfig(width=jscene.width, height=jscene.height, accel="none", **kw)
    g = jax.jit(jax.grad(lambda p: j_render_loss(p, jscene, jnp.asarray(target), cfg,
                                                 jnp.asarray(frame, jnp.int32))))(
        j_extract_params(jscene))
    return {k: np.asarray(v) for k, v in g._asdict().items()}


def port_grads(scene, kw, target, frame, accel):
    cfg = RenderConfig(width=scene.width, height=scene.height, accel=accel, **kw)
    isect = None if accel == "none" else make_training_intersector(scene, cfg, True)
    params = TrainableParams(*(x.clone().requires_grad_(True) for x in extract_params(scene)))
    render_loss(params, scene, torch.as_tensor(target), cfg, frame, isect).backward()
    # A leaf the loss does not reach has no gradient: zero, as jax.grad says.
    return {k: (torch.zeros_like(v) if v.grad is None else v.grad).numpy()
            for k, v in params._asdict().items()}


def assert_grads_close(got, ref, name):
    scale = np.abs(ref).max()
    big = np.abs(ref) >= 1e-3 * scale
    np.testing.assert_allclose(got[big], ref[big], rtol=1e-3, atol=0, err_msg=name)
    np.testing.assert_allclose(got[~big], ref[~big], rtol=0, atol=1e-6 * scale, err_msg=name)


def textured_sphere(builder):
    """A sphere under a white sky with a 4x4 basecolor map from seed 0."""
    b = builder(W, H)
    b.set_sky_color((1.0, 1.0, 1.0))
    m = b.add_material((1.0, 1.0, 1.0), 1.0, 0.0)
    img = np.random.default_rng(0).uniform(0.2, 0.9, (4, 4, 4)).astype(np.float32)
    b.set_material_texture(m, 0, b.add_texture(img))
    b.add_sphere((0.0, 0.0, -3.0), 1.0, m, steps=8)
    b.set_camera(eye=(0, 0, 1), center=(0, 0, -3), up=(0, 1, 0), fov_degrees=60)
    return b


def triangle(builder):
    """One triangle facing the camera over a black sky
    (tests/test_gradients.py::_tri_depth_scene)."""
    b = builder(16, 16)
    b.set_sky_color((0, 0, 0))
    m = b.add_material((0.5, 0.5, 0.5), 1.0, 0.0)
    b.add_triangle((-2, -2, -3), (2, -2, -3), (0, 2, -3), m)
    b.set_camera(eye=(0, 0, 2), center=(0, 0, -3), up=(0, 1, 0), fov_degrees=60)
    return b


@pytest.fixture(scope="module")
def furnace():
    b = j_load_scene(FURNACE)
    b.width, b.height = W, H
    return from_jax_arrays(b.build(), device="cpu")


# (scene, render settings, leaves compared, of which these are nonzero);
# jax.grad runs once per case. Roughness only steers directions, which the
# radiance here does not depend on: both packages give it 0.
CASES = {
    "beauty": ("default", BEAUTY, ("albedo", "emissive", "roughness", "metalness"),
               ("albedo", "emissive", "metalness")),
    "texture": ("textured", BEAUTY, ("tex_data", "albedo"), ("tex_data",)),
    "depth": ("default", dict(aov="depth", tonemap="none"), ("vertex_pos",), ("vertex_pos",)),
    "normals": ("default", dict(aov="normals", tonemap="none"), ("vertex_pos",),
                ("vertex_pos",)),
}


@pytest.fixture(scope="module", params=list(CASES))
def reference(request):
    kind, kw, leaves, nonzero = CASES[request.param]
    js = (j_default_scene(W, H) if kind == "default" else textured_sphere(JSceneBuilder)).build()
    target = np.full((H, W, 3), 0.3, np.float32)
    return (from_jax_arrays(js, device="cpu"), kw, leaves, nonzero, target,
            jax_grads(js, kw, target, 2))


@pytest.mark.parametrize("accel", ["none", "packet"])
def test_gradients_match_jax(reference, accel):
    scene, kw, leaves, nonzero, target, ref = reference
    got = port_grads(scene, kw, target, 2, accel)
    for name in leaves:
        assert (np.abs(ref[name]).max() > 0) == (name in nonzero), name
        assert_grads_close(got[name], ref[name], name)


def test_albedo_gradient_matches_fd(furnace):
    cfg = RenderConfig(width=W, height=H, spp=2, accel="packet", **{
        k: v for k, v in BEAUTY.items() if k != "spp"})
    isect = make_training_intersector(furnace, cfg, needs_geometry_grads=False)
    params = extract_params(furnace)
    target = torch.full((H, W, 3), 0.5)

    def f(albedo):
        return render_loss(params._replace(albedo=albedo), furnace, target, cfg, 0, isect)

    albedo = params.albedo.clone().requires_grad_(True)
    f(albedo).backward()
    h = 1e-3
    e = torch.zeros_like(albedo)
    e[1, 0] = 1.0
    with torch.no_grad():
        fd = (f(params.albedo + h * e) - f(params.albedo - h * e)) / (2 * h)
    g = float(albedo.grad[1, 0])
    np.testing.assert_allclose(g, float(fd), rtol=2e-2)
    assert g != 0.0


@pytest.mark.parametrize("accel", ["none", "packet"])
def test_vertex_gradient_matches_fd(accel):
    """Mean depth against a global z shift of the vertices."""
    scene = triangle(SceneBuilder).build(device="cpu")
    cfg = RenderConfig(width=16, height=16, aov="depth", tonemap="none", accel=accel)
    isect = None if accel == "none" else make_training_intersector(scene, cfg, True)
    params = extract_params(scene)
    zero = torch.zeros((16, 16, 3))

    def f(vpos):  # the loss is the mean squared depth
        return render_loss(params._replace(vertex_pos=vpos), scene, zero, cfg, 0, isect)

    vpos = params.vertex_pos.clone().requires_grad_(True)
    f(vpos).backward()
    assert torch.isfinite(vpos.grad).all()
    dz = float(vpos.grad[:, 2].sum())
    h = 1e-3
    shift = torch.zeros_like(vpos)
    shift[:, 2] = 1.0
    with torch.no_grad():
        fd = (f(params.vertex_pos + h * shift) - f(params.vertex_pos - h * shift)) / (2 * h)
    np.testing.assert_allclose(dz, float(fd), rtol=2e-2)
    assert dz < 0  # moving the triangle towards the camera shortens the depth


def test_geometry_recompute_matches_its_base(furnace):
    cfg = RenderConfig(width=W, height=H, accel="packet")
    isect = make_training_intersector(furnace, cfg, needs_geometry_grads=True)
    assert isinstance(isect, GeometryDiffIntersector)
    rng = np.random.default_rng(3)
    s, t = (torch.as_tensor(rng.uniform(size=512).astype(np.float32)) for _ in range(2))
    o, d = furnace.camera.generate_rays(s, t)
    act = torch.ones((512,), dtype=torch.bool)
    base = isect(o, d, act)
    bound = isect.bind(furnace)(o, d, act)
    m = base.hit.mask
    assert m.any() and (~m).any() and torch.equal(bound.hit.mask, m)
    np.testing.assert_allclose(bound.hit.t[m].numpy(), base.hit.t[m].numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(bound.hit.uv[m].numpy(), base.hit.uv[m].numpy(), atol=1e-4)
    np.testing.assert_allclose(bound.normal[m].numpy(), base.normal[m].numpy(), atol=1e-4)
    assert torch.equal(bound.material, base.material) and torch.equal(bound.hit.tri, base.hit.tri)
    assert torch.equal(bound.hit.t[~m], base.hit.t[~m])


def test_compaction_leaves_gradients_bit_identical():
    """Material gradients of a beauty frame (bounce 0 uncompacted, the
    rest compacted) and vertex gradients of the depth AOV (compacted, no
    bounce-0 peel) with wave compaction and without."""
    scene = from_jax_arrays(j_default_scene(32, 32).build(), device="cpu")
    target = torch.full((32, 32, 3), 0.3)
    out = {}
    for group in (0, 1024):
        cfg = RenderConfig(width=32, height=32, spp=1, max_bounces=2, tonemap="none",
                           wave_compact_group=group)
        params = TrainableParams(*(x.clone().requires_grad_(True)
                                   for x in extract_params(scene)))
        isect = make_training_intersector(scene, cfg, needs_geometry_grads=False)
        assert hasattr(isect, "first") == (group > 0)
        loss = render_loss(params, scene, target, cfg, 1, isect)
        loss.backward()
        dcfg = cfg.replace(aov="depth", wave_compact_skip_first=False)
        vpos = params.vertex_pos.detach().clone().requires_grad_(True)
        geo = make_training_intersector(scene, dcfg, needs_geometry_grads=True)
        dloss = render_loss(params._replace(vertex_pos=vpos), scene, target, dcfg, 1, geo)
        dloss.backward()
        out[group] = (loss.item(), params.albedo.grad, params.emissive.grad, dloss.item(),
                      vpos.grad)
    assert out[0][0] == out[1024][0] and out[0][3] == out[1024][3]
    for a, b in zip(out[0][1:], out[1024][1:]):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert out[0][4].abs().max() > 0


def test_train_step_matches_optax(furnace):
    """3 steps of the port's make_train_step (torch.optim.Adam) against
    tracy_tpu's (optax.adam), training the grey sphere's albedo only."""
    cfg_kw = dict(spp=2, max_bounces=3, tonemap="none", russian_roulette=False)
    jb = j_load_scene(FURNACE)
    jb.width, jb.height = W, H
    js = jb.build()
    base = j_extract_params(js)
    jmask = jax.tree_util.tree_map(lambda x: jnp.zeros_like(x, bool), base)
    jmask = jmask._replace(albedo=jmask.albedo.at[1].set(True))
    target = np.full((H, W, 3), 0.6, np.float32)
    jcfg = JConfig(width=W, height=H, accel="none", **cfg_kw)
    jstep, jopt = j_make_train_step(js, jcfg, optax.adam(1e-2), trainable_mask=jmask)
    jparams = base

    cfg = RenderConfig(width=W, height=H, accel="none", **cfg_kw)
    mask = TrainableParams(*(torch.zeros(x.shape, dtype=torch.bool)
                             for x in extract_params(furnace)))
    mask.albedo[1] = True
    step, params, opt = make_train_step(furnace, cfg, trainable_mask=mask)
    assert isinstance(opt, torch.optim.Adam) and opt.defaults["lr"] == 1e-2
    assert [p.requires_grad for p in params] == [True] + [False] * 7
    for i in range(3):
        jparams, jopt, jloss = jstep(jparams, jopt, jnp.asarray(target),
                                     jnp.asarray(i, jnp.int32))
        params, opt, loss = step(params, opt, torch.as_tensor(target), i)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(params.albedo.detach().numpy(), np.asarray(jparams.albedo),
                                   rtol=1e-5, atol=0)
    assert not np.array_equal(params.albedo.detach().numpy()[1], np.asarray(base.albedo)[1])
    assert torch.equal(params.albedo[0], furnace.materials.albedo[0])
    for name in TrainableParams._fields[1:]:
        assert torch.equal(getattr(params, name), getattr(extract_params(furnace), name)), name


def test_roulette_gradients_finite(furnace):
    cfg = RenderConfig(width=W, height=H, spp=1, max_bounces=5, tonemap="none",
                       russian_roulette=True, accel="packet")
    isect = make_training_intersector(furnace, cfg, needs_geometry_grads=True)
    params = TrainableParams(*(x.clone().requires_grad_(True) for x in extract_params(furnace)))
    before = k2.COUNT_DIFF.plain, k1.COUNT.plain, k2.COUNT.plain
    render_loss(params, furnace, torch.full((H, W, 3), 0.5), cfg, 0, isect).backward()
    # The differentiable bounce 5 times, K1's plain version 5 times, K2 never.
    assert (k2.COUNT_DIFF.plain - before[0], k1.COUNT.plain - before[1],
            k2.COUNT.plain - before[2]) == (5, 5, 0)
    for name, p in params._asdict().items():
        if p.grad is not None:
            assert torch.isfinite(p.grad).all(), name
    assert params.albedo.grad.abs().max() > 0


@pytest.mark.parametrize("aov", ["beauty", "basecolor"])
def test_textured_loss_reads_texels_through_the_plain_gather(aov):
    """render_loss picks the differentiable texel route itself: each
    textured bounce, or the textured AOV, gathers with K3's plain version
    (counted as K3's plain), never through K3's or K4's wrapper, and the
    texel gradient is nonzero."""
    scene = textured_sphere(SceneBuilder).build(device="cpu")
    cfg = RenderConfig(width=W, height=H, accel="packet", **(
        BEAUTY if aov == "beauty" else dict(aov=aov, tonemap="none")))
    isect = make_training_intersector(scene, cfg, needs_geometry_grads=False)
    params = TrainableParams(*(x.clone().requires_grad_(True) for x in extract_params(scene)))
    counts = (k2.COUNT_DIFF, k3.COUNT, k2.COUNT_TEX)
    before = [(c.plain, c.kernel) for c in counts]
    render_loss(params, scene, torch.full((H, W, 3), 0.3), cfg, 0, isect).backward()
    bounces = cfg.max_bounces if aov == "beauty" else 0
    assert [(c.plain - p, c.kernel - k) for c, (p, k) in zip(counts, before)] == [
        (bounces, 0), (bounces or 1, 0), (0, 0)]
    assert torch.isfinite(params.tex_data.grad).all()
    assert params.tex_data.grad.abs().max() > 0


def test_inverse_rendering_recovers_albedo(furnace):
    """The grey sphere's albedo from 0.18 to a target rendered at 0.6, at
    one fixed RNG frame (so the objective's minimum is exactly 0.6)."""
    cfg = RenderConfig(width=W, height=H, spp=1, max_bounces=3, tonemap="none",
                       russian_roulette=False, accel="packet")
    isect = make_training_intersector(furnace, cfg, needs_geometry_grads=False)
    truth = extract_params(furnace)
    truth = truth._replace(albedo=truth.albedo.clone())
    truth.albedo[1] = 0.6
    with torch.no_grad():
        from tracy_tpu_torch.render.renderer import sample_radiance
        target, _ = sample_radiance(dataclasses.replace(
            furnace, materials=dataclasses.replace(furnace.materials, albedo=truth.albedo)),
            cfg, 7, isect)
    mask = TrainableParams(*(False,) * 8)._replace(albedo=torch.tensor([[0], [1]]).bool())
    step, params, opt = make_train_step(
        furnace, cfg, optimizer=lambda p: torch.optim.Adam(p, lr=0.1), intersect_fn=isect,
        trainable_mask=mask)
    losses = []
    for _ in range(40):
        params, opt, loss = step(params, opt, target, 7)
        losses.append(float(loss))
    np.testing.assert_allclose(params.albedo[1].detach().numpy(), 0.6, atol=0.05)
    assert losses[-1] < losses[0] * 0.01


def test_params_from_jax(furnace):
    b = j_load_scene(FURNACE)
    b.width, b.height = W, H
    got = params_from_jax(j_extract_params(b.build()), device="cpu")
    for name, x in got._asdict().items():
        assert x.dtype == torch.float32
        assert torch.equal(x, getattr(extract_params(furnace), name)), name


def test_sqrt_gradient():
    x = torch.tensor([4.0, 2.0, 1e-6, 0.0, -1.0], requires_grad=True)
    y = tm.sqrt(torch.clamp(x, min=0.0))
    # Only the positive lanes are read, as where() reads a clamped root.
    torch.where(x > 0.0, y, torch.zeros(())).sum().backward()
    np.testing.assert_allclose(x.grad[:3].numpy(), 0.5 / np.sqrt([4.0, 2.0, 1e-6]),
                               rtol=1e-6)
    assert torch.equal(x.grad[3:], torch.zeros(2))
    v = torch.zeros((2, 3), requires_grad=True)
    tm.normalize(v).sum().backward()  # |v| clamped: finite
    assert torch.isfinite(v.grad).all()
