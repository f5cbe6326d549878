"""The port's first-hit AOVs, bands of rows and samples, and progressive
rendering, on the CPU.

* trace_aov: the six AOVs (basecolor, normals through the view rotation,
  metalness, roughness, emissive, depth) of the same rays (the port's
  jittered camera rays, as numpy) through the port (K1's plain version
  over the 4-wide BVH, also compacted; K3's plain version on the textured
  scene) and through tracy_tpu's trace_aov (its brute-force intersector,
  one jax.jit for all six), on default_scene and on
  tests/test_pallas_texfetch.py's textured fixture (five texture slots,
  an equirect sky) at 32x24: within 1e-5 absolute, misses 0. Both sides
  pick the same triangle; an equal-t tie could part them (not seen here).
* The Renderer's AOV frames against tracy_tpu's sample_radiance (accel
  'none', one jax.jit): ray counts (num_rows * W a sample) equal, misses
  0, values within 1e-5 + 1e-4 relative. The relative term is for the
  rays, not the AOVs: XLA's jitted ray generation differs from its eager
  one (and the port's, which equals the eager one) by an ulp in a third
  of the directions, and a grazing ray 20 units down the floor turns
  that into about 1e-5 of its depth.
* A band of rows is the full frame's rows, bit for bit, whatever tile
  shape the band's row count picks; two spp_count=1 halves of an spp=2
  frame average to the full frame within 1e-6.
* render_progressive equals step_many.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracy_tpu.config import RenderConfig as JConfig
from tracy_tpu.render.integrator import make_bruteforce_intersector as j_bruteforce
from tracy_tpu.render.integrator import trace_aov as j_trace_aov
from tracy_tpu.render.renderer import sample_radiance as j_sample_radiance
from tracy_tpu.scene.scn_parser import default_scene as j_default_scene
from tracy_tpu_torch import RenderConfig
from tracy_tpu_torch.accel.reorder import compact_intersector
from tracy_tpu_torch.accel.tables import build_tables
from tracy_tpu_torch.core.camera import pixel_samples_rows
from tracy_tpu_torch.ops import intersect as k1
from tracy_tpu_torch.ops import shade as k2
from tracy_tpu_torch.ops import texfetch as k3
from tracy_tpu_torch.render.integrator import trace_aov
from tracy_tpu_torch.render.renderer import (
    Renderer,
    init_state,
    pick_tile,
    sample_radiance_rows,
)
from tracy_tpu_torch.scene import default_scene, from_jax_arrays
from test_torch_textures import textured_builders

torch.set_num_threads(2)

AOVS = ("basecolor", "normals", "metalness", "roughness", "emissive", "depth")
W, H = 32, 24


def camera_rays(scene, seed: int = 7):
    """The port's camera rays through jittered pixel samples, [H*W, 3] each."""
    rng = np.random.default_rng(seed)
    ju, jv = (torch.as_tensor(rng.uniform(size=(H, W)).astype(np.float32)) for _ in range(2))
    s, t = pixel_samples_rows(W, H, torch.arange(H, dtype=torch.int32), ju, jv)
    o, d = scene.camera.generate_rays(s, t)
    return o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()


def jax_aovs(jscene, o, d):
    """All six AOVs in one jitted tracy_tpu program: trace_aov on the rays
    (o, d), and sample_radiance's frame 0."""
    cfgs = {a: JConfig(width=W, height=H, aov=a, tonemap="none", accel="none")
            for a in AOVS}

    def run(s, o, d):
        return {a: (j_trace_aov(s, o, d, c, j_bruteforce(s)),
                    j_sample_radiance(s, c, jnp.asarray(0, jnp.int32))) for a, c in cfgs.items()}

    out = jax.jit(run)(jscene, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    return {a: (np.asarray(aov), np.asarray(img), int(rays))
            for a, (aov, (img, rays)) in out.items()}


@pytest.fixture(scope="module", params=["default", "textured"])
def scenes(request):
    if request.param == "default":
        js = j_default_scene(W, H).build()
    else:
        js = textured_builders()[0].build()
    scene = from_jax_arrays(js, device="cpu")
    o, d = camera_rays(scene)
    return request.param, scene, (o, d), jax_aovs(js, o, d)


@pytest.mark.parametrize("group", [0, 1024])
def test_trace_aov_matches_jax(scenes, group):
    name, scene, (o, d), ref = scenes
    tables = build_tables(scene, width=4)

    def isect(o_, d_, a_):
        return k1.intersect(o_, d_, a_, tables)

    fn = compact_intersector(isect, group) if group else isect
    before = (k1.COUNT.plain, k3.COUNT.plain)
    out = {}
    for aov in AOVS:
        cfg = RenderConfig(width=W, height=H, aov=aov)
        out[aov] = trace_aov(scene, o, d, cfg, fn).numpy()
        np.testing.assert_allclose(out[aov], ref[aov][0], rtol=0, atol=1e-5, err_msg=aov)
    textured = int(name == "textured")
    assert (k1.COUNT.plain - before[0], k3.COUNT.plain - before[1]) == (6, 6 * textured)
    miss = out["depth"][:, 0] == 0.0
    assert miss.any() and (~miss).any()
    for aov in AOVS:
        assert (out[aov][miss] == 0.0).all(), aov
    assert (out["normals"][~miss] > 0.0).all() and (out["basecolor"][~miss] > 0.0).any()


@pytest.mark.parametrize("group", [0, 1024])
def test_renderer_aovs_match_jax(scenes, group):
    name, scene, _, ref = scenes
    counts = (k1.COUNT, k2.COUNT, k3.COUNT, k2.COUNT_TEX)
    for aov in AOVS:
        cfg = RenderConfig(width=W, height=H, aov=aov, tonemap="none",
                           wave_compact_group=group)
        r = Renderer(cfg)
        before = [c.plain for c in counts]
        st, rays = r.step(scene, init_state(cfg, "cpu"))
        # The intersector once, K3 once on the textured scene, no shading.
        assert [c.plain - b for c, b in zip(counts, before)] == \
            [1, 0, int(name == "textured"), 0]
        assert r.path == "aov"
        img = st.accum.numpy()
        assert img.shape == (H, W, 3) and np.isfinite(img).all()
        np.testing.assert_allclose(img, ref[aov][1], rtol=1e-4, atol=1e-5, err_msg=aov)
        assert (img[ref["depth"][1][..., 0] == 0.0] == 0.0).all()
        assert rays == ref[aov][2] == W * H


def test_bands_equal_the_full_frame():
    """Bands of rows, each tiled by its own row count, give the full
    frame's rows bit for bit (beauty and an AOV); sample splits average to
    the full frame."""
    w, h = 64, 48
    scene = default_scene(w, h).build(device="cpu")
    tables = build_tables(scene, width=4)

    def isect(o_, d_, a_):
        return k1.intersect(o_, d_, a_, tables)

    def render(c, frame, **band):
        return sample_radiance_rows(scene, c, frame, isect, **band)

    cfg = RenderConfig(width=w, height=h, spp=2, max_bounces=3)
    full, rays = render(cfg, 3)
    bands = ((0, 20), (20, 28))
    # The bands fold into 32x32 tiles, the full frame into 16x64 ones.
    assert {pick_tile(n, w) for _, n in bands} == {(32, 32)} and pick_tile(h, w) == (16, 64)
    parts = [render(cfg, 3, row_offset=o, num_rows=n) for o, n in bands]
    assert torch.equal(torch.cat([p for p, _ in parts]), full)
    assert sum(int(r) for _, r in parts) == int(rays)
    halves = [render(cfg, 3, spp_offset=s, spp_count=1, total_spp=2)[0] for s in (0, 1)]
    assert float(((halves[0] + halves[1]) / 2 - full).abs().max()) <= 1e-6
    one = render(cfg.replace(spp=1), 3 * 2 + 1)[0]
    assert torch.equal(halves[1], one)  # sample 1 of frame 3 is key 3 * 2 + 1

    dcfg = cfg.replace(aov="depth", spp=1)
    dfull, drays = render(dcfg, 0)
    dparts = [render(dcfg, 0, row_offset=o, num_rows=n) for o, n in bands]
    assert torch.equal(torch.cat([p for p, _ in dparts]), dfull)
    assert int(drays) == w * h and [int(r) for _, r in dparts] == [20 * w, 28 * w]


def test_render_progressive_equals_step_many():
    scene = default_scene(W, H).build(device="cpu")
    cfg = RenderConfig(width=W, height=H, spp=1, max_bounces=2)
    st = Renderer(cfg).render_progressive(scene, 5, steps_per_dispatch=2)
    ref, _ = Renderer(cfg).step_many(scene, init_state(cfg, "cpu"), 5)
    assert st.frame == ref.frame == 5
    assert torch.equal(st.accum, ref.accum)
    more = Renderer(cfg).render_progressive(scene, 3, state=Renderer(cfg).render_progressive(
        scene, 2))
    assert torch.equal(more.accum, ref.accum)
