"""The render settings tracy_tpu renders besides the main path's, through
the port on the CPU: the counter hashes 'xorshift' and 'lcg' and
jax.random's 'threefry' (the shade stages K2, K4 and K5 draw from cfg.rng's
kind) and the intersectors
accel='bvh' (K1 over the binary tables) and accel='none' (the brute-force
intersector), against tracy_tpu's XLA path (use_pallas=False: on a TPU
tracy_tpu's Pallas shade hashes 'fast' whatever cfg.rng says, so only its
XLA path is the reference for the other kinds).

* trace_paths, 2 bounces, on the same numpy-made rays of cornell, with the
  brute-force intersector on both sides (tracy_tpu's under jax.jit): both
  draw the same random numbers, so the paths are the same paths; a lane
  may still part where an ulp of torch CPU vs XLA CPU flips a discrete
  decision (a Russian-roulette draw against a throughput, say), so at most
  0.5% of lanes differ by more than rtol 1e-4 / atol 1e-5 in radiance, and
  ray counts agree within 0.1%;
* trace_bounce_plain (K5's plain version) at each kind against K1's plain
  version then K2's on the same lanes: equal, as K5 equals K1 then K2;
* 2-frame renders of cornell at 32x32 at rng='lcg' and 'threefry' (accel
  'packet', the
  port's default) and at accel='bvh' and 'none', against tracy_tpu's
  Renderer(accel='bvh', use_pallas=False) at the same rng, under
  tests/test_torch_render.py's contract (mean 1e-3, p95 5e-3, max 0.05 in
  linear radiance; rays within 0.1%);
* the shade stages (K2 and K4) update their state in place: trace_paths
  works on copies, so the caller's rays and mask are left as they were;
* a render at pallas_bvh_width=8 (K1's plain version on the 8-wide tree)
  against tracy_tpu's Renderer at pallas_bvh_width=8 (its XLA path on the
  CPU), under the same block-mean contract.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracy_tpu.config import RenderConfig as JConfig
from tracy_tpu.render.integrator import make_bruteforce_intersector as j_bruteforce
from tracy_tpu.render.integrator import trace_paths as j_trace_paths
from tracy_tpu.render.renderer import Renderer as JRenderer
from tracy_tpu.render.renderer import init_state as j_init_state
from tracy_tpu.scene.scn_parser import load_scene as j_load_scene
from tracy_tpu_torch import RenderConfig
from tracy_tpu_torch.accel.tables import build_tables
from tracy_tpu_torch.ops import bounce as k5
from tracy_tpu_torch.ops import intersect as k1
from tracy_tpu_torch.ops import shade as k2
from tracy_tpu_torch.ops.compare import canned_lanes
from tracy_tpu_torch.render.integrator import make_bruteforce_intersector, trace_paths
from tracy_tpu_torch.render.renderer import Renderer, init_state
from tracy_tpu_torch.scene import from_jax_arrays
from test_torch_intersect import make_rays
from test_torch_render import assert_images_agree
from test_torch_textures import textured_builders

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(REPO, "tests", "goldens", "scn", "cornell.scn")
SEED = 0xABCDEF
N = 2048


@pytest.fixture(scope="module")
def cornell():
    b = j_load_scene(CORNELL)
    b.width = b.height = 32
    js = b.build()
    return js, from_jax_arrays(js, device="cpu")


@pytest.fixture(scope="module")
def jax_renders(cornell):
    """tracy_tpu's XLA renders of cornell at 32x32, 2 frames, by rng."""
    js, _ = cornell
    out = {}

    def render(rng):
        if rng not in out:
            cfg = JConfig(width=32, height=32, spp=1, accel="bvh", use_pallas=False, rng=rng)
            jr = JRenderer(cfg)
            jst, _ = jr.step_many(js, j_init_state(cfg), 2)
            out[rng] = (np.asarray(jst.accum), jr.total_rays)
        return out[rng]

    return render


@pytest.mark.parametrize("kind", ["xorshift", "lcg", "threefry"])
def test_trace_paths_rng_kinds_match_jax(cornell, kind):
    js, scene = cornell
    origin, direction = make_rays(scene, N, seed=21)
    pix = np.random.default_rng(22).integers(0, 1 << 20, N).astype(np.int32)
    skey = 3
    jcfg = JConfig(width=32, height=32, spp=1, max_bounces=2, rng=kind, use_pallas=False)
    ref, jrays = jax.jit(lambda o, d, p: j_trace_paths(
        js, o, d, p, jnp.uint32(skey), jcfg, j_bruteforce(js)))(
        jnp.asarray(origin), jnp.asarray(direction), jnp.asarray(pix.astype(np.uint32)))
    ref = np.asarray(ref)

    cfg = RenderConfig(width=32, height=32, spp=1, max_bounces=2, rng=kind)
    o, d, p = torch.as_tensor(origin), torch.as_tensor(direction), torch.as_tensor(pix)
    isect = make_bruteforce_intersector(scene)
    got, rays = trace_paths(scene, o, d, p, skey, cfg, isect)
    got = got.numpy()
    assert abs(int(rays) - int(jrays)) <= 1e-3 * int(jrays)
    lit = (ref > 0).any(axis=1)
    assert np.isfinite(got).all() and lit.sum() >= 10, lit.sum()
    far = ~np.isclose(got, ref, rtol=1e-4, atol=1e-5).all(axis=1)
    assert far.mean() <= 5e-3, far.mean()
    # The kind reaches the shade stage: 'fast' draws other paths (a lit
    # lane that saw the light directly is lit whatever the hash).
    fast, _ = trace_paths(scene, o, d, p, skey, cfg.replace(rng="fast"), isect)
    assert (fast.numpy() != got).any(axis=1)[lit].sum() >= 3


@pytest.mark.parametrize("kind", ["xorshift", "lcg", "threefry"])
def test_bounce_plain_rng_kinds_equal_k1_then_k2(cornell, kind):
    _, scene = cornell
    tables = build_tables(scene, width=4)
    mtab = k2.build_material_table(scene.materials)
    lanes = canned_lanes(mtab.shape[0], N, seed=23, device="cpu")
    origin, direction = make_rays(scene, N, seed=24)
    o, d = torch.as_tensor(origin), torch.as_tensor(direction)
    a, thr, rad, pix = lanes["alive"], lanes["throughput"], lanes["radiance"], lanes["pixel_idx"]
    kw = dict(seed=SEED, russian_roulette=True)
    got = k5.trace_bounce(o, d, thr, rad, a, pix, 3, 1, tables=tables, mtab=mtab, rng=kind,
                          **kw)
    sh = k1.intersect_plain(o, d, a, tables)

    def state():  # K2 updates the state in place: each call gets a copy
        return (x.clone() for x in (o, d, thr, rad, a))

    want = k2.shade(*state(), pix, sh.hit.mask, sh.hit.t, sh.normal, sh.material,
                    mtab, 3, 1, rng=kind, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    fast = k2.shade(*state(), pix, sh.hit.mask, sh.hit.t, sh.normal, sh.material,
                    mtab, 3, 1, **kw)
    assert not torch.equal(fast[1], got[1])


@pytest.mark.parametrize("setting", [dict(rng="lcg"), dict(rng="threefry"), dict(accel="bvh"),
                                     dict(accel="none")],
                         ids=["rng-lcg", "rng-threefry", "accel-bvh", "accel-none"])
def test_render_settings_match_jax(cornell, jax_renders, setting):
    js, scene = cornell
    cfg = RenderConfig(width=32, height=32, spp=1, **setting)
    r = Renderer(cfg)
    counts = (k1.COUNT, k2.COUNT)
    before = [c.plain for c in counts]
    st, rays = r.step_many(scene, init_state(cfg, "cpu"), 2)
    ran = [c.plain - b for c, b in zip(counts, before)]
    runs = 2 * cfg.max_bounces
    # 'none' intersects without K1; K2 shades every bounce.
    assert ran == [0 if cfg.accel == "none" else runs, runs]
    if cfg.accel == "none":
        assert r.tables is None
    else:
        assert r.tables.width == (2 if cfg.accel == "bvh" else cfg.pallas_bvh_width)
    ref, jrays = jax_renders(cfg.rng)
    assert_images_agree(st.accum.numpy(), rays, ref, jrays)


def test_settings_are_bound_as_tracy_tpu_binds_them(cornell):
    _, scene = cornell
    # rng 'threefry' binds as the other kinds do: the two-stage path (K2)
    # and the fused one (K5, compacted, bounce 0 peeled) both draw from it
    # and render the same frame, which the 'fast' hash does not.
    frames = {}
    for rng, fused in (("threefry", False), ("threefry", True), ("fast", False)):
        cfg = RenderConfig(width=32, height=32, max_bounces=2, rng=rng,
                           wave_compact_group=1024, use_pallas_bounce=fused)
        r = Renderer(cfg)
        st, _ = r.step(scene, init_state(cfg, "cpu"))
        assert r.path == ("fused" if fused else "two-stage")
        frames[(rng, fused)] = st.accum
    assert torch.equal(frames[("threefry", False)], frames[("threefry", True)])
    assert not torch.equal(frames[("threefry", False)], frames[("fast", False)])
    # 'tlas' is K1 on the stitched tables (tests/test_torch_tlas.py):
    # compaction wraps it, bounce 0 peeled; the fused bounce does not.
    r = Renderer(RenderConfig(width=32, height=32, accel="tlas", wave_compact_group=1024,
                              use_pallas_bounce=True))
    r.prepare(scene)
    assert r.path == "two-stage" and list(r._paths) == ["first_intersect_fn"]
    assert "compact" in r._intersect.__qualname__ and r.two_level is not None
    # Compaction and the fused bounce wrap neither 'bvh' nor 'none'.
    for accel in ("bvh", "none"):
        r = Renderer(RenderConfig(width=32, height=32, accel=accel, wave_compact_group=1024,
                                  use_pallas_bounce=True))
        r.prepare(scene)
        assert r.path == "two-stage" and r._paths == {}
        assert "compact" not in getattr(r._intersect, "__qualname__", "")
        assert (r.tables is None) == (accel == "none")


def test_textured_trace_paths_leaves_the_callers_tensors(cornell):
    _, port_builder = textured_builders()
    scene = port_builder.build(device="cpu")
    cfg = RenderConfig(width=32, height=24, spp=1, max_bounces=3)
    origin, direction = make_rays(scene, 512, seed=25)
    o, d = torch.as_tensor(origin), torch.as_tensor(direction)
    active = torch.as_tensor(np.random.default_rng(26).uniform(size=512) < 0.9)
    pix = torch.arange(512, dtype=torch.int32)
    keep = [x.clone() for x in (o, d, active)]
    before = k2.COUNT_TEX.plain
    radiance, rays = trace_paths(scene, o, d, pix, 1, cfg,
                                 make_bruteforce_intersector(scene), active0=active)
    assert k2.COUNT_TEX.plain == before + cfg.max_bounces
    assert int(rays) > 512 and (radiance > 0).any()
    for x, y in zip((o, d, active), keep):
        assert torch.equal(x, y)


@pytest.mark.parametrize("group", [0, 1024])
def test_trace_paths_leaves_the_callers_tensors(cornell, group):
    """The untextured shade stage (K2) updates the state in place too, with
    and without compaction: the caller's rays and mask stay as they were,
    and the radiance equals a run on copies of them."""
    from tracy_tpu_torch.accel.reorder import compact_intersector

    _, scene = cornell
    cfg = RenderConfig(width=32, height=32, spp=1, max_bounces=3)
    tables = build_tables(scene, width=4)
    origin, direction = make_rays(scene, 1024, seed=27)
    o, d = torch.as_tensor(origin), torch.as_tensor(direction)
    active = torch.as_tensor(np.random.default_rng(28).uniform(size=1024) < 0.9)
    pix = torch.arange(1024, dtype=torch.int32)
    keep = [x.clone() for x in (o, d, active, pix)]

    def isect(o_, d_, a_):
        return k1.intersect(o_, d_, a_, tables)

    fn = compact_intersector(isect, group) if group else isect
    before = k2.COUNT.plain
    radiance, rays = trace_paths(scene, o, d, pix, 1, cfg, fn, active0=active)
    assert k2.COUNT.plain == before + cfg.max_bounces
    assert int(rays) > 1024 and (radiance > 0).any()
    for x, y in zip((o, d, active, pix), keep):
        assert torch.equal(x, y)
    again, _ = trace_paths(scene, *(x.clone() for x in (o, d)), pix, 1, cfg, fn,
                           active0=active.clone())
    assert torch.equal(again, radiance)


def test_width8_render_matches_jax(cornell):
    js, scene = cornell
    cfg = RenderConfig(width=32, height=32, spp=1, pallas_bvh_width=8)
    r = Renderer(cfg)
    before = k1.COUNT.plain
    st, rays = r.step_many(scene, init_state(cfg, "cpu"), 2)
    assert r.tables.width == 8 and r.tables.wide.shape[1] == 64
    assert k1.COUNT.plain == before + 2 * cfg.max_bounces
    jcfg = JConfig(width=32, height=32, spp=1, accel="packet", pallas_bvh_width=8)
    jr = JRenderer(jcfg)
    jst, _ = jr.step_many(js, j_init_state(jcfg), 2)
    assert_images_agree(st.accum.numpy(), rays, np.asarray(jst.accum), jr.total_rays)
