"""rng='threefry' (jax.random's Threefry-2x32 plus the 'fast' mix) through
the port on the CPU, against tracy_tpu's XLA path, and `ray_chunk`.

A threefry draw's counter is the element's position in the array it is
drawn over (core/rng.py), so the port must draw over the arrays tracy_tpu
draws over: the band's jitter grid, the wave's flat lanes (tiled on
'packet' and 'tlas' only, as tracy_tpu folds tiles), each chunk's lanes
under ray_chunk, and under compaction each slot's original lane.

* the textured bounce (K4's plain version) in trace_paths at threefry
  against tracy_tpu's trace_paths, 2 bounces on the same rays: both draw
  the same numbers, so at most 0.5% of lanes part by more than rtol 1e-4
  / atol 1e-5 (an ulp of torch CPU vs XLA CPU can flip a discrete
  decision; tests/test_torch_settings.py's contract);
* furnace.scn at 64x48, 4 frames, at threefry against tracy_tpu's render
  (accel 'bvh', use_pallas=False) by tests/test_ref_parity.py's block-mean
  contract (|mean| <= 0.01, p95 <= 0.02, max <= 0.05 in linear radiance
  of the 8-bit images), and by tests/test_torch_render.py's tighter one
  for renders that draw the same numbers;
* ray_chunk: at 'fast' a chunked render (two-stage and fused, compacted)
  equals the whole one bit for bit; at threefry each chunk draws over its
  own lanes, so the chunked frame differs from the whole one and agrees
  with tracy_tpu's chunked frame (its lax.map over chunks);
* K5's plain version under compact_bounce at threefry draws at each
  slot's original lane: equal to K5 uncompacted and to K1 then K2.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tracy_tpu.config import RenderConfig as JConfig
from tracy_tpu.render import film as j_film
from tracy_tpu.render.integrator import make_bruteforce_intersector as j_bruteforce
from tracy_tpu.render.integrator import trace_paths as j_trace_paths
from tracy_tpu.render.renderer import Renderer as JRenderer
from tracy_tpu.render.renderer import init_state as j_init_state
from tracy_tpu.scene.scn_parser import load_scene as j_load_scene
from tracy_tpu_torch import RenderConfig
from tracy_tpu_torch.accel.reorder import compact_bounce
from tracy_tpu_torch.accel.tables import build_tables
from tracy_tpu_torch.ops import bounce as k5
from tracy_tpu_torch.ops import intersect as k1
from tracy_tpu_torch.ops import shade as k2
from tracy_tpu_torch.ops.compare import canned_lanes, intersect_rays
from tracy_tpu_torch.render.integrator import make_bruteforce_intersector, trace_paths
from tracy_tpu_torch.render.renderer import Renderer, init_state
from tracy_tpu_torch.scene import from_jax_arrays
from tracy_tpu_torch.utils import parity
from test_torch_intersect import make_rays
from test_torch_render import assert_images_agree
from test_torch_textures import textured_builders

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCN = os.path.join(REPO, "tests", "goldens", "scn")
SEED = 0xABCDEF


def linear_u8(img):
    """tests/test_ref_parity.py's image: tonemapped to 8 bits, back to
    linear radiance."""
    return parity.srgb_to_linear(np.clip(np.asarray(img) * 255.99, 0.0, 255.0) / 255.99)


def test_textured_trace_paths_threefry_matches_jax():
    jb, pb = textured_builders()
    js, scene = jb.build(), pb.build(device="cpu")
    n = 2048
    origin, direction = make_rays(scene, n, seed=31)
    pix = np.random.default_rng(32).integers(0, 1 << 20, n).astype(np.int32)
    skey = 5
    jcfg = JConfig(width=32, height=24, spp=1, max_bounces=2, rng="threefry",
                   use_pallas=False)
    ref, jrays = jax.jit(lambda o, d, p: j_trace_paths(
        js, o, d, p, jnp.uint32(skey), jcfg, j_bruteforce(js)))(
        jnp.asarray(origin), jnp.asarray(direction), jnp.asarray(pix.astype(np.uint32)))
    ref = np.asarray(ref)

    cfg = RenderConfig(width=32, height=24, spp=1, max_bounces=2, rng="threefry")
    before = k2.COUNT_TEX.plain
    got, rays = trace_paths(scene, torch.as_tensor(origin), torch.as_tensor(direction),
                            torch.as_tensor(pix), skey, cfg, make_bruteforce_intersector(scene))
    assert k2.COUNT_TEX.plain == before + cfg.max_bounces  # K4's plain version
    got = got.numpy()
    assert abs(int(rays) - int(jrays)) <= 1e-3 * int(jrays)
    assert np.isfinite(got).all() and (ref > 0).any(axis=1).sum() >= 100
    far = ~np.isclose(got, ref, rtol=1e-4, atol=1e-5).all(axis=1)
    assert far.mean() <= 5e-3, far.mean()


def test_furnace_threefry_render_matches_jax():
    jb = j_load_scene(os.path.join(SCN, "furnace.scn"))
    jb.width, jb.height = 64, 48
    js = jb.build()
    jcfg = JConfig(width=64, height=48, spp=1, accel="bvh", use_pallas=False, rng="threefry")
    jr = JRenderer(jcfg)
    jst, _ = jr.step_many(js, j_init_state(jcfg), 4)

    cfg = RenderConfig(width=64, height=48, spp=1, rng="threefry")
    r = Renderer(cfg)
    st, rays = r.step_many(from_jax_arrays(js, device="cpu"), init_state(cfg, "cpu"), 4)
    ours = linear_u8(r.display(st))
    ref = linear_u8(j_film.tonemap(jst.accum, jcfg))
    dmean, p95, dmax = parity.compare(ref, ours)
    assert dmean <= 0.01 and p95 <= 0.02 and dmax <= 0.05, (dmean, p95, dmax)
    assert_images_agree(st.accum.numpy(), rays, np.asarray(jst.accum), jr.total_rays)


def test_ray_chunk_is_bit_equal_at_fast():
    scene = j_load_scene(os.path.join(SCN, "cornell.scn"))
    scene.width = scene.height = 32
    scene = from_jax_arrays(scene.build(), device="cpu")
    for fused in (False, True):
        cfg = RenderConfig(width=32, height=32, spp=1, max_bounces=3, wave_compact_group=1024,
                           use_pallas_bounce=fused)
        frames = []
        for chunk in (0, 256, 1000):  # whole, 4 chunks, and 1000: no divisor, whole
            st, rays = Renderer(cfg.replace(ray_chunk=chunk)).step_many(
                scene, init_state(cfg, "cpu"), 1)
            frames.append((st.accum, rays))
        for acc, rays in frames[1:]:
            assert torch.equal(acc, frames[0][0]) and rays == frames[0][1]


def test_ray_chunk_threefry_draws_per_chunk_as_jax():
    jb = j_load_scene(os.path.join(SCN, "cornell.scn"))
    jb.width = jb.height = 32
    js = jb.build()
    jcfg = JConfig(width=32, height=32, spp=1, accel="bvh", use_pallas=False, rng="threefry",
                   ray_chunk=256)
    jr = JRenderer(jcfg)
    jst, _ = jr.step_many(js, j_init_state(jcfg), 2)

    scene = from_jax_arrays(js, device="cpu")
    cfg = RenderConfig(width=32, height=32, spp=1, accel="bvh", rng="threefry")
    whole, _ = Renderer(cfg).step_many(scene, init_state(cfg, "cpu"), 2)
    r = Renderer(cfg.replace(ray_chunk=256))
    st, rays = r.step_many(scene, init_state(cfg, "cpu"), 2)
    parted = (st.accum != whole.accum).any(-1).numpy()
    assert parted.sum() >= 10  # the lit paths draw other numbers per chunk
    assert_images_agree(st.accum.numpy(), rays, np.asarray(jst.accum), jr.total_rays)
    # Pixel by pixel, tracy_tpu's chunked frame is the port's chunked one
    # (up to a flipped decision), not its whole one.
    far = ~np.isclose(st.accum.numpy(), np.asarray(jst.accum), rtol=1e-4, atol=1e-5).all(-1)
    assert far.sum() <= max(2, parted.sum() // 5), (far.sum(), parted.sum())


def test_compacted_fused_bounce_draws_at_the_lanes_positions():
    scene = j_load_scene(os.path.join(SCN, "cornell.scn")).build()
    scene = from_jax_arrays(scene, device="cpu")
    tables = build_tables(scene)
    mtab = k2.build_material_table(scene.materials)
    n = 4096
    o, d, a = intersect_rays(scene, tables, n, seed=33)
    lanes = canned_lanes(mtab.shape[0], n, seed=34, device="cpu")
    a = a & lanes["alive"]
    state = (o, d, lanes["throughput"], lanes["radiance"], a, lanes["pixel_idx"])
    kw = dict(tables=tables, mtab=mtab, seed=SEED, russian_roulette=True, rng="threefry")

    def bounce(*s, **pos):
        return k5.trace_bounce(*s, **kw, **pos)

    whole = bounce(*state, 3, 1)
    compacted = compact_bounce(bounce, 1024)(*state, 3, 1)
    sh = k1.intersect_plain(o, d, a, tables)
    two = k2.shade(*(x.clone() for x in state[:5]), state[5], sh.hit.mask, sh.hit.t,
                   sh.normal, sh.material, mtab, 3, 1, seed=SEED, russian_roulette=True,
                   rng="threefry")
    for w, c, t in zip(whole, compacted, two):
        assert torch.equal(w, c) and torch.equal(w, t)
    # Drawn at the compacted slots' own indices instead, the lanes would
    # take other numbers: the positions are what keeps them equal.
    wrong = compact_bounce(lambda *s, **_: bounce(*s), 1024)(*state, 3, 1)
    assert not torch.equal(wrong[1], whole[1])
