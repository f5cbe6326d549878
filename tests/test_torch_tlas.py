"""The port's two-level BVH (accel/tlas.py) and accel='tlas' against
tracy_tpu's, on the CPU.

* The object ranges SceneBuilder.build records equal tracy_tpu's, for the default
  scene and a .scn build.
* build_two_level's stitched arrays (node_bounds, node_meta, tri_order)
  equal tracy_tpu's bit for bit, for default_scene(64, 64) and for a
  scene of 25 small objects whose TLAS is capped at depth 3, so that its
  leaves hold several objects and _stitch chains them (the chain's
  presence is checked).
* update_object equals a fresh build array for array and rebuilds only the
  moved object's BLAS; transform_object is within 1e-6 of tracy_tpu's
  (numpy's float32 matmul and the port's mul-adds differ by an ulp).
* The stitched depth bound is only a bound: the tables take the real
  depth, which the walk finds at or below it.
* K1's plain version on the stitched tables at widths 2, 4 and 8: the
  same nearest t and hit mask on every ray as on the single-level tables
  (the same float32 tests in another order), the same normal and material
  where both pick the same triangle (ties between equal-t triangles may go
  either way); and against tracy_tpu's brute-force oracle, hit masks on
  >= 99.9% of rays and |dt| <= 1e-4 t + 1e-5.
* A 2-frame 32x32 Renderer(accel='tlas') render (2 bounces) against tracy_tpu's (its
  XLA packet intersector over the stitched tree, built at leaf size 64
  where the port builds it at bvh_leaf_size) under
  tests/test_torch_render.py's block-mean contract; compaction on the
  stitched tree routes every hit field back, tri included, bit for bit.
* A moved object renders moved: the incremental rebuild renders the moved
  scene exactly as a fresh build does, and differently from the unmoved one.
* make_two_level_intersector (K1 on the stitched tables) against tracy_tpu's
  (its XLA packet intersector on the stitched tree) on make_rays' rays of
  the default scene: hit masks on >= 99.9% of rays, |dt| <= 1e-4 t + 1e-5.
  (On the capped "many" scene tracy_tpu's packet tier returns a farther
  hit than its brute-force oracle on 8 of 530 camera rays; K1 agrees with
  the oracle there, test_k1_plain_on_stitched_tables_matches_oracle.)
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracy_tpu.accel.tlas import build_two_level as j_build_two_level
from tracy_tpu.accel.tlas import make_two_level_intersector as j_make_two_level_intersector
from tracy_tpu.accel.tlas import transform_object as j_transform_object
from tracy_tpu.config import RenderConfig as JConfig
from tracy_tpu.render.intersect import intersect_bruteforce as j_bruteforce
from tracy_tpu.render.renderer import Renderer as JRenderer
from tracy_tpu.render.renderer import init_state as j_init_state
from tracy_tpu.scene.scene import SceneBuilder as JSceneBuilder
from tracy_tpu.scene.scn_parser import default_scene as j_default_scene
from tracy_tpu.scene.scn_parser import load_scene as j_load_scene
from tracy_tpu_torch import RenderConfig
from tracy_tpu_torch.accel.bvh_build import build_bvh_auto
from tracy_tpu_torch.accel.reorder import compact_intersector
from tracy_tpu_torch.accel.tables import build_tables, tables_from_host, tree_depth
from tracy_tpu_torch.accel.tlas import (
    build_two_level, make_two_level_intersector, transform_object, update_object)
from tracy_tpu_torch.core import math as tm
from tracy_tpu_torch.ops import intersect as k1
from tracy_tpu_torch.render.renderer import Renderer, init_state, sample_radiance
from tracy_tpu_torch.scene import default_scene, from_jax_arrays, load_scene
from test_torch_intersect import make_rays
from test_torch_render import assert_images_agree

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPHERES = os.path.join(REPO, "tests", "goldens", "scn", "spheres.scn")
STITCH = dict(leaf_size=4, max_depth=3)  # the capped TLAS: multi-object leaves


def many_objects(cls):
    """25 objects (24 small spheres on a 6x4 grid, a floor) with cls, a
    SceneBuilder of either package."""
    b = cls(48, 48, name="many")
    b.set_camera(eye=(0.0, 2.0, 6.0), center=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0),
                 fov_degrees=60.0)
    b.set_sky_color((0.7, 0.8, 1.0))
    m = b.add_material((0.6, 0.5, 0.4), roughness=1.0)
    for i in range(24):
        b.add_sphere(((i % 6) * 0.9 - 2.25, 0.35, (i // 6) * 0.9 - 1.35), 0.35, m, steps=6)
    b.add_box((-4.0, -0.2, -4.0), (4.0, 0.0, 4.0), m)
    return b


@pytest.fixture(scope="module")
def scenes():
    """name -> (tracy_tpu scene, the port's from its arrays, stitch options)."""
    out = {}
    for name, jb, kw in (("default", j_default_scene(64, 64), dict(leaf_size=8, max_depth=32)),
                         ("many", many_objects(JSceneBuilder), STITCH)):
        js = jb.build()
        out[name] = (js, from_jax_arrays(js, device="cpu"), kw)
    return out


@pytest.mark.parametrize("name", ["default", "spheres.scn"])
def test_object_ranges_match_jax(name):
    if name == "default":
        jb, b = j_default_scene(32, 32), default_scene(32, 32)
    else:
        jb, b = j_load_scene(SPHERES), load_scene(SPHERES)
    js, s = jb.build(), b.build(device="cpu")
    assert b.num_objects == jb.num_objects == len(s.object_tri_ranges)
    assert s.object_tri_ranges == js.object_tri_ranges
    assert s.object_vert_ranges == js.object_vert_ranges
    carried = from_jax_arrays(js, device="cpu")
    assert carried.object_tri_ranges == js.object_tri_ranges
    assert carried.object_vert_ranges == js.object_vert_ranges
    assert sum(c for _, c in s.object_tri_ranges) == s.num_triangles


@pytest.mark.parametrize("name", ["default", "many"])
def test_stitched_arrays_equal_jax(scenes, name):
    js, s, kw = scenes[name]
    ref, got = j_build_two_level(js, **kw), build_two_level(s, **kw)
    assert len(got.blas) == len(ref.blas) == len(s.object_tri_ranges)
    for k in ("node_bounds", "node_meta", "tri_order"):
        np.testing.assert_array_equal(getattr(got.stitched, k), getattr(ref.stitched, k))
    assert got.stitched.max_depth == ref.stitched.max_depth
    if name == "many":  # the capped TLAS has a multi-object leaf: a chain
        blas = got.blas
        obj_min = np.stack([blas[i].node_bounds[0, :3] for i in range(len(blas))])
        obj_max = np.stack([blas[i].node_bounds[0, 3:6] for i in range(len(blas))])
        tlas = build_bvh_auto(obj_min, obj_max, 1, kw["max_depth"])
        assert tlas.node_meta[:, 1].max() > 1


@pytest.mark.parametrize("name", ["default", "many"])
def test_real_depth_within_bound(scenes, name):
    _, s, kw = scenes[name]
    st = build_two_level(s, **kw).stitched
    depth = tree_depth(st.node_meta)
    assert 0 < depth <= st.max_depth
    tables = tables_from_host(s, st, width=4)
    assert tables.max_depth == depth and tables.stack_size <= tables.stack_max
    # The walk's depth is each leaf's: follow the deepest leaf's chain up.
    parent = {int(c): n for n, (f, cnt, r) in enumerate(st.node_meta) if cnt == 0
              for c in (f, r)}
    deepest = 0
    for n in np.nonzero(st.node_meta[:, 1] > 0)[0]:
        d, node = 0, int(n)
        while node in parent:
            node, d = parent[node], d + 1
        deepest = max(deepest, d)
    assert deepest == depth


def test_update_object_equals_fresh_build(scenes):
    _, s, kw = scenes["many"]
    two = build_two_level(s, **kw)
    kept = two.blas[0]
    moved = transform_object(s, 5, tm.translate((0.1, 0.3, -0.2)))
    update_object(two, moved, 5)
    assert two.blas[0] is kept
    assert two.rebuild_counts == {i: 2 if i == 5 else 1 for i in range(25)}
    fresh = build_two_level(moved, **kw)
    for k in ("node_bounds", "node_meta", "tri_order"):
        np.testing.assert_array_equal(getattr(two.stitched, k), getattr(fresh.stitched, k))
    assert not np.array_equal(two.stitched.node_bounds,
                              build_two_level(s, **kw).stitched.node_bounds)


def test_transform_object_matches_jax(scenes):
    js, s, _ = scenes["default"]
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = [[0.9, 0.1, 0.0], [-0.1, 0.9, 0.05], [0.0, 0.2, 1.1]]
    m[:3, 3] = (0.25, -0.1, 0.3)
    ref, got = j_transform_object(js, 1, m), transform_object(s, 1, m)
    assert got.vertex_pos.device == s.vertex_pos.device
    for k in ("vertex_pos", "vertex_normal", "vertex_tangent"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(ref, k)),
                                   rtol=0, atol=1e-6)
    vs, vc = s.object_vert_ranges[1]
    untouched = np.r_[0:vs, vs + vc:s.num_vertices]
    assert torch.equal(got.vertex_pos[untouched], s.vertex_pos[untouched])


@pytest.fixture(scope="module")
def many_rays(scenes):
    """2048 rays of make_rays on the capped scene, 90% active, and
    tracy_tpu's brute-force oracle's mask and t on them (under jax.jit)."""
    js, s, _ = scenes["many"]
    origin, direction = make_rays(s, 2048, seed=11)
    active = np.random.default_rng(12).uniform(size=len(origin)) < 0.9
    p0, p1, p2 = js.triangle_vertices()
    oracle = jax.jit(lambda o, d, a: j_bruteforce(o, d, p0, p1 - p0, p2 - p0, active=a))(
        jnp.asarray(origin), jnp.asarray(direction), jnp.asarray(active))
    return (origin, direction, active), (np.asarray(oracle.mask), np.asarray(oracle.t))


@pytest.mark.parametrize("width", [2, 4, 8])
def test_k1_plain_on_stitched_tables_matches_oracle(scenes, many_rays, width):
    _, s, kw = scenes["many"]
    tables = tables_from_host(s, build_two_level(s, **kw).stitched, width=width)
    assert tables.width == width
    (origin, direction, active), (rmask, rt) = many_rays
    o, d, a = (torch.as_tensor(x) for x in (origin, direction, active))
    got = k1.intersect(o, d, a, tables)
    ref = k1.intersect(o, d, a, build_tables(s, leaf_size=4, max_depth=32, width=width))
    assert torch.equal(got.hit.mask, ref.hit.mask) and torch.equal(got.hit.t, ref.hit.t)
    same = got.hit.mask & (got.hit.tri == ref.hit.tri)
    assert same.sum() >= 0.99 * got.hit.mask.sum() > len(a) // 10
    assert torch.equal(got.normal[same], ref.normal[same])
    assert torch.equal(got.material[same], ref.material[same])
    mask, t = got.hit.mask.numpy(), got.hit.t.numpy()
    assert (mask == rmask).mean() >= 0.999
    both = mask & rmask
    np.testing.assert_array_less(np.abs(t[both] - rt[both]), 1e-4 * rt[both] + 1e-5)


def test_tlas_render_matches_jax(scenes):
    js, s, _ = scenes["default"]
    jcfg = JConfig(width=32, height=32, spp=1, max_bounces=2, accel="tlas")
    jr = JRenderer(jcfg)
    jst, _ = jr.step_many(js, j_init_state(jcfg), 2)
    cfg = RenderConfig(width=32, height=32, spp=1, max_bounces=2, accel="tlas")
    r = Renderer(cfg)
    before = k1.COUNT.plain
    st, rays = r.step_many(s, init_state(cfg, "cpu"), 2)
    assert k1.COUNT.plain - before == 2 * cfg.max_bounces
    assert r.two_level is not None and r.tables.width == 4 and r.path == "two-stage"
    assert_images_agree(st.accum.numpy(), rays, np.asarray(jst.accum), jr.total_rays)


def test_compaction_on_stitched_tree_routes_tri_back(scenes):
    _, s, kw = scenes["many"]
    tables = tables_from_host(s, build_two_level(s, **kw).stitched, width=4)
    origin, direction = make_rays(s, 4096, seed=13)
    active = torch.as_tensor(np.random.default_rng(14).uniform(size=4096) < 0.3)
    o, d = torch.as_tensor(origin), torch.as_tensor(direction)
    plain = k1.intersect(o, d, active, tables)
    routed = compact_intersector(lambda *x: k1.intersect(*x, tables), 1024)(o, d, active)
    assert routed.hit.mask.any()
    for a, b in zip(list(plain.hit) + [plain.normal, plain.material],
                    list(routed.hit) + [routed.normal, routed.material]):
        assert torch.equal(a, b)


def test_moved_object_renders_moved(scenes):
    _, s, kw = scenes["default"]
    cfg = RenderConfig(width=32, height=32, spp=1, max_bounces=2, tonemap="none")
    moved = transform_object(s, 0, tm.translate((0.0, 0.4, 0.0)))
    two = build_two_level(s, **kw)
    update_object(two, moved, 0)

    def render(scene, stitched):
        tables = tables_from_host(scene, stitched, width=4)
        return sample_radiance(scene, cfg, 0, lambda o, d, a: k1.intersect(o, d, a, tables))[0]

    inc = render(moved, two.stitched)
    fresh = render(moved, build_two_level(moved, **kw).stitched)
    before = render(s, build_two_level(s, **kw).stitched)
    assert torch.equal(inc, fresh)
    assert (inc != before).any(-1).float().mean() > 0.01


def test_make_two_level_intersector_matches_jax(scenes):
    js, s, kw = scenes["default"]
    origin, direction = make_rays(s, 2048, seed=13)
    active = np.random.default_rng(14).uniform(size=len(origin)) < 0.9
    jisect = j_make_two_level_intersector(js, j_build_two_level(js, **kw))
    jhit, _ = jax.jit(jisect)(jnp.asarray(origin), jnp.asarray(direction), jnp.asarray(active))
    isect = make_two_level_intersector(s, build_two_level(s, **kw), width=4)
    assert isect.keywords["tables"].width == 4
    before = k1.COUNT.plain
    got = isect(*(torch.as_tensor(x) for x in (origin, direction, active)))
    assert k1.COUNT.plain == before + 1
    mask, t = got.hit.mask.numpy(), got.hit.t.numpy()
    rmask, rt = np.asarray(jhit.mask), np.asarray(jhit.t)
    assert (mask == rmask).mean() >= 0.999 and mask.sum() > len(mask) // 10
    both = mask & rmask
    np.testing.assert_array_less(np.abs(t[both] - rt[both]), 1e-4 * rt[both] + 1e-5)
