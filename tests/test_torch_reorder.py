"""The port's wave compaction (tracy_tpu_torch/accel/reorder.py) against
tracy_tpu/accel/reorder.py, on the CPU.

Contract and why: compaction is a permutation of bits, so every check is
exact.

* pick_compact_group returns tracy_tpu's group on tests/test_reorder.py's
  cases, with and without scene statistics.
* Compacting rays: the alive flag of every slot equals tracy_tpu's
  compact_rays; origin and direction are bit-equal on each block's live
  prefix (the dead slots differ by design: the port keeps the dead lanes
  there, tracy_tpu stale copies). The round trip is the identity.
* compact_intersector around K1's plain version equals the unwrapped one
  bit for bit on every field, the triangle id, texture uv and tangent
  included, on the textured fixture.
* compact_bounce around K5's plain version leaves dead lanes verbatim and
  equals the unwrapped bounce bit for bit.
* scatter_results routes results of the compacted rays back as tracy_tpu's
  does: equal on every live lane; compact_intersector_slot routes the hit
  and the winner slot back as tracy_tpu's does (slot -1 on a miss).
"""

import os

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tracy_tpu.accel.packet import PacketAttrs
from tracy_tpu.accel.reorder import compact_intersector_slot as j_compact_slot
from tracy_tpu.accel.reorder import compact_rays as j_compact_rays
from tracy_tpu.accel.reorder import pick_compact_group as j_pick
from tracy_tpu.accel.reorder import scatter_results as j_scatter_results
from tracy_tpu.render.intersect import Hit as JHit
from tracy_tpu_torch.accel import reorder
from tracy_tpu_torch.accel.tables import build_tables
from tracy_tpu_torch.ops import bounce as k5
from tracy_tpu_torch.ops import intersect as k1
from tracy_tpu_torch.ops import shade as k2
from tracy_tpu_torch.ops.compare import canned_lanes, intersect_rays
from tracy_tpu_torch.render.intersect import Hit
from tracy_tpu_torch.scene import load_scene
from test_torch_textures import textured_builders

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_1080P = 1920 * 1080


@pytest.mark.parametrize("n,stats", [
    (640 * 480, None), (N_1080P, None), (128 * 128, None), (480000, None),
    (196608, None), (65536, None), (12000, None),
    (N_1080P, (15452, False)), (N_1080P, (20108, False)), (N_1080P, (13973, True)),
    (N_1080P, (100748, False)),
])
def test_pick_compact_group_matches(n, stats):
    kw = {} if stats is None else dict(num_tris=stats[0], has_translucent=stats[1])
    assert reorder.pick_compact_group(n, **kw) == j_pick(n, **kw)


def test_builder_statistics_pick_the_bench_group():
    """bench.py's call, pick_compact_group(w*h, num_tris=b.num_triangles,
    has_translucent=b.has_translucent), on the port's builder."""
    b = load_scene(os.path.join(REPO, "tests", "goldens", "scn", "cornell.scn"))
    assert (b.num_triangles, b.has_translucent) == (96, False)
    assert reorder.pick_compact_group(N_1080P, num_tris=b.num_triangles,
                                      has_translucent=b.has_translucent) == 0
    r = load_scene(os.path.join(REPO, "tests", "goldens", "scn", "random.scn"))
    assert r.has_translucent


@pytest.mark.parametrize("group,blocks,frac", [
    (8, 3, 0.5), (64, 2, 0.1), (1024, 2, 0.3), (4096, 1, 0.9),
])
def test_compact_rays_matches_jax(group, blocks, frac):
    rng = np.random.default_rng(group + blocks)
    n = group * blocks
    alive = rng.uniform(size=n) < frac
    o = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)

    jo, jd, ja, _, _ = jax.jit(j_compact_rays, static_argnums=3)(o, d, alive, group)
    jo, jd, ja = np.asarray(jo), np.asarray(jd), np.asarray(ja)
    to, td, ta, dest = reorder.compact_rays(torch.as_tensor(o), torch.as_tensor(d),
                                            torch.as_tensor(alive), group)
    np.testing.assert_array_equal(ta.numpy(), ja)
    for b in range(blocks):
        lo = b * group
        live = lo + int(alive[lo:lo + group].sum())
        np.testing.assert_array_equal(to.numpy()[lo:live], jo[lo:live])
        np.testing.assert_array_equal(td.numpy()[lo:live], jd[lo:live])

    assert sorted(dest.tolist()) == list(range(n))  # a permutation
    for c, x in ((to, o), (td, d), (ta, alive)):  # the round trip, every lane
        assert torch.equal(c.index_select(0, dest), torch.as_tensor(x))


def fields(sh):
    return [sh.hit.t, sh.hit.uv, sh.hit.mask, sh.hit.tri, sh.normal, sh.material,
            sh.tex_uv, sh.tangent]


@pytest.mark.parametrize("n", [4096, 3000])
def test_compact_intersector_is_exact(n):
    """3000 lanes: the last block is ragged (padded in the mask only)."""
    _, tb = textured_builders()
    scene = tb.build(device="cpu")
    tables = build_tables(scene)
    assert tables.vertex_uv is not None and tables.vertex_tangent is not None
    o, d, a = intersect_rays(scene, tables, n, seed=5)
    a = a & torch.as_tensor(np.random.default_rng(6).uniform(size=n) < 0.6)
    isect = lambda o, d, a: k1.intersect(o, d, a, tables)  # noqa: E731
    ref = isect(o, d, a)
    got = reorder.compact_intersector(isect, 1024)(o, d, a)
    assert ref.hit.mask.any() and (a & ~ref.hit.mask).any()
    for g, r in zip(fields(got), fields(ref)):
        assert g.dtype == r.dtype and torch.equal(g, r)


def test_compact_bounce_keeps_dead_lanes_verbatim():
    scene = load_scene(os.path.join(REPO, "tests", "goldens", "scn", "cornell.scn")).build(
        device="cpu")
    tables = build_tables(scene)
    mtab = k2.build_material_table(scene.materials)
    n = 4096
    o, d, a = intersect_rays(scene, tables, n, seed=7)
    lanes = canned_lanes(mtab.shape[0], n, seed=8, device="cpu")
    a = a & lanes["alive"]
    state = (o, d, lanes["throughput"], lanes["radiance"], a, lanes["pixel_idx"])
    bounce = lambda *s, **kw: k5.trace_bounce(*s, tables=tables, mtab=mtab,  # noqa: E731
                                              seed=0xABCDEF, russian_roulette=True, **kw)
    ref = bounce(*state, 3, 1)
    got = reorder.compact_bounce(bounce, 1024)(*state, 3, 1)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    dead = ~a
    assert dead.any() and not got[4][dead].any()
    for g, x in zip(got[:4], state[:4]):
        assert torch.equal(g[dead].view(torch.int32), x[dead].view(torch.int32))


def lane_results(o, d):
    """A per-lane result of rays, [N, 4]: any function of the lane alone."""
    return np.concatenate([o * 2.0 + 1.0, (d[:, :1] - o[:, 2:3])], axis=1)


def test_scatter_results_matches_jax():
    group, n = 64, 192
    rng = np.random.default_rng(9)
    alive = rng.uniform(size=n) < 0.4
    o = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    jo, jd, _, dist, valid = jax.jit(j_compact_rays, static_argnums=3)(o, d, alive, group)
    planes = jnp.asarray(lane_results(np.asarray(jo), np.asarray(jd)))
    ref = np.asarray(jax.jit(j_scatter_results, static_argnums=3)(planes, dist, valid, group))
    to, td, _, dest = reorder.compact_rays(torch.as_tensor(o), torch.as_tensor(d),
                                           torch.as_tensor(alive), group)
    got = reorder.scatter_results(torch.as_tensor(lane_results(to.numpy(), td.numpy())),
                                  dest).numpy()
    np.testing.assert_array_equal(got[alive], ref[alive])
    np.testing.assert_array_equal(got, lane_results(o, d))  # every lane, in the port


def test_compact_intersector_slot_matches_jax():
    """A per-lane stand-in intersector in each package: hits where the ray
    is active and o.x > 0, t = o.y, slot = the lane's own id."""
    group, n = 1024, 3000
    rng = np.random.default_rng(10)
    alive = rng.uniform(size=n) < 0.5
    o = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    ids = np.arange(n, dtype=np.int32)
    o[:, 2] = ids  # carries the lane id through the route

    def j_isect(o_, d_, a_):
        mask = a_ & (o_[:, 0] > 0)
        z3, z2 = jnp.zeros_like(o_), jnp.zeros_like(o_[:, :2])
        return (JHit(t=o_[:, 1], tri=jnp.zeros_like(mask, jnp.int32), uv=z2, mask=mask),
                PacketAttrs(normal=d_, tangent=z3, uv=z2, material=jnp.zeros_like(mask, jnp.int32)),
                o_[:, 2].astype(jnp.int32))

    def t_isect(o_, d_, a_):
        mask = a_ & (o_[:, 0] > 0)
        zi = torch.zeros_like(mask, dtype=torch.int32)
        hit = Hit(t=o_[:, 1], tri=zi, uv=torch.zeros_like(o_[:, :2]), mask=mask)
        return k1.SurfaceHit(hit, d_, zi), o_[:, 2].to(torch.int32)

    jh, ja, jslot = jax.jit(j_compact_slot(j_isect, group))(o, d, alive)
    th, tslot = reorder.compact_intersector_slot(t_isect, group)(
        torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(alive))
    np.testing.assert_array_equal(th.hit.mask.numpy(), np.asarray(jh.mask))
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    hit = th.hit.mask.numpy()
    assert hit.any() and (alive & ~hit).any()
    np.testing.assert_array_equal(tslot.numpy()[hit], ids[hit])
    np.testing.assert_array_equal(th.hit.t.numpy()[hit], np.asarray(jh.t)[hit])
    np.testing.assert_array_equal(th.normal.numpy()[alive], np.asarray(ja.normal)[alive])

