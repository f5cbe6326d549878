"""K1-K6 on the card against their plain PyTorch versions on the same CUDA
tensors, with the contracts of tracy_tpu_torch/ops/compare.py (those of
chip_smoke.py's kernel phase, at smaller sizes), K1 and K5 on the binary,
the 4-wide and the 8-wide BVH, K2, K4 and K5 at each counter hash and at
rng 'threefry' (K2 and K5 bit for bit; K5 also compacted), K2 (in
place) equal to its plain version bit for bit with dead lanes untouched,
K4 (texel fetch + textured bounce, in place) on a ragged last block: K5
also against K1 then K2 on the same lanes (equal), compacted and fused renders against
the uncompacted one (equal), each K6 variant against its plain version
(equal), K2, K3 and K4 on each table route (shared, global), and the
global route at table sizes the 48 KB default cannot hold. Marked `cuda`: without an
NVIDIA GPU these tests skip. On a GPU
machine without jax, where tests/conftest.py cannot load, run them with

    python -m pytest tests/test_torch_kernels.py --noconftest -q
"""

import os

import numpy as np
import pytest
import torch

from tracy_tpu_torch import RenderConfig
from tracy_tpu_torch.accel.tables import build_tables
from tracy_tpu_torch.ops import bounce as k5
from tracy_tpu_torch.ops import compare
from tracy_tpu_torch.ops import intersect as k1
from tracy_tpu_torch.ops import shade as k2
from tracy_tpu_torch.ops import texfetch as k3
from tracy_tpu_torch.render.renderer import Renderer, init_state
from tracy_tpu_torch.scene import SceneBuilder, load_scene, sphere_grid
from tracy_tpu_torch.scene.scene import TEX_BASECOLOR

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("width", [2, 4, 8])
def test_intersect_kernel_matches_plain(cuda, width):
    scene = sphere_grid(64, 48, nsph=16, steps=16).build(device=cuda)
    tables = build_tables(scene, width=width)
    assert tables.width == width
    rays = compare.intersect_rays(scene, tables, 65536, seed=1)
    res = compare.compare_intersect(*rays, tables)
    assert res["hit_fraction"] > 0.2


@pytest.mark.parametrize("rng", ["fast", "xorshift", "lcg", "threefry"])
@pytest.mark.parametrize("rr", [True, False])
def test_shade_kernel_matches_plain(cuda, rr, rng):
    scene = load_scene(os.path.join(REPO, "data", "scenes", "default.scn")).build(device=cuda)
    mtab = k2.build_material_table(scene.materials)
    lanes = compare.canned_lanes(mtab.shape[0], 65536, seed=2, device=cuda)
    res = compare.compare_shade(lanes, mtab, 3, 1, seed=0xABCDEF, russian_roulette=rr, rng=rng)
    assert res["bit_equal"]


@pytest.mark.parametrize("rng", ["fast", "xorshift", "lcg", "threefry"])
@pytest.mark.parametrize("rr", [True, False])
def test_shade_kernel_updates_in_place(cuda, rr, rng):
    """K2 on a ragged wave: the caller's tensors come back updated, equal
    to the plain version's bit for bit; dead lanes keep every bit, miss
    lanes all but radiance and alive."""
    scene = load_scene(os.path.join(REPO, "data", "scenes", "default.scn")).build(device=cuda)
    mtab = k2.build_material_table(scene.materials)
    lanes = compare.canned_lanes(mtab.shape[0], 65537, seed=5, device=cuda)
    kw = dict(seed=0xABCDEF, russian_roulette=rr, rng=rng)
    args = compare.state_args(lanes, compare.SHADE_ARGS)
    k2.COUNT.reset()
    got = k2.shade(*args, mtab, 3, 1, **kw)
    assert k2.COUNT.kernel == 1 and all(g is a for g, a in zip(got, args))
    ref = k2.shade_plain(*compare.state_args(lanes, compare.SHADE_ARGS), mtab, 3, 1, **kw)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    old = [lanes[k] for k in compare.STATE]
    dead, miss = ~old[4], old[4] & ~lanes["hit_mask"]
    for g, o in zip(got, old):
        assert torch.equal(g[dead], o[dead])
    for g, o in zip(got[:3], old[:3]):
        assert torch.equal(g[miss], o[miss])


@pytest.mark.parametrize("setting", [{}, dict(accel="bvh", rng="xorshift"),
                                     dict(accel="none", rng="lcg"),
                                     dict(pallas_bvh_width=8), dict(rng="threefry")],
                         ids=["packet-fast", "bvh-xorshift", "none-lcg", "packet-width8",
                              "packet-threefry"])
def test_renderer_runs_on_the_kernels(cuda, setting):
    scene = sphere_grid(64, 48, nsph=4, steps=12).build(device=cuda)
    cfg = RenderConfig(width=64, height=48, spp=1, **setting)
    r = Renderer(cfg)
    k1.COUNT.reset()
    k2.COUNT.reset()
    st, rays = r.step_many(scene, init_state(cfg, cuda), 2)
    # accel 'none' intersects by brute force, without K1.
    assert k1.COUNT.kernel == (0 if cfg.accel == "none" else 2 * cfg.max_bounces)
    assert k2.COUNT.kernel == 2 * cfg.max_bounces
    assert k1.COUNT.plain == k2.COUNT.plain == 0
    assert rays >= 2 * 64 * 48
    assert np.isfinite(r.display(st)).all()


def textured_scene(device):
    """tests/test_pallas_texfetch.py's fixture: a fully textured material
    (5 slots, 20x24), a basecolor-only one (8x8), an untextured one and an
    equirect sky (16x32)."""
    rng = np.random.default_rng(42)
    b = SceneBuilder(32, 24, "texfix")
    b.set_sky_color((0.1, 0.2, 0.3))
    b.set_sky_texture(b.add_texture(rng.uniform(0.0, 3.0, (16, 32, 4)).astype(np.float32)))
    m1 = b.add_material((0.5, 0.4, 0.3), roughness=0.7, metalness=0.2)
    for slot in range(5):
        b.set_material_texture(m1, slot, b.add_texture(
            rng.uniform(0.0, 1.0, (20, 24, 4)).astype(np.float32)))
    m2 = b.add_material((0.2, 0.8, 0.2), roughness=0.3)
    b.set_material_texture(m2, TEX_BASECOLOR, b.add_texture(
        rng.uniform(0.0, 1.0, (8, 8, 4)).astype(np.float32)))
    m3 = b.add_material((0.9, 0.1, 0.1), roughness=1.0)
    b.add_sphere((0.0, 0.0, -3.0), 1.0, m1, steps=8)
    b.add_box((-2.5, -1.0, -4.0), (-1.0, 0.5, -2.5), m2)
    b.add_triangle((1.0, -1.0, -2.0), (2.5, -1.0, -2.0), (1.5, 1.0, -2.5), m3)
    b.set_camera((0, 0, 2), (0, 0, -3), (0, 1, 0), 60.0)
    return b.build(device=device)


@pytest.mark.parametrize("rng", ["fast", "lcg", "threefry"])
@pytest.mark.parametrize("rr", [True, False])
def test_texfetch_and_textured_shade_kernels_match_plain(cuda, rr, rng):
    scene = textured_scene(cuda)
    mtab = k2.build_material_table_tex(scene.materials)
    # 65,537 lanes: a ragged last block.
    lanes = compare.textured_lanes(mtab.shape[0], 65537, seed=3, device=cuda)
    c3 = compare.compare_texfetch(lanes, scene)
    assert c3["hit_lanes"] > 0 and c3["sky_lanes"] > 0
    compare.compare_shade_textured(lanes, scene, mtab, 3, 1, seed=0xABCDEF,
                                   russian_roulette=rr, rng=rng)


def test_textured_tables_beyond_shared_memory_are_refused(cuda):
    """K3 and K4 stage the texture and material tables in shared memory
    while they fit in 48 KB. Larger tables are refused by that route, and
    taken from global memory instead, equal to the plain versions."""
    scene = textured_scene(cuda)
    m = 2500  # K3: 2,500 x 20 bytes of tex_index > 48 KB (K4: x 84 bytes)
    mtab = k2.build_material_table_tex(scene.materials)[:1].repeat(m, 1)
    tex_index = scene.materials.tex_index[:1].repeat(m, 1)
    lanes = compare.textured_lanes(m, 1024, seed=4, device=cuda)
    tex = (scene.tex_data, scene.tex_table, tex_index)
    fargs = [lanes[k] for k in compare.TEXFETCH_ARGS]
    ref3 = k3.fetch_texels_plain(*fargs, *tex)
    ref4 = k2.shade_textured_plain(*compare.textured_args(lanes), mtab, *tex, 3, 1, seed=1,
                                   russian_roulette=True)
    before = (k3.COUNT.kernel, k2.COUNT_TEX.kernel)
    with pytest.raises(ValueError, match="do not fit the 'shared' route"):
        k3.fetch_texels(*fargs, *tex, route="shared")
    with pytest.raises(ValueError, match="do not fit the 'shared' route"):
        k2.shade_textured(*compare.textured_args(lanes), mtab, *tex, 3, 1, seed=1,
                          russian_roulette=True, route="shared")
    assert (k3.COUNT.kernel, k2.COUNT_TEX.kernel) == before
    for route in (None, "global"):
        k3.COUNT.reset()
        k2.COUNT_TEX.reset()
        got3 = k3.fetch_texels(*fargs, *tex, route=route)
        got4 = k2.shade_textured(*compare.textured_args(lanes), mtab, *tex, 3, 1, seed=1,
                                 russian_roulette=True, route=route)
        hit = lanes["alive"] & lanes["hit_mask"]
        assert torch.equal(got3[hit], ref3[hit])
        assert all(torch.equal(g[hit], r[hit]) for g, r in zip(got4, ref4))
        assert k3.COUNT.routes == k2.COUNT_TEX.routes == {"global": 1}


def many_materials(m, device, seed=6):
    """An untextured material table of m rows (sky first)."""
    rng = np.random.default_rng(seed)
    rows = rng.uniform(0.05, 0.95, (m, k2.MTAB_COLS)).astype(np.float32)
    rows[:, 5] = 1.5  # ior
    rows[:, 9] = (rng.uniform(size=m) < 0.2).astype(np.float32)  # some translucent
    return torch.as_tensor(rows, device=device)


@pytest.mark.parametrize("m,routes", [(6, ("shared", "global")),
                                      (2000, ("global",)),
                                      (8000, ("global",))])
def test_shade_kernel_table_routes_match_plain(cuda, m, routes):
    """K2 on each route that holds an m-material table, at 65,537 lanes:
    bit for bit against its plain version, and so against each other."""
    mtab = many_materials(m, cuda)
    lanes = compare.canned_lanes(m, 65537, seed=7, device=cuda)
    for route in routes:
        k2.COUNT.reset()
        res = compare.compare_shade(lanes, mtab, 3, 1, seed=0xABCDEF, russian_roulette=True,
                                    route=route)
        assert res["bit_equal"] and k2.COUNT.routes == {route: 1}


def test_textured_renderer_runs_on_the_kernels(cuda):
    scene = textured_scene(cuda)
    cfg = RenderConfig(width=32, height=24, spp=1)
    r = Renderer(cfg)
    for c in (k1.COUNT, k2.COUNT, k2.COUNT_TEX, k3.COUNT):
        c.reset()
    st, rays = r.step_many(scene, init_state(cfg, cuda), 2)
    # K4 fetches its own texels: K3 is not launched on the render path.
    assert k1.COUNT.kernel == k2.COUNT_TEX.kernel == 2 * cfg.max_bounces
    assert k2.COUNT.kernel == k3.COUNT.kernel == 0
    assert k1.COUNT.plain == k3.COUNT.plain == k2.COUNT_TEX.plain == 0
    assert rays >= 2 * 32 * 24
    assert np.isfinite(r.display(st)).all()


@pytest.mark.parametrize("rng", ["fast", "xorshift", "threefry"])
@pytest.mark.parametrize("width", [2, 4, 8])
@pytest.mark.parametrize("rr", [True, False])
def test_bounce_kernel_matches_plain_and_two_stage(cuda, rr, width, rng):
    scene = sphere_grid(64, 48, nsph=16, steps=16).build(device=cuda)
    tables = build_tables(scene, width=width)
    assert tables.width == width
    mtab = k2.build_material_table(scene.materials)
    o, d, a = compare.intersect_rays(scene, tables, 65536, seed=1)
    canned = compare.canned_lanes(mtab.shape[0], 65536, seed=2, device=cuda)
    lanes = dict(canned, origin=o, direction=d, alive=a & canned["alive"])
    res = compare.compare_bounce(lanes, tables, mtab, 3, 1, seed=0xABCDEF,
                                 russian_roulette=rr, rng=rng)
    assert all(res["equal_to_k1_k2"]) and res["hit_lanes"] > 0 and res["miss_lanes"] > 0
    if rng == "threefry":
        assert res["bit_equal"]
        third = torch.as_tensor(np.random.default_rng(6).uniform(size=65536) < 0.35,
                                device=cuda)
        compare.compare_bounce_compacted(dict(lanes, alive=lanes["alive"] & third), tables,
                                         mtab, 4096, 3, 1, seed=0xABCDEF,
                                         russian_roulette=rr, rng=rng)


def test_compacted_and_fused_renders_equal_on_the_card(cuda):
    scene = sphere_grid(64, 64, nsph=16, steps=12).build(device=cuda)
    out = {}
    for name, kw in (("plain", {}), ("compacted", dict(wave_compact_group=2048)),
                     ("fused", dict(wave_compact_group=2048, use_pallas_bounce=True)),
                     ("plain threefry", dict(rng="threefry")),
                     ("fused threefry", dict(wave_compact_group=2048, use_pallas_bounce=True,
                                             rng="threefry"))):
        cfg = RenderConfig(width=64, height=64, spp=1, **kw)
        r = Renderer(cfg)
        for c in (k1.COUNT, k2.COUNT, k5.COUNT):
            c.reset()
        st, rays = r.step_many(scene, init_state(cfg, cuda), 2)
        assert r.tables.width == cfg.pallas_bvh_width == 4
        out[name] = (st.accum, rays)
        want = (0, 0, 10) if name.startswith("fused") else (10, 10, 0)
        assert (k1.COUNT.kernel, k2.COUNT.kernel, k5.COUNT.kernel) == want
        assert k1.COUNT.plain == k2.COUNT.plain == k5.COUNT.plain == 0
    for name, ref in (("compacted", "plain"), ("fused", "plain"),
                      ("fused threefry", "plain threefry")):
        assert torch.equal(out[name][0], out[ref][0]) and out[name][1] == out[ref][1]


def test_micro_kernel_variants_match_plain(cuda):
    from tracy_tpu_torch.tools import micro as k6

    leaves = k6.make_leaves(device=cuda)
    rays = k6.make_rays(8192, device=cuda)
    for v in k6.VARIANTS:
        res = k6.check_variant(v, rays, leaves, iters=100)
        assert res["outputs_equal"] and res["counts_equal"]
    # 8192 + 32 rays: the last hardware warp of two rays a thread holds one
    # warp of rays, and its second ray is not written.
    odd = k6.make_rays(8192 + 32, device=cuda)
    res = k6.check_variant("vred", odd, leaves, iters=100)
    assert res["outputs_equal"] and res["counts_equal"]
