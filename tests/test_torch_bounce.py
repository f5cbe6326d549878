"""K5's plain version and the fused, compacted renders against tracy_tpu,
on the CPU.

* trace_bounce_plain (K1's plain traversal over the port's BVH, then K2's
  plain bounce) against tracy_tpu/ops/pallas_packet.py::pallas_trace_bounce
  in interpret mode (tables from build_packet_bvh(leaf_size=64) and
  build_tables(with_tangent=False), as tests/test_pallas_shade.py builds
  them, but with pack_pairs=False: the default packs the winner's normal
  into bf16 halves, about 4e-3 off, which turns about 2% of the scatter
  directions by more than 1e-3), on cornell.scn: 4,096 lanes, half camera rays and half secondary
  rays, about 70% alive; Russian roulette on and off; and once more with
  both sides wrapped in compact_bounce(group=1024). These three walk the
  binary BVH on both sides; two more cases walk the 4-wide and the 8-wide
  BVH on both sides (the port's traverse_wide order against tracy_tpu's
  body4, build_tables(width=4 or 8), as tests/test_pallas_packet.py:434-446
  runs it). The contract is
  test_torch_shade.py's, for the same reasons (an ulp of torch CPU vs XLA
  CPU can flip a discrete decision; the two BVHs may also break an equal-t
  tie differently): lanes whose alive flag or lobe differ at most 0.1%,
  every float of every other lane within rtol 1e-5, atol 1e-6. One
  addition: the next origin is o + t d, and the two sides find t with
  different arithmetic (Möller–Trumbore here, a Woop transform in the
  Pallas kernel), one ulp apart at t of about 900 (6e-5) in cornell's
  500-unit box; so the origin's relative tolerance applies to the distance
  moved as well as to the coordinate: |dO| <= 1e-6 + 1e-5 (|O| + |O - o|).
* The port's Renderer on cornell at 64x64, 2 frames: the fused and
  compacted render (group 2048), the compacted two-stage render and the
  uncompacted render have equal accumulators (each lane's result does not
  depend on where compaction puts it), and the compacted render matches
  tracy_tpu's Renderer(accel='packet', wave_compact_group=2048) under
  test_torch_render.py's block-mean contract.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracy_tpu.accel.packet import build_packet_bvh
from tracy_tpu.accel.reorder import compact_bounce as j_compact_bounce
from tracy_tpu.config import RenderConfig as JConfig
from tracy_tpu.ops.pallas_packet import build_tables as j_build_tables
from tracy_tpu.ops.pallas_packet import pallas_trace_bounce
from tracy_tpu.ops.pallas_shade import build_material_table as j_build_mtab
from tracy_tpu.render.renderer import Renderer as JRenderer
from tracy_tpu.render.renderer import init_state as j_init_state
from tracy_tpu.scene.scn_parser import load_scene as j_load_scene
from tracy_tpu_torch import RenderConfig
from tracy_tpu_torch.accel.reorder import compact_bounce
from tracy_tpu_torch.accel.tables import build_tables
from tracy_tpu_torch.ops import bounce as k5
from tracy_tpu_torch.ops import intersect as k1
from tracy_tpu_torch.ops import shade as k2
from tracy_tpu_torch.ops.compare import canned_lanes, decisions_flipped, intersect_rays
from tracy_tpu_torch.render.renderer import Renderer, init_state
from tracy_tpu_torch.scene import from_jax_arrays
from test_torch_render import assert_images_agree

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0xABCDEF
CORNELL = os.path.join(REPO, "tests", "goldens", "scn", "cornell.scn")


def compare_next_state(got, ref, origin, decision_frac):
    """got/ref: next (origin, direction, throughput, radiance, alive);
    origin: the lanes' origin before the bounce. Returns the lanes kept."""
    keep = ~decisions_flipped(got, ref).numpy()
    assert 1.0 - keep.mean() <= decision_frac, 1.0 - keep.mean()
    g, r, o = got[0].numpy()[keep], ref[0].numpy()[keep], origin.numpy()[keep]
    moved = np.linalg.norm(r - o, axis=-1, keepdims=True)
    np.testing.assert_array_less(np.abs(g - r), 1e-6 + 1e-5 * (np.abs(r) + moved))
    for g, r in zip(got[1:4], ref[1:4]):
        np.testing.assert_allclose(g.numpy()[keep], r.numpy()[keep], rtol=1e-5, atol=1e-6)
    return keep


@pytest.fixture(scope="module")
def cornell():
    b = j_load_scene(CORNELL)
    b.width = b.height = 64
    return b.build()


@pytest.mark.parametrize("rr,group,width", [
    pytest.param(True, 0, 2, id="True-0"), pytest.param(False, 0, 2, id="False-0"),
    pytest.param(True, 1024, 2, id="True-1024"), pytest.param(True, 0, 4, id="True-0-width4"),
    pytest.param(True, 0, 8, id="True-0-width8")])
def test_bounce_plain_matches_pallas_trace_bounce(cornell, rr, group, width):
    scene = from_jax_arrays(cornell, device="cpu")
    tables = build_tables(scene, width=width)
    assert tables.width == width
    mtab = k2.build_material_table(scene.materials)
    n = 4096
    o, d, a = intersect_rays(scene, tables, n, seed=11)
    lanes = canned_lanes(mtab.shape[0], n, seed=12, device="cpu")
    a = a & torch.as_tensor(np.random.default_rng(13).uniform(size=n) < 0.7)
    assert 0.6 < float(a.float().mean()) < 0.75
    state = (o, d, lanes["throughput"], lanes["radiance"], a, lanes["pixel_idx"])
    skey, bounce = 4, 1

    def ours(*s, **kw):  # kw: compact_bounce's slot positions
        return k5.trace_bounce(*s, tables=tables, mtab=mtab, seed=SEED,
                               russian_roulette=rr, **kw)

    before = k5.COUNT.plain
    got = (compact_bounce(ours, group) if group else ours)(*state, skey, bounce)
    assert k5.COUNT.plain == before + 1

    bvh, _ = build_packet_bvh(cornell, leaf_size=64)
    jt = j_build_tables(cornell, bvh, with_tangent=False, pack_pairs=False, width=width)
    assert jt.width == width
    jm = j_build_mtab(cornell.materials)
    num_m = int(np.asarray(cornell.materials.albedo).shape[0])

    def theirs(o, d, thr, rad, alive, pix, sk, bi):
        return pallas_trace_bounce(o, d, thr, rad, alive, pix, jt, jm, sk, bi,
                                   num_materials=num_m, seed=SEED, russian_roulette=rr,
                                   interpret=True)

    fn = j_compact_bounce(theirs, group) if group else theirs
    js = [jnp.asarray(x.numpy()) for x in state]
    js[5] = js[5].astype(jnp.uint32)
    ref = jax.jit(lambda: fn(*js, jnp.uint32(skey), jnp.int32(bounce)))()
    ref = [torch.tensor(np.asarray(x)) for x in ref]
    keep = compare_next_state(got, ref, o, decision_frac=0.001)
    dead = (~a).numpy() & keep
    np.testing.assert_array_equal(got[0].numpy()[dead], o.numpy()[dead])
    assert not got[4][~a].any()


def test_fused_and_compacted_renders_match(cornell):
    scene = from_jax_arrays(cornell, device="cpu")
    accum, runs = {}, {}
    for name, kw in (("plain", {}), ("compacted", dict(wave_compact_group=2048)),
                     ("fused", dict(wave_compact_group=2048, use_pallas_bounce=True))):
        cfg = RenderConfig(width=64, height=64, spp=1, **kw)
        r = Renderer(cfg)
        counts = (k1.COUNT, k2.COUNT, k5.COUNT)
        before = [c.plain for c in counts]
        st, rays = r.step_many(scene, init_state(cfg, "cpu"), 2)
        runs[name] = [c.plain - b for c, b in zip(counts, before)]
        accum[name] = (st.accum, rays, r.path)
    bounces = 2 * 5
    assert runs == {"plain": [bounces, bounces, 0], "compacted": [bounces, bounces, 0],
                    "fused": [0, 0, bounces]}
    assert [v[2] for v in accum.values()] == ["two-stage", "two-stage", "fused"]
    ref, rays, _ = accum["plain"]
    for name in ("compacted", "fused"):
        assert torch.equal(accum[name][0], ref), name
        assert accum[name][1] == rays

    jcfg = JConfig(width=64, height=64, spp=1, accel="packet", wave_compact_group=2048)
    jr = JRenderer(jcfg)
    jst, _ = jr.step_many(cornell, j_init_state(jcfg), 2)
    assert_images_agree(accum["compacted"][0].numpy(), accum["compacted"][1],
                        np.asarray(jst.accum), jr.total_rays)


def test_fused_path_binds_two_stage_on_textured_scenes():
    """use_pallas_bounce on a textured scene keeps K1 -> K3 -> K4, as
    tracy_tpu's Renderer does; K5 refuses tables with uv or tangent."""
    from test_torch_textures import textured_builders

    _, tb = textured_builders()
    scene = tb.build(device="cpu")
    cfg = RenderConfig(width=32, height=24, spp=1, use_pallas_bounce=True,
                       wave_compact_group=1024)
    r = Renderer(cfg)
    r.prepare(scene)
    assert r.path == "two-stage"
    with pytest.raises(ValueError, match="untextured"):
        z = torch.zeros((4, 3))
        k5.trace_bounce(z, z, z, z, torch.ones(4, dtype=torch.bool),
                        torch.zeros(4, dtype=torch.int32), 0, 0, tables=r.tables,
                        mtab=r._mtab, seed=SEED, russian_roulette=True)
