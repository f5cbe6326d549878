"""The textured bounce's plain versions against tracy_tpu on the CPU, on
tests/test_pallas_texfetch.py's textured fixture built in both packages:

* K1's plain version with uv and tangent against `interpolate_hit` for the
  same winners: identical (both compute w*a0 + u*a1 + v*a2 with
  w = 1 - u - v in float32, in that order; one ulp of uv can move a texel
  index at a cell edge, so nothing looser will do);
* K3's plain version against `sample_nearest` for every slot, and against
  `lane_page_indices` + `fetch_texels(interpret=True)` at 2,048 lanes:
  identical on hit lanes; a sky lane (a miss, addressed through torch's
  atan2/asin against XLA's) may land on another texel on at most 0.1% of
  the sky lanes;
* K4's plain version, which fetches its own texels (K3's plain fetch) and
  shades in place, against `shade_packets_textured(interpret=True)`, the
  same function end to end (texel fetch + textured bounce), with K2's
  contract (tests/test_torch_shade.py): lanes whose alive flag or lobe
  differ at most 0.1%; every float of every other lane rtol 1e-5, atol 1e-6.
  (The TPU kernel normalises by multiplying with 1/sqrt, the port divides
  by sqrt as tracy_tpu's XLA path does: an ulp apart.) K4 updates the
  state it is given in place, so the test hands it copies.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracy_tpu.ops.pallas_shade import build_material_table_tex as j_mtab_tex
from tracy_tpu.ops.pallas_shade import shade_packets_textured
from tracy_tpu.ops.pallas_texfetch import (
    PAGE_ROWS,
    TEXEL_ROWS,
    build_texture_pages,
    fetch_texels,
    lane_page_indices,
)
from tracy_tpu.render.integrator import interpolate_hit as j_interpolate_hit
from tracy_tpu.render.integrator import sky_emission as j_sky_emission
from tracy_tpu.render.intersect import Hit as JHit
from tracy_tpu.render.texture import sample_nearest as j_sample_nearest
from tracy_tpu_torch.accel.tables import build_tables
from tracy_tpu_torch.ops import compare
from tracy_tpu_torch.ops import intersect as k1
from tracy_tpu_torch.ops import shade as k2
from tracy_tpu_torch.ops import texfetch as k3
from tracy_tpu_torch.render.integrator import sky_emission
from tracy_tpu_torch.render.texture import SLOT_COLUMNS, TEXEL_ROWS as T_TEXEL_ROWS
from tracy_tpu_torch.scene import from_jax_arrays
from test_torch_intersect import make_rays
from test_torch_shade import compare_bounce
from test_torch_textures import textured_builders

torch.set_num_threads(2)

SEED = 0xABCDEF
N = 2048


@pytest.fixture(scope="module")
def scenes():
    jb, _ = textured_builders()
    js = jb.build()
    return js, from_jax_arrays(js, device="cpu")


def lanes_for(scene, seed):
    """Canned textured lanes (numpy, from a seed) as torch tensors and as
    numpy arrays."""
    t = compare.textured_lanes(scene.materials.num_materials, N, seed=seed, device="cpu")
    return t, {k: v.numpy() for k, v in t.items()}


def test_k1_plain_uv_and_tangent_match_interpolate_hit(scenes):
    js, scene = scenes
    tables = build_tables(scene, leaf_size=4, max_depth=32)
    assert tables.vertex_uv is not None and tables.vertex_tangent is not None
    origin, direction = make_rays(scene, N, seed=4)
    o, d = torch.as_tensor(origin), torch.as_tensor(direction)
    before = k1.COUNT.plain
    sh = k1.intersect(o, d, torch.ones(N, dtype=torch.bool), tables)
    assert k1.COUNT.plain == before + 1
    hit = sh.hit
    assert hit.mask.sum() > N // 8
    ref = j_interpolate_hit(js, JHit(t=jnp.asarray(hit.t.numpy()), tri=jnp.asarray(hit.tri.numpy()),
                                     uv=jnp.asarray(hit.uv.numpy()), mask=jnp.asarray(hit.mask.numpy())),
                            jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    m = hit.mask.numpy()
    np.testing.assert_array_equal(sh.tex_uv.numpy()[m], np.asarray(ref.uv)[m])
    np.testing.assert_array_equal(sh.tangent.numpy()[m], np.asarray(ref.tangent)[m])
    np.testing.assert_array_equal(sh.normal.numpy()[m], np.asarray(ref.normal)[m])
    np.testing.assert_array_equal(sh.material.numpy()[m], np.asarray(ref.material)[m])
    assert not sh.tex_uv.numpy()[~m].any() and not sh.tangent.numpy()[~m].any()


def test_k3_plain_matches_sample_nearest(scenes):
    js, scene = scenes
    t, lanes = lanes_for(scene, seed=11)
    before = k3.COUNT.plain
    got = k3.fetch_texels(t["mat_id"], t["tex_uv"], t["direction"], t["hit_mask"], t["alive"],
                          scene.tex_data, scene.tex_table, scene.materials.tex_index).numpy()
    assert k3.COUNT.plain == before + 1
    hit = lanes["alive"] & lanes["hit_mask"]
    sky = lanes["alive"] & ~lanes["hit_mask"]
    tex_index = np.asarray(js.materials.tex_index)
    fetched = 0
    for slot, (c0, nch) in enumerate(SLOT_COLUMNS):
        tid = tex_index[lanes["mat_id"], slot]
        want = np.asarray(j_sample_nearest(js.tex_data, js.tex_table, jnp.asarray(tid),
                                           jnp.asarray(lanes["tex_uv"])))[:, :nch]
        on = hit & (tid >= 0)
        fetched += on.sum()
        np.testing.assert_array_equal(got[on, c0:c0 + nch], want[on])
        if slot != 4:
            assert not got[~on, c0:c0 + nch].any()
    assert fetched > N
    # Sky lanes: the equirect texel tracy_tpu's sky_emission reads.
    want_sky = np.asarray(j_sky_emission(js, jnp.asarray(lanes["direction"])))
    em = SLOT_COLUMNS[4][0]
    differ = (got[sky, em:em + 3] != want_sky[sky]).any(axis=1)
    assert differ.sum() <= 0.001 * sky.sum(), (differ.sum(), sky.sum())
    assert not got[~(hit | sky)].any()
    # The port's own sky_emission reads the same texels as K3's sky lanes.
    ours_sky = sky_emission(scene, t["direction"]).numpy()
    np.testing.assert_array_equal(ours_sky[sky], got[sky, em:em + 3])


def test_k3_plain_matches_fetch_texels_interpret(scenes):
    js, scene = scenes
    t, lanes = lanes_for(scene, seed=12)
    tp = build_texture_pages(js)
    assert tp is not None and TEXEL_ROWS == T_TEXEL_ROWS
    page, lanepos = lane_page_indices(
        tp, jnp.asarray(lanes["mat_id"]), jnp.asarray(lanes["tex_uv"]),
        jnp.asarray(lanes["direction"]), jnp.asarray(lanes["hit_mask"]),
        jnp.asarray(lanes["alive"]))
    out = np.asarray(fetch_texels(tp.pages, page, lanepos, interpret=True))
    want = out.transpose(0, 2, 3, 1).reshape(N, PAGE_ROWS)[:, :TEXEL_ROWS]
    got = k3.fetch_texels_plain(t["mat_id"], t["tex_uv"], t["direction"], t["hit_mask"],
                                t["alive"], scene.tex_data, scene.tex_table,
                                scene.materials.tex_index).numpy()[:, :TEXEL_ROWS]
    hit = lanes["alive"] & lanes["hit_mask"]
    sky = lanes["alive"] & ~lanes["hit_mask"]
    np.testing.assert_array_equal(got[hit], want[hit])
    np.testing.assert_array_equal(got[~(hit | sky)], want[~(hit | sky)])
    differ = (got[sky] != want[sky]).any(axis=1)
    assert differ.sum() <= 0.001 * sky.sum(), (differ.sum(), sky.sum())


@pytest.mark.parametrize("rr", [True, False])
def test_k4_plain_matches_shade_packets_textured(scenes, rr):
    js, scene = scenes
    t, lanes = lanes_for(scene, seed=13)
    skey, bounce = 5, 2
    tp = build_texture_pages(js)
    jmtab = j_mtab_tex(js.materials, tp)
    j = {k: jnp.asarray(v) for k, v in lanes.items()}
    ref = jax.jit(lambda: shade_packets_textured(
        j["origin"], j["direction"], j["throughput"], j["radiance"], j["alive"],
        j["pixel_idx"].astype(jnp.uint32), j["hit_mask"], j["t"], j["normal"],
        j["tangent"], j["tex_uv"], j["mat_id"], jmtab, tp,
        jnp.uint32(skey), jnp.int32(bounce), num_materials=scene.materials.num_materials,
        seed=SEED, russian_roulette=rr, interpret=True))()
    ref = [torch.tensor(np.asarray(x)) for x in ref]

    mtab = k2.build_material_table_tex(scene.materials)
    np.testing.assert_array_equal(mtab.numpy().T[:15],
                                  np.asarray(jmtab)[:15, :scene.materials.num_materials])
    args = compare.textured_args(t)
    before = (k2.COUNT_TEX.plain, k3.COUNT.plain)
    got = k2.shade_textured(*args, mtab, scene.tex_data, scene.tex_table,
                            scene.materials.tex_index, skey, bounce, seed=SEED,
                            russian_roulette=rr)
    assert (k2.COUNT_TEX.plain, k3.COUNT.plain) == (before[0] + 1, before[1])
    # In place: the returned state is the state it was given.
    assert all(g is a for g, a in zip(got, args[:5]))
    compare_bounce(got, ref, decision_frac=0.001)
