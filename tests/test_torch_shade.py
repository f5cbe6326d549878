"""K2's plain version against tracy_tpu/ops/pallas_shade.py::shade_packets,
run in interpret mode on CPU as tests/test_pallas_shade.py runs it, on the
materials of data/scenes/default.scn (diffuse, metal, floor and glass).

Contract and why: the RNG bits match exactly, but sin/cos of torch CPU and
XLA CPU may differ in the last ulp, and a scatter direction carries that
ulp into the next state. A discrete decision (alive after Russian roulette,
or which lobe a lane took) compares a random number with a float, so an
ulp can flip one now and then:

* lanes whose `alive` or lobe differ: at most 0.1%;
* every float of every other lane: rtol 1e-5, atol 1e-6.

K2 updates its state in place, and so does its plain version: a dead lane
keeps every bit of its state, a miss lane changes only radiance and alive,
and the state after the call equals, bit for bit, the next state the
bounce computes into fresh tensors (ops/shade.py::_bounce_plain, what K2
returned before it worked in place), at each counter hash, Russian
roulette on and off.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracy_tpu.ops.pallas_shade import build_material_table as j_build_mtab
from tracy_tpu.ops.pallas_shade import shade_packets
from tracy_tpu.scene.scn_parser import load_scene as j_load_scene
from tracy_tpu_torch.ops import shade as k2
from tracy_tpu_torch.ops.compare import canned_lanes, decisions_flipped
from tracy_tpu_torch.scene import from_jax_arrays

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0xABCDEF


def compare_bounce(got, ref, decision_frac):
    """got/ref: (origin, direction, throughput, radiance, alive) tensors."""
    flipped = decisions_flipped(got, ref).numpy()
    assert flipped.mean() <= decision_frac, flipped.mean()
    keep = ~flipped
    for g, r in zip(got[:4], ref[:4]):
        np.testing.assert_allclose(g.numpy()[keep], r.numpy()[keep], rtol=1e-5, atol=1e-6)
    return keep


@pytest.mark.parametrize("rr", [True, False])
def test_shade_plain_matches_shade_packets(rr):
    jscene = j_load_scene(os.path.join(REPO, "data", "scenes", "default.scn")).build()
    num_m = int(np.asarray(jscene.materials.albedo).shape[0])
    assert (np.asarray(jscene.materials.translucent) > 0).any()  # glass present
    t = canned_lanes(num_m, 2048, seed=7, device="cpu")
    lanes = {k: v.numpy().copy() for k, v in t.items()}  # K2 updates t in place
    skey, bounce = 5, 2

    j = {k: jnp.asarray(v) for k, v in lanes.items()}
    ref = jax.jit(lambda: shade_packets(
        j["origin"], j["direction"], j["throughput"], j["radiance"], j["alive"],
        j["pixel_idx"].astype(jnp.uint32), j["hit_mask"], j["t"], j["normal"],
        j["mat_id"], j_build_mtab(jscene.materials), jnp.uint32(skey),
        jnp.int32(bounce), num_materials=num_m, seed=SEED, russian_roulette=rr,
        interpret=True))()
    ref = [torch.tensor(np.asarray(x)) for x in ref]

    scene = from_jax_arrays(jscene, device="cpu")
    before = k2.COUNT.plain
    got = k2.shade(t["origin"], t["direction"], t["throughput"], t["radiance"],
                   t["alive"], t["pixel_idx"], t["hit_mask"], t["t"], t["normal"],
                   t["mat_id"], k2.build_material_table(scene.materials), skey, bounce,
                   seed=SEED, russian_roulette=rr)
    assert k2.COUNT.plain == before + 1
    keep = compare_bounce(got, ref, decision_frac=0.001)
    got = [x.numpy() for x in got]

    # Dead lanes pass through unchanged; dead and missing lanes end.
    dead = ~lanes["alive"] & keep
    np.testing.assert_array_equal(got[0][dead], lanes["origin"][dead])
    np.testing.assert_array_equal(got[3][dead], lanes["radiance"][dead])
    assert not got[4][~lanes["alive"] | ~lanes["hit_mask"]].any()
    if not rr:
        np.testing.assert_array_equal(got[4], lanes["alive"] & lanes["hit_mask"])


@pytest.mark.parametrize("rng", ["fast", "xorshift", "lcg"])
@pytest.mark.parametrize("rr", [True, False])
def test_shade_updates_the_state_in_place(rr, rng):
    mtab = k2.build_material_table(from_jax_arrays(
        j_load_scene(os.path.join(REPO, "data", "scenes", "default.scn")).build(),
        device="cpu").materials)
    t = canned_lanes(mtab.shape[0], 2048, seed=9, device="cpu")
    state = [t[k] for k in ("origin", "direction", "throughput", "radiance", "alive")]
    old = [x.clone() for x in state]
    hit_rec = (t["pixel_idx"], t["hit_mask"], t["t"], t["normal"], t["mat_id"])
    kw = dict(seed=SEED, russian_roulette=rr, rng=rng)
    fresh = k2._bounce_plain(*old, t["pixel_idx"], t["hit_mask"], t["t"],
                             k2._params(k2._material_rows(mtab, t["mat_id"]), t["normal"]),
                             mtab[0, 6:9], 5, 2, SEED, rr, rng)
    got = k2.shade(*state, *hit_rec, mtab, 5, 2, **kw)
    assert all(g is x for g, x in zip(got, state))  # the caller's tensors, updated
    for g, f in zip(got, fresh):
        assert torch.equal(g, f)
    dead = ~old[4]
    miss = old[4] & ~t["hit_mask"]
    assert dead.sum() > 100 and miss.sum() > 100
    for g, o in zip(got, old):
        assert torch.equal(g[dead], o[dead])
    for g, o in zip(got[:3], old[:3]):  # origin, direction, throughput
        assert torch.equal(g[miss], o[miss])
    assert not (got[3][miss] == old[3][miss]).all() and not got[4][miss].any()


def test_material_table_lookup_matches():
    """Row lookup by gather vs the JAX one-hot contraction: exact."""
    from tracy_tpu.render.material import material_table_lookup as j_lookup
    from tracy_tpu_torch.render.material import material_table_lookup

    jscene = j_load_scene(os.path.join(REPO, "data", "scenes", "default.scn")).build()
    num_m = int(np.asarray(jscene.materials.albedo).shape[0])
    ids = np.random.default_rng(8).integers(0, num_m, 512).astype(np.int32)
    ref = j_lookup(jscene.materials, jnp.asarray(ids))[:6]
    got = material_table_lookup(from_jax_arrays(jscene, device="cpu").materials, torch.as_tensor(ids))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
