"""Each kernel against its plain PyTorch version on the same device, with
the agreement contract of the card, plus CUDA-event timing.

Used by chip_smoke.py and the `cuda`-marked tests. On the card both sides
run the same IEEE float32 operations in the same order (the kernels are
built without FMA contraction or fast math), so the contracts are tight:

* K1: hit masks agree on >= 99.99% of rays; on rays both sides hit,
  |dt| <= 1e-5 * t + 1e-6.
* K2 and K4: lanes whose alive flag or lobe differ <= 0.01%; every float
  of every other lane within rtol 1e-5, atol 1e-6. Both update their state
  in place, so each side gets its own copy.
* K3: hit lanes' texels identical; sky lanes (misses, which address the
  equirect through atan2f/asinf against torch's CUDA atan2/asin) on another
  texel on at most 0.01% of lanes.
* K5: K2's contract against its plain version (K1's plain version, then
  K2's); and against K1 then K2 launched on the same lanes, all five
  outputs equal: the three kernels share their device functions. Under
  compaction (compare_bounce_compacted) a slot draws threefry's numbers
  at its lane's wave position, so compacted K5 equals K1 then K2 too.

Each comparison also says whether every output is equal bit for bit
(`bit_equal`), which rng 'threefry' is held to on the card: its draws
are integer work, and the rest runs the same float32 operations.

Beside each kernel, `bound_ms`: the least time an H100 could take for the
same work, the larger of the bytes it must move over 3.35 TB/s and its
float32 operations over 67 TFLOP/s (NVIDIA's H100 SXM data sheet), with the
counts taken from this run's inputs. The bytes count each input byte the
work needs once, by lane class (a dead lane needs its alive flag only, a
miss lane no hit record, a hit lane no direction for its sky texel), each
distinct atlas texel once however many lanes read it, and each output where
the work changes it: a K3 row only for a lane that fetched a texel, K2/K4's
state only for the lanes the bounce moves. K4's bound is the textured
bounce's work whatever the design: K2's bytes by lane class plus the
tangents, and K3's texel work on the same lanes (textured_bounce_bound).
K1's and K5's traversal work has one yardstick at every width: the binary
tree's inner-node visits and triangle tests, counted by the plain binary
traversal of the same rays, and the bytes of the binary tables, so that a
kernel does not earn a better share of its bound by walking another tree.
The wide trees' own counts are reported beside it.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

import numpy as np
import torch

from tracy_tpu_torch.accel.reorder import compact_bounce, compact_intersector
from tracy_tpu_torch.ops import bounce as k5
from tracy_tpu_torch.ops import intersect as k1
from tracy_tpu_torch.ops import shade as k2
from tracy_tpu_torch.ops import texfetch as k3
from tracy_tpu_torch.render.intersect import Hit
from tracy_tpu_torch.render.material import RAY_OFFSET
from tracy_tpu_torch.render.texture import SLOT_COLUMNS
from tracy_tpu_torch.scene.scene import TEX_NORMAL

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# Float32 operations counted per unit of work, from csrc/: a slab test is 6
# sub, 6 mul, 10 min/max and 3 compares, two per inner node; a triangle test
# does at least its cross product, determinant and first compare (15) before
# it can exit early. K3: the address math of one texel (frac, flip, clip,
# scale: 12) and the sky's atan2 + asin (about 40). K2/K4: the shading math
# of one live lane (about 250; K4's normal mapping about 60 more).
OPS_INNER_NODE = 50
OPS_TRI_TEST = 15
OPS_TEXEL = 12
OPS_SKY_UV = 40
OPS_SHADE_LANE = 250
OPS_NORMAL_MAP = 60


def bound_ms(nbytes: float, ops: float) -> Dict[str, object]:
    """The least time for `nbytes` moved and `ops` float32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": float(nbytes), "ops": float(ops)}


def nbytes(*tensors) -> int:
    return sum(0 if x is None else x.numel() * x.element_size() for x in tensors)


def cuda_ms(fn: Callable[[], object], reps: int) -> float:
    """Mean milliseconds of fn() on the current stream, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def intersect_rays(scene, tables, n: int, seed: int):
    """n rays on scene's device: n/2 camera rays at random (s, t), and n/2
    rays leaving the plain version's hit points of those in random
    directions (offset RAY_OFFSET along the new direction, as the shade
    stage offsets them). Secondary rays whose primary missed stay dead."""
    rng = np.random.default_rng(seed)
    dev = scene.device
    k = n // 2
    st = torch.as_tensor(rng.uniform(size=(2, k)).astype(np.float32), device=dev)
    o1, d1 = scene.camera.generate_rays(st[0], st[1])
    o1, d1 = o1.contiguous(), d1.contiguous()
    prim = k1.intersect_plain(o1, d1, torch.ones(k, dtype=torch.bool, device=dev),
                              tables).hit
    pick = torch.as_tensor(rng.integers(0, k, n - k), device=dev)
    d2 = torch.as_tensor(rng.standard_normal((n - k, 3)).astype(np.float32), device=dev)
    d2 = d2 / torch.linalg.vector_norm(d2, dim=-1, keepdim=True)
    p = o1[pick] + prim.t[pick, None] * d1[pick]
    o2 = torch.where(prim.mask[pick, None], p + RAY_OFFSET * d2, o1[pick])
    origin = torch.cat([o1, o2]).contiguous()
    direction = torch.cat([d1, d2]).contiguous()
    active = torch.cat([torch.ones(k, dtype=torch.bool, device=dev), prim.mask[pick]])
    return origin, direction, active


def compare_intersect(origin, direction, active, tables) -> Dict[str, float]:
    """K1 vs intersect_plain on CUDA tensors, both at the tables' width;
    raises on a broken contract. Also K1's bound on these rays, from the
    yardstick of traversal_work."""
    got = k1.intersect(origin, direction, active, tables)
    counts = {}
    ref = k1.intersect_plain(origin, direction, active, tables, counts=counts)
    gm, rm = got.hit.mask, ref.hit.mask
    agree = float((gm == rm).float().mean())
    both = gm & rm
    gt, rt = got.hit.t[both], ref.hit.t[both]
    err = (gt - rt).abs()
    excess = float((err - (1e-5 * rt + 1e-6)).max()) if both.any() else -1.0
    same = both & (got.hit.tri == ref.hit.tri)
    n_err = float((got.normal[same] - ref.normal[same]).abs().max()) if same.any() else 0.0
    res = {"rays": origin.shape[0], "hit_fraction": float(rm.float().mean()),
           "mask_agree": agree, "max_abs_err": float(err.max()) if both.any() else 0.0,
           "normal_max_abs_err": n_err,
           "material_equal": bool((got.material[same] == ref.material[same]).all())}
    for name in ("tex_uv", "tangent"):
        g, r = getattr(got, name), getattr(ref, name)
        if (g is None) != (r is None):
            raise RuntimeError(f"K1 and its plain version disagree on {name}")
        if g is not None:
            res[f"{name}_max_abs_err"] = (float((g[same] - r[same]).abs().max())
                                          if same.any() else 0.0)
    if agree < 0.9999 or excess > 0.0 or not res["material_equal"]:
        raise RuntimeError(f"K1 disagrees with its plain version: {res}")
    tb = tables
    moved = (nbytes(origin, direction, active, *got.hit, got.normal, got.material,
                    got.tex_uv, got.tangent)
             + nbytes(tb.node_bounds, tb.node_meta, tb.tri, tb.tri_meta, tb.tri_id,
                      tb.vertex_normal, tb.vertex_uv, tb.vertex_tangent))
    res.update(traversal_work(origin, direction, active, tables, counts))
    res.update(bound_ms(moved, res["traversal_ops"]))
    return res


def traversal_work(origin, direction, active, tables, counts) -> Dict[str, object]:
    """The yardstick of K1's and K5's traversal (module docstring): the
    binary traversal's inner visits and triangle tests on these rays (from
    `counts` when the tables are binary, else from one more plain binary
    run), their operations, and at widths 4 and 8 the wide tree's own
    counts."""
    res = {"width": tables.width}
    if tables.width > 2:
        res.update(wide_inner_visits=int(counts["wide_inner"]),
                   wide_box_tests=int(counts["box_tests"]),
                   wide_tri_tests=int(counts["tri_tests"]),
                   wide_culled_pops=int(counts["culled_pops"]),
                   wide_simt=simt(counts, "wide_inner"))
        counts = {}
        k1.intersect_plain(origin, direction, active, tables.binary(), counts=counts)
    res.update(inner_visits=int(counts["inner"]), tri_tests=int(counts["tri_tests"]),
               binary_simt=simt(counts, "inner"))
    res["traversal_ops"] = (OPS_INNER_NODE * float(counts["inner"])
                            + OPS_TRI_TEST * float(counts["tri_tests"]))
    return res


def simt(counts, nodes: str) -> Dict[str, float]:
    """The share of a warp's 32 lanes doing useful work, in the kernel's
    node and triangle-test iterations (intersect_plain's warp counts)."""
    return {"node": float(counts[nodes]) / max(32 * float(counts["warp_node_steps"]), 1.0),
            "tri": float(counts["tri_tests"]) / max(32 * float(counts["warp_tri_steps"]), 1.0)}


def canned_lanes(num_materials: int, n: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """A plausible mid-path state and hit record for n lanes, from numpy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    d = rng.standard_normal((n, 3)).astype(f32)
    nrm = rng.standard_normal((n, 3)).astype(f32)
    hit = rng.uniform(size=n) < 0.7
    lanes = dict(
        origin=rng.standard_normal((n, 3)).astype(f32),
        direction=(d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(f32),
        throughput=rng.uniform(0.05, 1.0, (n, 3)).astype(f32),
        radiance=rng.uniform(0.0, 0.5, (n, 3)).astype(f32),
        alive=rng.uniform(size=n) < 0.9,
        pixel_idx=rng.integers(0, 1 << 21, n).astype(np.int32),
        hit_mask=hit,
        t=np.where(hit, rng.uniform(0.5, 20.0, n), 3.4028235e38).astype(f32),
        normal=(nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(f32),
        mat_id=rng.integers(1, num_materials, n).astype(np.int32),
    )
    return {k: torch.as_tensor(v, device=device) for k, v in lanes.items()}


SHADE_ARGS = ("origin", "direction", "throughput", "radiance", "alive",
              "pixel_idx", "hit_mask", "t", "normal", "mat_id")


def decisions_flipped(got, ref) -> torch.Tensor:
    """Lanes whose alive flag or scatter lobe differ: [N] bool.
    got/ref: (origin, direction, throughput, radiance, alive)."""
    return (got[4] != ref[4]) | ((got[1] - ref[1]).abs().amax(dim=-1) > 1e-3)


def compare_shade(lanes, mtab, sample_key: int, bounce: int, *, seed: int,
                  russian_roulette: bool, rng: str = "fast",
                  decision_frac: float = 1e-4, route=None) -> Dict[str, float]:
    """K2 vs shade_plain on CUDA tensors, each on its own copy of the lanes'
    state (both update it in place); raises on a broken contract. route:
    K2's table route (None: the one its wrapper picks)."""
    kw = dict(seed=seed, russian_roulette=russian_roulette, rng=rng)
    got = k2.shade(*state_args(lanes, SHADE_ARGS), mtab, sample_key, bounce, route=route,
                   **kw)
    ref = k2.shade_plain(*state_args(lanes, SHADE_ARGS), mtab, sample_key, bounce, **kw)
    res = _bounce_agreement("K2", got, ref, decision_frac)
    res.update(in_place_kept(lanes, got))
    if res["dead_lanes_changed"] or res["miss_lanes_changed"]:
        raise RuntimeError(f"K2 wrote state its lane class does not change: {res}")
    res["bit_equal"] = all(bool(torch.equal(g, r)) for g, r in zip(got, ref))
    res.update(bound_ms(*_bounce_work(lanes, mtab, textured=False)))
    return res


def in_place_kept(lanes, got) -> Dict[str, int]:
    """What an in-place bounce must leave as it was: every bit of a dead
    lane's state, and a miss lane's origin, direction and throughput.
    Returns the counts of lanes that broke it."""
    old = [lanes[k] for k in STATE]
    dead = ~old[4]
    miss = old[4] & ~lanes["hit_mask"]

    def changed(tensors, lane):
        bad = torch.zeros_like(lane)
        for g, o in zip(got, tensors):
            diff = g != o
            bad |= diff.view(diff.shape[0], -1).any(dim=1)
        return int((bad & lane).sum())

    return {"dead_lanes_changed": changed(old, dead),
            "miss_lanes_changed": changed(old[:3], miss)}


def textured_lanes(num_materials: int, n: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """canned_lanes plus what a textured bounce also reads: the texture uv
    (with repeats and negative values) and an unnormalised tangent."""
    lanes = canned_lanes(num_materials, n, seed, device)
    rng = np.random.default_rng(seed + 1)
    f32 = np.float32
    lanes["tex_uv"] = torch.as_tensor(rng.uniform(-1.5, 2.5, (n, 2)).astype(f32), device=device)
    lanes["tangent"] = torch.as_tensor(rng.standard_normal((n, 3)).astype(f32), device=device)
    return lanes


TEXFETCH_ARGS = ("mat_id", "tex_uv", "direction", "hit_mask", "alive")


def compare_texfetch(lanes, scene, sky_frac: float = 1e-4, route=None) -> Dict[str, object]:
    """K3 vs fetch_texels_plain on CUDA tensors; raises on a broken contract.
    Also returns the atlas rows the lanes read ("addresses", for the
    index_select yardstick). route: as compare_shade's."""
    args = [lanes[k] for k in TEXFETCH_ARGS]
    tex = (scene.tex_data, scene.tex_table, scene.materials.tex_index)
    got = k3.fetch_texels(*args, *tex, route=route)
    ref = k3.fetch_texels_plain(*args, *tex)
    hit = lanes["alive"] & lanes["hit_mask"]
    sky = lanes["alive"] & ~lanes["hit_mask"]
    differ = (got != ref).any(dim=1)
    res = {"lanes": args[0].shape[0], "hit_lanes": int(hit.sum()),
           "hit_lanes_differ": int((differ & hit).sum()),
           "sky_lanes": int(sky.sum()), "sky_lanes_differ": int((differ & sky).sum()),
           "other_lanes_nonzero": int((got[~(hit | sky)] != 0).any(dim=1).sum()),
           "max_abs_err": float((got - ref).abs().max())}
    if (res["hit_lanes_differ"] or res["other_lanes_nonzero"]
            or res["sky_lanes_differ"] > sky_frac * max(res["lanes"], 1)):
        raise RuntimeError(f"K3 disagrees with its plain version: {res}")
    work = texfetch_work(lanes, scene)
    # The bound: the lane inputs by class (every lane its alive flag, a live
    # lane its hit flag, a hit lane its material), the texel work, and 11
    # floats (44 bytes) out for each lane that fetched.
    moved = (res["lanes"] + int(lanes["alive"].sum()) + 4 * res["hit_lanes"] + work["bytes"]
             + sum(SLOT_BYTES) * (work["hit_lanes_fetching"] + work["sky_lanes_fetching"]))
    res.update(bound_ms(moved, work["ops"]))
    res["texels_fetched"] = work["fetched"]
    res["texels_distinct"] = work["distinct"]
    res["addresses"] = work["addresses"]
    return res


def texfetch_work(lanes, scene) -> Dict[str, object]:
    """The texel fetch's work on these lanes, as K3 and K4 both must do it:
    the uv of each hit lane that fetches (8 bytes), the direction of each
    sky lane that fetches (12), the two tables once, each distinct atlas
    texel once (16); the address math of each fetch and the sky lanes'
    atan2 + asin. Also the atlas rows read ("addresses")."""
    args = [lanes[k] for k in TEXFETCH_ARGS]
    tex_index = scene.materials.tex_index
    flat = k3.texel_addresses(*args, scene.tex_table, tex_index)
    fetching = (flat >= 0).any(dim=1)
    live = lanes["alive"]
    n_hit = int((fetching & live & lanes["hit_mask"]).sum())
    n_sky = int((fetching & live & ~lanes["hit_mask"]).sum())
    fetched = int((flat >= 0).sum())
    distinct = int(flat[flat >= 0].unique().numel())
    return {"bytes": (8 * n_hit + 12 * n_sky + nbytes(scene.tex_table, tex_index)
                      + 16 * distinct),
            "ops": OPS_TEXEL * fetched + OPS_SKY_UV * n_sky,
            "hit_lanes_fetching": n_hit, "sky_lanes_fetching": n_sky,
            "fetched": fetched, "distinct": distinct, "addresses": flat[flat >= 0]}


def compare_shade_textured(lanes, scene, mtab, sample_key: int, bounce: int, *,
                           seed: int, russian_roulette: bool, rng: str = "fast",
                           decision_frac: float = 1e-4, route=None) -> Dict[str, float]:
    """K4 vs shade_textured_plain on CUDA tensors, each on its own copy of
    the lanes' state (both update it in place); raises on a broken
    contract. Also K4's bound on these lanes (textured_bounce_bound).
    route: as compare_shade's."""
    kw = dict(seed=seed, russian_roulette=russian_roulette, rng=rng)
    tex = (scene.tex_data, scene.tex_table, scene.materials.tex_index)
    got = k2.shade_textured(*textured_args(lanes), mtab, *tex, sample_key, bounce,
                            route=route, **kw)
    ref = k2.shade_textured_plain(*textured_args(lanes), mtab, *tex, sample_key, bounce,
                                  **kw)
    res = _bounce_agreement("K4", got, ref, decision_frac)
    res["bit_equal"] = all(bool(torch.equal(g, r)) for g, r in zip(got, ref))
    differ = torch.zeros_like(lanes["alive"])
    for g, r in zip(got, ref):
        diff = g != r
        differ |= diff.view(diff.shape[0], -1).any(dim=1)
    # K3's contract: a sky lane may address another texel; a hit lane not.
    res["lanes_differing"] = int(differ.sum())
    res["hit_lanes_differing"] = int((differ & lanes["alive"] & lanes["hit_mask"]).sum())
    res.update(textured_bounce_bound(lanes, scene, mtab))
    return res


def state_args(lanes, names):
    """The lane arguments `names`, with fresh copies of the state (STATE),
    which K2 and K4 update in place."""
    return [lanes[k].clone() if k in STATE else lanes[k] for k in names]


def textured_args(lanes):
    """shade_textured's lane arguments, with fresh copies of the state."""
    return state_args(lanes, SHADE_TEX_ARGS)


def textured_bounce_bound(lanes, scene, mtab) -> Dict[str, object]:
    """K4's bound on these lanes: the textured bounce's bytes by lane class
    (_bounce_work) and the texel fetch's work (texfetch_work), each counted
    from the lanes and the scene alone, so that no design of the kernel
    changes it."""
    moved, ops = _bounce_work(lanes, mtab, textured=True)
    work = texfetch_work(lanes, scene)
    return bound_ms(moved + work["bytes"], ops + work["ops"])


def inplace_ms(fn, lanes, reps: int, names=None) -> float:
    """CUDA-event milliseconds of fn(args) for an in-place kernel, args the
    lane arguments `names` (shade_textured's by default): each launch gets
    its own fresh copy of the state (made before the timed window), so that
    every launch sees the same lanes."""
    copies = [state_args(lanes, names or SHADE_TEX_ARGS) for _ in range(reps + 1)]
    fn(copies[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for args in copies[1:]:
        fn(args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


SHADE_TEX_ARGS = ("origin", "direction", "throughput", "radiance", "alive",
                  "pixel_idx", "hit_mask", "t", "normal", "tangent", "tex_uv", "mat_id")
STATE = ("origin", "direction", "throughput", "radiance", "alive")
# Bytes a lane of the bounce reads and writes, by class. A dead lane reads
# its alive flag and nothing else. A miss lane reads alive, hit_mask,
# throughput and radiance and writes radiance and alive. A hit lane reads
# alive, hit_mask, pixel_idx, mat_id, origin, direction, throughput,
# radiance, t and normal and writes the whole state.
DEAD_LANE_BYTES = 1
MISS_LANE_BYTES = 2 + 24 + 12 + 1
HIT_LANE_BYTES = 2 + 4 + 4 + 48 + 4 + 12 + 48 + 1
# A K3 row's texel values of each slot (TEX_* order).
SLOT_BYTES = tuple(4 * nch for _, nch in SLOT_COLUMNS)
# A textured hit lane also reads its tangent where its material has a
# normal map.
TANGENT_BYTES = 12


def _bounce_work(lanes, mtab, *, textured: bool):
    """(bytes, ops) of K2's or K4's bounce on these lanes, without the
    texel fetch: the bytes by lane class above, the material table once,
    the tangent of each normal-mapped hit lane (textured), and the shading
    math of each hit lane."""
    alive, hit_mask = lanes["alive"], lanes["hit_mask"]
    hit = alive & hit_mask
    n_hit, n_miss = int(hit.sum()), int((alive & ~hit_mask).sum())
    n_dead = alive.numel() - n_hit - n_miss
    moved = (DEAD_LANE_BYTES * n_dead + MISS_LANE_BYTES * n_miss + HIT_LANE_BYTES * n_hit
             + nbytes(mtab))
    ops = OPS_SHADE_LANE * n_hit
    if textured:
        rows = k2._material_rows(mtab, lanes["mat_id"][hit])
        n_mapped = int((rows[:, k2.HAS_COL + TEX_NORMAL] > 0).sum())
        moved += TANGENT_BYTES * n_mapped
        ops += OPS_NORMAL_MAP * n_mapped
    return moved, ops


def _bounce_agreement(kernel: str, got, ref, decision_frac: float) -> Dict[str, float]:
    flipped = decisions_flipped(got, ref)
    keep = ~flipped
    err, bad = 0.0, False
    for g, r in zip(got[:4], ref[:4]):
        g, r = g[keep], r[keep]
        err = max(err, float((g - r).abs().max()))
        bad |= bool(((g - r).abs() > 1e-6 + 1e-5 * r.abs()).any())
    res = {"lanes": got[0].shape[0], "flipped": float(flipped.float().mean()),
           "max_abs_err": err}
    if res["flipped"] > decision_frac or bad:
        raise RuntimeError(f"{kernel} disagrees with its plain version: {res}")
    return res


BOUNCE_ARGS = ("origin", "direction", "throughput", "radiance", "alive", "pixel_idx")
# Bytes a lane of K5 reads and writes, by class (csrc/bounce.cu). A dead
# lane reads its alive flag and its state passes through. A miss lane reads
# alive, origin, direction (its traversal), throughput and radiance, and
# writes radiance and alive. A hit lane also reads its pixel id and writes
# the whole state. No hit record: the kernel keeps it in registers.
BOUNCE_MISS_LANE_BYTES = 1 + 24 + 24 + 12 + 1
BOUNCE_HIT_LANE_BYTES = 1 + 24 + 24 + 4 + 48 + 1


def compare_bounce(lanes, tables, mtab, sample_key: int, bounce: int, *, seed: int,
                   russian_roulette: bool, rng: str = "fast",
                   decision_frac: float = 1e-4) -> Dict[str, object]:
    """K5 vs trace_bounce_plain on CUDA tensors (K2's contract), and K5 vs
    K1 then K2 launched on a copy of the same lanes (all five outputs
    equal), all at the tables' width; raises on a broken contract. Also
    K5's bound on these lanes: K1's yardstick operations (traversal_work), the bytes by
    lane class above, the binary tables and the material table once, and
    the shading math of each hit lane."""
    args = [lanes[k] for k in BOUNCE_ARGS]
    kw = dict(seed=seed, russian_roulette=russian_roulette, rng=rng)
    got = k5.trace_bounce(*args, sample_key, bounce, tables=tables, mtab=mtab, **kw)
    counts = {}
    ref = k5.trace_bounce_plain(*args, sample_key, bounce, tables=tables, mtab=mtab,
                                counts=counts, **kw)
    res = _bounce_agreement("K5", got, ref, decision_frac)
    res["bit_equal"] = all(bool(torch.equal(g, r)) for g, r in zip(got, ref))
    o, d, thr, rad, alive, pix = args
    sh = k1.intersect(o, d, alive, tables)
    two = k2.shade(*(x.clone() for x in (o, d, thr, rad, alive)), pix, sh.hit.mask,
                   sh.hit.t, sh.normal, sh.material, mtab, sample_key, bounce, **kw)
    res["equal_to_k1_k2"] = [bool(torch.equal(g, r)) for g, r in zip(got, two)]
    if not all(res["equal_to_k1_k2"]):
        raise RuntimeError(f"K5 differs from K1 then K2 on the same lanes: {res}")
    hit = alive & sh.hit.mask
    n_hit, n_miss = int(hit.sum()), int((alive & ~sh.hit.mask).sum())
    n_dead = alive.numel() - n_hit - n_miss
    tb = tables
    moved = (DEAD_LANE_BYTES * n_dead + BOUNCE_MISS_LANE_BYTES * n_miss
             + BOUNCE_HIT_LANE_BYTES * n_hit
             + nbytes(tb.node_bounds, tb.node_meta, tb.tri, tb.tri_meta, tb.vertex_normal, mtab))
    res.update(traversal_work(o, d, alive, tables, counts))
    res.update(bound_ms(moved, res["traversal_ops"] + OPS_SHADE_LANE * n_hit))
    res.update(hit_lanes=n_hit, miss_lanes=n_miss, dead_lanes=n_dead)
    return res


def compare_bounce_compacted(lanes, tables, mtab, group: int, sample_key: int, bounce: int,
                             *, seed: int, russian_roulette: bool,
                             rng: str = "fast") -> Dict[str, object]:
    """K5 under accel/reorder.py::compact_bounce (the fused path's binding)
    against K1 then K2 launched on the same lanes uncompacted, and against
    K5's plain version under the same compaction: all five outputs equal
    bit for bit, or it raises."""
    args = [lanes[k] for k in BOUNCE_ARGS]
    kw = dict(tables=tables, mtab=mtab, seed=seed, russian_roulette=russian_roulette, rng=rng)
    got = compact_bounce(functools.partial(k5.trace_bounce, **kw), group)(
        *args, sample_key, bounce)
    plain = compact_bounce(functools.partial(k5.trace_bounce_plain, **kw), group)(
        *args, sample_key, bounce)
    o, d, thr, rad, alive, pix = args
    sh = k1.intersect(o, d, alive, tables)
    two = k2.shade(*(x.clone() for x in (o, d, thr, rad, alive)), pix, sh.hit.mask,
                   sh.hit.t, sh.normal, sh.material, mtab, sample_key, bounce, seed=seed,
                   russian_roulette=russian_roulette, rng=rng)
    res = {"lanes": o.shape[0], "live_lanes": int(alive.sum()), "group": group,
           "equal_to_k1_k2": [bool(torch.equal(g, r)) for g, r in zip(got, two)],
           "equal_to_plain": [bool(torch.equal(g, r)) for g, r in zip(got, plain)]}
    if not all(res["equal_to_k1_k2"] + res["equal_to_plain"]):
        raise RuntimeError(f"compacted K5 differs from K1 then K2 or from its plain "
                           f"version: {res}")
    return res


def compaction_ms(origin, direction, throughput, radiance, alive, pixel_idx, group: int,
                  reps: int = 20) -> Dict[str, float]:
    """CUDA-event milliseconds of one compaction round trip on these lanes,
    with the kernel left out: compact_intersector around an intersector
    that returns a ready SurfaceHit (the rays route down, the hit record
    back), and compact_bounce around a bounce that returns its input (the
    state down, the next state back)."""
    n = origin.shape[0]
    dev = origin.device

    def f32(*shape):
        return torch.zeros((n,) + shape, dtype=torch.float32, device=dev)

    ready = k1.SurfaceHit(
        Hit(t=f32(), tri=torch.zeros(n, dtype=torch.int32, device=dev), uv=f32(2),
            mask=torch.zeros(n, dtype=torch.bool, device=dev)),
        f32(3), torch.zeros(n, dtype=torch.int32, device=dev))
    isect = compact_intersector(lambda o, d, a: ready, group)
    fused = compact_bounce(lambda o, d, t, r, a, p, k, b, position: (o, d, t, r, a),
                           group)
    return {"intersector_ms": cuda_ms(lambda: isect(origin, direction, alive), reps),
            "bounce_ms": cuda_ms(lambda: fused(origin, direction, throughput, radiance,
                                               alive, pixel_idx, 0, 0), reps)}
