"""Each kernel against its plain PyTorch version on the same device, with
the agreement contract of the card, plus CUDA-event timing.

Used by chip_smoke.py and the `cuda`-marked tests. On the card both sides
run the same IEEE float32 operations in the same order (the kernels are
built without FMA contraction or fast math), so the contracts are tight:

* K1: hit masks agree on >= 99.99% of rays; on rays both sides hit,
  |dt| <= 1e-5 * t + 1e-6.
* K2: lanes whose alive flag or lobe differ <= 0.01%; every float of every
  other lane within rtol 1e-5, atol 1e-6.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from tracy_tpu_torch.ops import intersect as k1
from tracy_tpu_torch.ops import shade as k2
from tracy_tpu_torch.render.material import RAY_OFFSET


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
    """K1 vs intersect_plain on CUDA tensors; raises on a broken contract."""
    got = k1.intersect(origin, direction, active, tables)
    ref = k1.intersect_plain(origin, direction, active, tables)
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
    if agree < 0.9999 or excess > 0.0 or not res["material_equal"]:
        raise RuntimeError(f"K1 disagrees with its plain version: {res}")
    return res


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
                  russian_roulette: bool, decision_frac: float = 1e-4) -> Dict[str, float]:
    """K2 vs shade_plain on CUDA tensors; raises on a broken contract."""
    args = [lanes[k] for k in SHADE_ARGS]
    kw = dict(seed=seed, russian_roulette=russian_roulette)
    got = k2.shade(*args, mtab, sample_key, bounce, **kw)
    ref = k2.shade_plain(*args, mtab, sample_key, bounce, **kw)
    flipped = decisions_flipped(got, ref)
    keep = ~flipped
    err, bad = 0.0, False
    for g, r in zip(got[:4], ref[:4]):
        g, r = g[keep], r[keep]
        err = max(err, float((g - r).abs().max()))
        bad |= bool(((g - r).abs() > 1e-6 + 1e-5 * r.abs()).any())
    res = {"lanes": args[0].shape[0], "flipped": float(flipped.float().mean()),
           "max_abs_err": err}
    if res["flipped"] > decision_frac or bad:
        raise RuntimeError(f"K2 disagrees with its plain version: {res}")
    return res
