"""K6: a microbenchmark of K1's leaf visit in isolation, on the card.

    python -m tracy_tpu_torch.tools.micro [--iters 2000] [--variants v0,vd,...]

The Hopper counterpart of tools/tpu_micro.py. Each of enough rays to fill
an H100 (132 SMs x 2048 threads = 270,336) does `iters` visits of leaf
(iteration % 31), drawn from 31 random 8-triangle leaves in K1's tri /
tri_meta layout, made from a seed with numpy. The variants (csrc/micro.cu)
add one building block each: v0 the empty loop, vd the triangle loads, vmt
K1's Möller–Trumbore, vacc the winner's (t, slot, u, v), vred a warp vote
on improvement feeding a per-warp counter, vres vacc plus resolving the
winner's material and normal.

The kernel's test contracts each product-sum into fmaf; `micro_plain`
rounds each of them as the card does (core/math.py::fma).

Each variant is checked against `micro_plain`, its PyTorch version, and
timed with CUDA events; the module prints nanoseconds per iteration (all
rays together) and per ray-visit, and each kernel's registers and spills
from nvcc's -Xptxas -v. `micro` is the wrapper: on CUDA tensors it
launches the kernel, on CPU tensors, and only there, it runs
`micro_plain`.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tracy_tpu_torch.core.math import EPS, fma
from tracy_tpu_torch.ops.build import LIBRARY
from tracy_tpu_torch.ops.compare import OPS_TRI_TEST, bound_ms, nbytes
from tracy_tpu_torch.ops.launch import LaunchCount, check, raise_on_error
from tracy_tpu_torch.render.intersect import FLT_MAX
from tracy_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

COUNT = LaunchCount()
VARIANTS = ("v0", "vd", "vmt", "vacc", "vred", "vres")
NUM_LEAVES = 31
LEAF_SIZE = 8
ITERS = 2000
RAYS = 132 * 2048  # an H100's SMs x resident threads per SM
WARP = 32
SEED = 0xABCDEF


class Leaves(NamedTuple):
    """NUM_LEAVES leaves of LEAF_SIZE triangles, leaf k in slots
    [k * LEAF_SIZE, (k + 1) * LEAF_SIZE), in accel/tables.py's layout."""

    tri: torch.Tensor  # [T, 12] f32: p0 xyz 0, e1 xyz 0, e2 xyz 0
    tri_meta: torch.Tensor  # [T, 4] i32: vertex ids v0 v1 v2, material
    vertex_normal: torch.Tensor  # [3T, 3] f32: each triangle its own vertices

    @property
    def vertices(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(p0, p1, p2) [T, 3] float32, for an oracle."""
        t = self.tri.cpu().numpy()
        return t[:, 0:3], t[:, 0:3] + t[:, 4:7], t[:, 0:3] + t[:, 8:11]


def make_leaves(seed: int = SEED, device=DEFAULT_DEVICE, num_leaves: int = NUM_LEAVES,
                leaf_size: int = LEAF_SIZE) -> Leaves:
    """Well-shaped random triangles in the box [-1, 1]^3, as a mesh has
    them: vertices about 120 degrees apart on a circle of radius 0.2-0.4 in
    a random plane; unit vertex normals near the face normal (smooth
    shading); materials 1-3."""
    rng = np.random.default_rng(seed)
    t = num_leaves * leaf_size

    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    center = rng.uniform(-1.0, 1.0, (t, 1, 3))
    a1 = unit(rng.standard_normal((t, 3)))
    a2 = unit(np.cross(a1, rng.standard_normal((t, 3))))
    ang = rng.uniform(0.0, 2 * np.pi, (t, 1)) + np.array([0.0, 2.0, 4.0]) * np.pi / 3
    ang += rng.uniform(-0.3, 0.3, (t, 3))
    rad = rng.uniform(0.2, 0.4, (t, 3, 1))
    p = (center + rad * (np.cos(ang)[..., None] * a1[:, None] + np.sin(ang)[..., None]
                         * a2[:, None])).astype(np.float32)
    e1, e2 = p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    tri = np.zeros((t, 12), np.float32)
    tri[:, 0:3], tri[:, 4:7], tri[:, 8:11] = p[:, 0], e1, e2
    meta = np.zeros((t, 4), np.int32)
    meta[:, 0:3] = np.arange(3 * t, dtype=np.int32).reshape(t, 3)
    meta[:, 3] = rng.integers(1, 4, t)
    face = unit(np.cross(e1, e2).astype(np.float64))
    nrm = unit(np.repeat(face, 3, axis=0) + 0.3 * rng.standard_normal((3 * t, 3)))
    nrm = nrm.astype(np.float32)
    dev = resolve_device(device)
    return Leaves(*(torch.as_tensor(x, device=dev) for x in (tri, meta, nrm)))


def make_rays(n: int = RAYS, seed: int = SEED, device=DEFAULT_DEVICE) -> torch.Tensor:
    """[n, 6] float32 (origin, unit direction): from a sphere of radius 4
    towards random points of the box [-1, 1]^3."""
    rng = np.random.default_rng(seed + 1)
    o = rng.standard_normal((n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-1.0, 1.0, (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.as_tensor(np.concatenate([o, d], axis=1).astype(np.float32),
                           device=resolve_device(device))


def micro(variant: str, rays, leaves: Leaves, iters: int = ITERS):
    """Run one variant: returns (out [n, 8] f32: t (v0/vd: the accumulator),
    slot, u, v, normal xyz, material; warp_count [n / 32] i32, vred only)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; pick one of {VARIANTS}")
    if rays.device.type == "cpu":
        COUNT.plain += 1
        return micro_plain(variant, rays, leaves, iters)
    n = rays.shape[0]
    dev = rays.device
    t = leaves.tri.shape[0]
    check("rays", rays, torch.float32, (n, 6), dev)
    check("tri", leaves.tri, torch.float32, (t, 12), dev)
    check("tri_meta", leaves.tri_meta, torch.int32, (t, 4), dev)
    nv = leaves.vertex_normal.shape[0]
    check("vertex_normal", leaves.vertex_normal, torch.float32, (nv, 3), dev)
    if n % WARP or t % LEAF_SIZE:
        raise ValueError(f"{n} rays: a multiple of {WARP} (whole warps vote); "
                         f"{t} triangles: whole leaves of {LEAF_SIZE}")
    out = torch.zeros((n, 8), dtype=torch.float32, device=dev)
    count = torch.zeros((n // WARP,), dtype=torch.int32, device=dev)
    code = LIBRARY.get().tracy_micro(
        VARIANTS.index(variant), rays.data_ptr(), n, leaves.tri.data_ptr(),
        leaves.tri_meta.data_ptr(), leaves.vertex_normal.data_ptr(), t // LEAF_SIZE,
        LEAF_SIZE, iters, out.data_ptr(), count.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error("micro", code)
    COUNT.kernel += 1
    return out, count


def _front(o, d, tri):
    """csrc/micro.cu::front of ray k against slot k (tri rows of 12), each
    fmaf rounded once (`fma`): (det, u, v, q)."""
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = (tri[:, k] for k in (0, 1, 2, 4, 5, 6, 8, 9, 10))
    px = fma(dy, e2z, -(dz * e2y))
    py = fma(dz, e2x, -(dx * e2z))
    pz = fma(dx, e2y, -(dy * e2x))
    det = fma(e1x, px, fma(e1y, py, e1z * pz))
    tx, ty, tz = ox - p0x, oy - p0y, oz - p0z
    u = fma(tx, px, fma(ty, py, tz * pz))
    qx = fma(ty, e1z, -(tz * e1y))
    qy = fma(tz, e1x, -(tx * e1z))
    qz = fma(tx, e1y, -(ty * e1x))
    v = fma(dx, qx, fma(dy, qy, dz * qz))
    return det, u, v, (qx, qy, qz)


def moller_trumbore_fma(o, d, tri, best_t):
    """csrc/micro.cu's test (front, then back) of ray k against slot k:
    ops/intersect.py::moller_trumbore with each product-sum fused as the
    kernel fuses it, every fmaf rounded once. Returns (valid, t, u, v)."""
    det, u, v, (qx, qy, qz) = _front(o, d, tri)
    inv_det = 1.0 / det
    t = fma(tri[:, 8], qx, fma(tri[:, 9], qy, tri[:, 10] * qz)) * inv_det
    valid = ((det > EPS) & (u >= EPS) & (u <= det) & (v >= EPS) & (u + v <= det)
             & (t > EPS) & (t < best_t))
    return valid, t, u * inv_det, v * inv_det


def micro_plain(variant: str, rays, leaves: Leaves, iters: int = ITERS):
    """The kernel's outputs in PyTorch. A strict-< winner cannot change when
    a leaf comes round again, so one pass over the leaves in visit order
    gives the winner; v0 repeats its add `iters` times, as the kernel does."""
    n = rays.shape[0]
    dev = rays.device
    num_leaves = leaves.tri.shape[0] // LEAF_SIZE
    o, d = rays[:, 0:3], rays[:, 3:6]
    out = torch.zeros((n, 8), dtype=torch.float32, device=dev)
    count = torch.zeros((n // WARP,), dtype=torch.int32, device=dev)
    if variant == "v0":
        acc = o[:, 0].clone()
        for _ in range(iters):
            acc = acc + 1.0e-7
        out[:, 0] = acc
        return out, count
    visits = min(iters, num_leaves)
    if variant == "vd":
        acc = o[:, 0].clone()
        tri = leaves.tri
        for s in range(visits * LEAF_SIZE):
            acc = torch.minimum(acc, tri[s, 0] + tri[s, 5] + tri[s, 10] + o[:, 0])
        out[:, 0] = acc
        return out, count
    best_t = torch.full((n,), FLT_MAX, dtype=torch.float32, device=dev)
    best = torch.full((n,), -1, dtype=torch.long, device=dev)
    bu = torch.zeros((n,), dtype=torch.float32, device=dev)
    bv = torch.zeros((n,), dtype=torch.float32, device=dev)
    improved = torch.zeros((n, visits), dtype=torch.bool, device=dev)
    for leaf in range(visits):
        for s in range(leaf * LEAF_SIZE, (leaf + 1) * LEAF_SIZE):
            ok, t, u, v = moller_trumbore_fma(o, d, leaves.tri[s].expand(n, 12), best_t)
            best_t = torch.where(ok, t, best_t)
            best = torch.where(ok, s, best)
            bu = torch.where(ok, u, bu)
            bv = torch.where(ok, v, bv)
            improved[:, leaf] |= ok
    out[:, 0] = best_t
    if variant == "vmt":
        return out, count
    out[:, 1] = best.float()
    out[:, 2], out[:, 3] = bu, bv
    if variant == "vred":
        count = improved.view(n // WARP, WARP, visits).any(dim=1).sum(dim=1).to(torch.int32)
    if variant == "vres":
        mask = best >= 0
        meta = leaves.tri_meta[best.clamp(min=0)].long()
        w = 1.0 - bu - bv
        attr = leaves.vertex_normal
        nrm = (w[:, None] * attr[meta[:, 0]] + bu[:, None] * attr[meta[:, 1]]
               + bv[:, None] * attr[meta[:, 2]])
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        out[:, 4:7] = torch.where(mask[:, None], nrm, zero)
        out[:, 7] = torch.where(mask, meta[:, 3].float(), zero)
    return out, count


def check_variant(variant: str, rays, leaves: Leaves, iters: int = ITERS) -> Dict[str, object]:
    """The kernel against micro_plain on the same CUDA tensors: outputs
    equal, and for vred the per-warp counters equal; raises otherwise."""
    got, gcount = micro(variant, rays, leaves, iters)
    ref, rcount = micro_plain(variant, rays, leaves, iters)
    res = {"variant": variant, "outputs_equal": bool(torch.equal(got, ref)),
           "max_abs_err": float((got - ref).abs().max()),
           "improving_warp_visits": int(gcount.sum()), "plain_count": int(rcount.sum()),
           "counts_equal": bool(torch.equal(gcount, rcount)),
           "hit_fraction": float((got[:, 1] >= 0).float().mean()) if variant in
           ("vacc", "vred", "vres") else None}
    if not (res["outputs_equal"] and res["counts_equal"]):
        raise RuntimeError(f"K6 {variant} disagrees with its plain version: {res}")
    return res


def kernel_resources(log: str) -> Dict[str, Dict[str, int]]:
    """Registers, stack frame and spill-store bytes of each instance of
    csrc/micro.cu's kernel in nvcc's -Xptxas -v output (ops/build.py's
    LIBRARY.build_log["micro.cu"]), by variant."""
    out = {}
    for fn, stack, spill, regs in re.findall(
            r"Function properties for (\S*micro_kernel\S*)\s+(\d+) bytes stack frame, (\d+) "
            r"bytes spill stores.*?Used (\d+) registers", log, re.S):
        m = re.search(r"micro_kernelILi(\d+)EE", fn)
        if m:
            out[VARIANTS[int(m.group(1))]] = {
                "registers": int(regs), "stack": int(stack), "spill_stores": int(spill)}
    return out


def bound(rays, leaves: Leaves, iters: int = ITERS) -> Dict[str, object]:
    """vres' least time on an H100 (ops/compare.py::bound_ms): every visit
    tests LEAF_SIZE triangles, each at least OPS_TRI_TEST operations; the
    rays and the table read once, the outputs written once."""
    n = rays.shape[0]
    moved = nbytes(rays, *leaves) + n * 8 * 4
    return bound_ms(moved, float(n) * iters * LEAF_SIZE * OPS_TRI_TEST)


def time_variant(variant: str, rays, leaves: Leaves, iters: int = ITERS,
                 reps: int = 10) -> Dict[str, float]:
    """CUDA-event time of one launch (the mean of `reps` after a warm-up),
    and ns per iteration (all rays together) and per ray-visit."""
    fn = lambda: micro(variant, rays, leaves, iters)  # noqa: E731
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    return {"ms": ms, "ns_per_iter": ms * 1e6 / iters,
            "ns_per_ray_visit": ms * 1e6 / (iters * rays.shape[0])}


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(0)}, power limit not read"


def inside_share(rays, leaves: Leaves) -> float:
    """The share of warp-wide triangle tests in which some ray of the warp
    lies inside the triangle (u >= eps, v >= eps, u + v <= det, rounded as
    the kernel rounds them): how often a warp takes the test's branch."""
    n = rays.shape[0]
    o, d = rays[:, 0:3], rays[:, 3:6]
    taken = 0
    for s in range(leaves.tri.shape[0]):
        det, u, v, _ = _front(o, d, leaves.tri[s].expand(n, 12))
        inside = (u >= EPS) & (v >= EPS) & (u + v <= det)
        taken += int(inside.view(n // WARP, WARP).any(dim=1).sum())
    return taken / (n // WARP * leaves.tri.shape[0])


def sm_clock(fn, seconds: float = 2.0) -> Dict[str, float]:
    """The card's SM clock (MHz, nvidia-smi sampled every 50 ms) while fn()
    runs back to back for about `seconds`: the clock a time is to be read
    against, in issue slots."""
    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
                            "-lms", "50"], stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    mhz = [float(v) for v in out.split() if v.replace(".", "").isdigit()]
    mhz = mhz[len(mhz) // 4:] or [float("nan")]  # the samples after the clock settles
    return {"mhz_median": float(np.median(mhz)), "mhz_min": min(mhz), "mhz_max": max(mhz)}


def issue_slots(ms: float, mhz: float, rays: int, iters: int = ITERS) -> float:
    """Warp-instruction issue slots of an H100 (132 SMs x 4 schedulers, one
    a clock each) in `ms` at `mhz`, per warp-wide triangle test."""
    return ms * 1e-3 * mhz * 1e6 * 132 * 4 / (rays / WARP * iters * LEAF_SIZE)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--rays", type=int, default=RAYS)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("micro: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    leaves = make_leaves(device=dev)
    rays = make_rays(args.rays, device=dev)
    print(f"micro: {card()}; {args.rays} rays x {args.iters} visits of {NUM_LEAVES} leaves "
          f"of {LEAF_SIZE} triangles")
    for v in args.variants.split(","):
        c = check_variant(v, rays, leaves, args.iters)
        t = time_variant(v, rays, leaves, args.iters)
        print(f"  {v:5s} {t['ns_per_iter']:10.3f} ns/iter ({t['ns_per_ray_visit']:.6f} "
              f"ns per ray-visit, {t['ms']:.4f} ms a launch); equal to plain: "
              f"{c['outputs_equal'] and c['counts_equal']}")
    b = bound(rays, leaves, args.iters)
    print(f"  vres bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    clock = sm_clock(lambda: micro("vres", rays, leaves, args.iters))
    t = time_variant("vres", rays, leaves, args.iters)
    print(f"  vres {t['ms']:.4f} ms at SM clock {clock['mhz_median']:.0f} MHz (median of "
          f"nvidia-smi's samples, {clock['mhz_min']:.0f}-{clock['mhz_max']:.0f}) over 2 s: "
          f"{issue_slots(t['ms'], clock['mhz_median'], args.rays, args.iters):.1f} issue slots "
          f"per warp-wide triangle test; {inside_share(rays, leaves):.4f} of those tests have a "
          f"ray inside the triangle")
    for name, r in kernel_resources(LIBRARY.build_log.get("micro.cu", "")).items():
        print(f"  {name}: {r['registers']} registers, {r['stack']} B stack, "
              f"{r['spill_stores']} B spilled")
    return 0


if __name__ == "__main__":
    sys.exit(main())
