"""K1: closest-hit intersection over the BVH tables of accel/tables.py.

`intersect` is the wrapper the renderer calls. On CUDA tensors it launches
the hand-written kernel csrc/intersect.cu; on CPU tensors, and only there,
it runs `intersect_plain`, the same traversal as vectorised PyTorch over the
same tables. The kernel replaces tracy_tpu/ops/pallas_packet.py::_kernel
(entered through pallas_intersect).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from tracy_tpu_torch.accel.tables import KERNEL_STACK_MAX, BVHTables
from tracy_tpu_torch.core import math as tm
from tracy_tpu_torch.ops.build import LIBRARY
from tracy_tpu_torch.ops.launch import LaunchCount, check, raise_on_error
from tracy_tpu_torch.render.intersect import FLT_MAX, Hit

COUNT = LaunchCount()


class SurfaceHit(NamedTuple):
    """A Hit plus the winner's attributes (zeros on a miss). `hit.uv` holds
    the barycentrics; tex_uv and tangent are None unless the tables carry
    them (accel/tables.py::attribute_flags)."""

    hit: Hit
    normal: torch.Tensor  # [N, 3] interpolated vertex normal, NOT normalized
    material: torch.Tensor  # [N] int32
    tex_uv: Optional[torch.Tensor] = None  # [N, 2] interpolated texture uv
    tangent: Optional[torch.Tensor] = None  # [N, 3] interpolated, NOT normalized


def check_tables(tables: BVHTables, dev: torch.device):
    """Raise unless the BVH tables are what the traversal (K1, K5) reads:
    contiguous, on `dev`, 16-byte aligned where read as vectors, and no
    deeper than the kernel's stack."""
    nn, nt = tables.node_meta.shape[0], tables.tri.shape[0]
    check("node_bounds", tables.node_bounds, torch.float32, (nn, 8), dev)
    check("node_meta", tables.node_meta, torch.int32, (nn, 4), dev)
    check("tri", tables.tri, torch.float32, (nt, 12), dev)
    check("tri_meta", tables.tri_meta, torch.int32, (nt, 4), dev)
    check("tri_id", tables.tri_id, torch.int32, (nt,), dev)
    nv = tables.vertex_normal.shape[0]
    check("vertex_normal", tables.vertex_normal, torch.float32, (nv, 3), dev)
    vuv, vtan = tables.vertex_uv, tables.vertex_tangent
    if vuv is not None:
        check("vertex_uv", vuv, torch.float32, (nv, 2), dev)
    if vtan is not None:
        if vuv is None:
            raise ValueError("vertex_tangent needs vertex_uv (tangents orient normal maps)")
        check("vertex_tangent", vtan, torch.float32, (nv, 3), dev)
    for name, x in (("node_bounds", tables.node_bounds), ("node_meta", tables.node_meta),
                    ("tri", tables.tri), ("tri_meta", tables.tri_meta)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads it in 16-byte vectors; "
                             "it must be 16-byte aligned")
    if tables.stack_size > KERNEL_STACK_MAX:
        raise ValueError(f"BVH needs a {tables.stack_size}-entry stack; the "
                         f"kernel holds {KERNEL_STACK_MAX}")


def intersect(origin, direction, active, tables: BVHTables) -> SurfaceHit:
    """Closest front-facing hit for each ray; inactive rays miss.

    origin/direction: [N, 3] float32; active: [N] bool. The texture uv
    and tangent come out when the tables carry their vertex attributes.
    """
    if origin.device.type == "cpu":
        COUNT.plain += 1
        return intersect_plain(origin, direction, active, tables)
    n = origin.shape[0]
    dev = origin.device
    check("origin", origin, torch.float32, (n, 3), dev)
    check("direction", direction, torch.float32, (n, 3), dev)
    check("active", active, torch.bool, (n,), dev)
    check_tables(tables, dev)
    if n >= 2**31 // 3:
        raise ValueError(f"{n} rays overflow the kernel's int32 indexing")
    vuv, vtan = tables.vertex_uv, tables.vertex_tangent

    t = torch.empty((n,), dtype=torch.float32, device=dev)
    uv = torch.empty((n, 2), dtype=torch.float32, device=dev)
    mask = torch.empty((n,), dtype=torch.bool, device=dev)
    normal = torch.empty((n, 3), dtype=torch.float32, device=dev)
    mat = torch.empty((n,), dtype=torch.int32, device=dev)
    tri = torch.empty((n,), dtype=torch.int32, device=dev)
    tex_uv = torch.empty((n, 2), dtype=torch.float32, device=dev) if vuv is not None else None
    tangent = torch.empty((n, 3), dtype=torch.float32, device=dev) if vtan is not None else None

    def ptr(x):
        return 0 if x is None else x.data_ptr()

    lib = LIBRARY.get()
    tb = tables
    code = lib.tracy_intersect(
        origin.data_ptr(), direction.data_ptr(), active.data_ptr(), n,
        tb.node_bounds.data_ptr(), tb.node_meta.data_ptr(), tb.tri.data_ptr(),
        tb.tri_meta.data_ptr(), tb.tri_id.data_ptr(), tb.vertex_normal.data_ptr(),
        ptr(vuv), ptr(vtan), t.data_ptr(), uv.data_ptr(), mask.data_ptr(),
        normal.data_ptr(), mat.data_ptr(), tri.data_ptr(), ptr(tex_uv), ptr(tangent),
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error("intersect", code)
    COUNT.kernel += 1
    return SurfaceHit(Hit(t=t, tri=tri, uv=uv, mask=mask), normal, mat, tex_uv, tangent)


def _slab(o, inv_d, bounds, best_t):
    """Reference RayAABB (collision.h:119-131) per ray: (hit, t_enter)."""
    lo = (bounds[:, 0:3] - o) * inv_d
    hi = (bounds[:, 4:7] - o) * inv_d
    tmin = torch.minimum(lo, hi).amax(dim=-1)
    tmax = torch.maximum(lo, hi).amin(dim=-1)
    return (tmax >= torch.clamp(tmin, min=tm.EPS)) & (tmin < best_t), tmin


def moller_trumbore(o, d, tri, best_t):
    """Möller–Trumbore of ray k against slot k (tri rows of 12), in the
    kernel's operation order. Returns (valid, t, u, v)."""
    p0, e1, e2 = tri[:, 0:3], tri[:, 4:7], tri[:, 8:11]
    pvec = tm.cross(d, e2)
    det = tm.dot(e1, pvec, keepdim=False)
    tvec = o - p0
    u = tm.dot(tvec, pvec, keepdim=False)
    qvec = tm.cross(tvec, e1)
    v = tm.dot(d, qvec, keepdim=False)
    inv_det = 1.0 / det
    t = tm.dot(e2, qvec, keepdim=False) * inv_det
    valid = ((det > tm.EPS) & (u >= tm.EPS) & (u <= det) & (v >= tm.EPS)
             & (u + v <= det) & (t > tm.EPS) & (t < best_t))
    return valid, t, u * inv_det, v * inv_det


def intersect_plain(origin, direction, active, tables: BVHTables,
                    counts: Optional[Dict[str, torch.Tensor]] = None) -> SurfaceHit:
    """The kernel's traversal as vectorised PyTorch: every live ray holds a
    current node and a stack row; each step handles one node per ray, in
    the kernel's order, until no ray has work left.

    counts: if given, receives the work these rays needed, as 0-d tensors:
    "inner" node visits (two box tests each) and "tri_tests"."""
    n = origin.shape[0]
    dev = origin.device
    nb, nm = tables.node_bounds, tables.node_meta.long()
    safe = torch.where(direction.abs() < 1e-12,
                       torch.copysign(torch.full_like(direction, 1e-12), direction),
                       direction)
    inv_d = 1.0 / safe

    best_t = torch.full((n,), FLT_MAX, dtype=torch.float32, device=dev)
    best = torch.full((n,), -1, dtype=torch.long, device=dev)
    bu = torch.zeros((n,), dtype=torch.float32, device=dev)
    bv = torch.zeros((n,), dtype=torch.float32, device=dev)
    stack = torch.zeros((n, tables.stack_size), dtype=torch.long, device=dev)
    sp = torch.zeros((n,), dtype=torch.long, device=dev)
    node = torch.zeros((n,), dtype=torch.long, device=dev)
    live = torch.nonzero(active).flatten()

    n_inner = torch.zeros((), dtype=torch.int64, device=dev)
    n_tris = torch.zeros((), dtype=torch.int64, device=dev)
    while live.numel():
        m = nm[node[live]]
        is_leaf = m[:, 1] > 0
        pop = is_leaf.clone()
        if counts is not None:
            n_inner += (~is_leaf).sum()
            n_tris += m[is_leaf, 1].sum()

        # Leaves: test slots first .. first+count-1 in order.
        rays, first, count = live[is_leaf], m[is_leaf, 0], m[is_leaf, 1]
        for j in range(int(count.max()) if rays.numel() else 0):
            sel = j < count
            r, s = rays[sel], first[sel] + j
            ok, t, u, v = moller_trumbore(origin[r], direction[r], tables.tri[s], best_t[r])
            r, s = r[ok], s[ok]
            best_t[r], best[r], bu[r], bv[r] = t[ok], s, u[ok], v[ok]

        # Inner nodes: descend into the nearer hit child, push the farther.
        inner = ~is_leaf
        r, left, right = live[inner], m[inner, 0], m[inner, 2]
        o, inv = origin[r], inv_d[r]
        hl, tl = _slab(o, inv, nb[left], best_t[r])
        hr, tr = _slab(o, inv, nb[right], best_t[r])
        both = hl & hr
        left_first = tl <= tr
        far = torch.where(left_first, right, left)
        rb = r[both]
        stack[rb, sp[rb]] = far[both]
        sp[rb] += 1
        node[r] = torch.where(both, torch.where(left_first, left, right),
                              torch.where(hl, left, right))
        pop[inner] = ~(hl | hr)

        # Rays with nothing to descend into pop, or finish on an empty stack.
        r = live[pop]
        has = sp[r] > 0
        r = r[has]
        sp[r] -= 1
        node[r] = stack[r, sp[r]]
        done = torch.zeros_like(pop)
        done[pop] = ~has
        live = live[~done]

    if counts is not None:
        counts["inner"] = counts.get("inner", 0) + n_inner
        counts["tri_tests"] = counts.get("tri_tests", 0) + n_tris
    mask = best >= 0
    slot = best.clamp(min=0)
    meta = tables.tri_meta[slot].long()
    w = 1.0 - bu - bv

    def interp(attr):  # w a0 + u a1 + v a2 (integrator.py:63-72); 0 on a miss
        if attr is None:
            return None
        val = (w[:, None] * attr[meta[:, 0]] + bu[:, None] * attr[meta[:, 1]]
               + bv[:, None] * attr[meta[:, 2]])
        return torch.where(mask[:, None], val, torch.zeros_like(val))

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return SurfaceHit(
        Hit(t=best_t, tri=torch.where(mask, tables.tri_id[slot], zero),
            uv=torch.stack([bu, bv], dim=-1), mask=mask),
        interp(tables.vertex_normal),
        torch.where(mask, meta[:, 3].to(torch.int32), zero),
        interp(tables.vertex_uv), interp(tables.vertex_tangent))
