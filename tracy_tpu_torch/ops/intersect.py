"""K1: closest-hit intersection over the BVH tables of accel/tables.py.

`intersect` is the wrapper the renderer calls. On CUDA tensors it launches
the hand-written kernel csrc/intersect.cu; on CPU tensors, and only there,
it runs `intersect_plain`, the same traversal as vectorised PyTorch over the
same tables, at the same width (the binary tree, or the 4- or 8-wide one in
the kernel's visiting order). The kernel replaces
tracy_tpu/ops/pallas_packet.py::_kernel (entered through pallas_intersect).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from tracy_tpu_torch.accel.tables import WIDTHS, BVHTables
from tracy_tpu_torch.core import math as tm
from tracy_tpu_torch.ops.build import LIBRARY
from tracy_tpu_torch.ops.launch import LaunchCount, check, raise_on_error
from tracy_tpu_torch.render.intersect import FLT_MAX, Hit

COUNT = LaunchCount()
# The sorting networks that order a wide node's children (csrc/traverse.cuh
# sort_children<W>): 5 comparators for 4 keys, the optimal 19 for 8.
NETWORKS = {
    4: ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)),
    8: ((0, 2), (1, 3), (4, 6), (5, 7), (0, 4), (1, 5), (2, 6), (3, 7), (0, 1), (2, 3),
        (4, 5), (6, 7), (2, 4), (3, 5), (1, 4), (3, 6), (1, 2), (3, 4), (5, 6)),
}


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
    contiguous, on `dev`, 16-byte aligned where read as vectors, the wide
    rows 128-byte aligned, and no deeper than the kernel's stack (a deeper
    tree is refused, never cut)."""
    if tables.width not in WIDTHS:
        raise ValueError(f"BVH width {tables.width}: the kernels walk widths {WIDTHS}")
    if tables.stack_size > tables.stack_max:
        raise ValueError(f"BVH needs a {tables.stack_size}-entry stack at width "
                         f"{tables.width}; the kernel holds {tables.stack_max}")
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
    w = tables.width
    if w > 2:
        if tables.wide is None:
            raise ValueError(f"width {w} needs the wide node rows (tables.wide)")
        check("wide", tables.wide, torch.float32, (tables.wide.shape[0], 8 * w), dev)
        if tables.wide.data_ptr() % 128:
            raise ValueError(f"wide: the kernel reads {w // 4} 128-byte line(s) a node; "
                             "it must be 128-byte aligned")


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
        tb.node_bounds.data_ptr(), tb.node_meta.data_ptr(), ptr(tb.wide), tb.width,
        tb.tri.data_ptr(),
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


def _warp_steps(rays, work, num_warps: int):
    """Sum over the warps holding one of `rays` of the most `work` a ray of
    that warp has (warps of 32 consecutive rays)."""
    most = torch.zeros((num_warps,), dtype=torch.int64, device=rays.device)
    most.scatter_reduce_(0, rays // 32, work, "amax")
    return most.sum()


def _test_leaves(origin, direction, tri, rays, first, count, rec):
    """Each ray of `rays` tests slots first .. first+count-1 in order,
    keeping a nearer hit in rec = (best_t, best, bu, bv)."""
    best_t, best, bu, bv = rec
    for j in range(int(count.max()) if rays.numel() else 0):
        sel = j < count
        r, s = rays[sel], first[sel] + j
        ok, t, u, v = moller_trumbore(origin[r], direction[r], tri[s], best_t[r])
        r, s = r[ok], s[ok]
        best_t[r], best[r], bu[r], bv[r] = t[ok], s, u[ok], v[ok]


def _walk_binary(origin, direction, inv_d, active, tables: BVHTables, rec):
    """csrc/traverse.cuh::traverse: the binary tree, nearer child first."""
    n = origin.shape[0]
    dev = origin.device
    nb, nm = tables.node_bounds, tables.node_meta.long()
    best_t = rec[0]
    stack = torch.zeros((n, tables.stack_size), dtype=torch.long, device=dev)
    sp = torch.zeros((n,), dtype=torch.long, device=dev)
    node = torch.zeros((n,), dtype=torch.long, device=dev)
    live = torch.nonzero(active).flatten()
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    n_inner, n_tris, w_node, w_tri = zero.clone(), zero.clone(), zero.clone(), zero.clone()
    num_warps = -(-n // 32)
    while live.numel():
        m = nm[node[live]]
        is_leaf = m[:, 1] > 0
        pop = is_leaf.clone()
        n_inner += (~is_leaf).sum()
        n_tris += m[is_leaf, 1].sum()
        w_node += _warp_steps(live[~is_leaf], torch.ones_like(live[~is_leaf]), num_warps)
        w_tri += _warp_steps(live[is_leaf], m[is_leaf, 1], num_warps)
        _test_leaves(origin, direction, tables.tri, live[is_leaf], m[is_leaf, 0],
                     m[is_leaf, 1], rec)

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
    return {"inner": n_inner, "tri_tests": n_tris, "warp_node_steps": w_node,
            "warp_tri_steps": w_tri}


def _sort(t, k, ref, cnt):
    """csrc/traverse.cuh's sorting network over a wide node's W children: by
    entry distance, ties by child slot. Each argument is a list of W [L]
    tensors; sorts them in place."""
    for i, j in NETWORKS[len(t)]:
        swap = (t[j] < t[i]) | ((t[j] == t[i]) & (k[j] < k[i]))
        for a in (t, k, ref, cnt):
            a[i], a[j] = torch.where(swap, a[j], a[i]), torch.where(swap, a[i], a[j])


def _walk_wide(origin, direction, inv_d, active, tables: BVHTables, rec):
    """csrc/traverse.cuh::traverse_wide: the W-wide tree (W = 4 or 8), one
    row a node; descend into the nearest hit child, push the other hit
    children far-to-near with their entry distance, skip a popped entry
    that is no nearer than the best hit (culling on pop)."""
    n = origin.shape[0]
    dev = origin.device
    w = tables.width
    wide = tables.wide
    bits = wide.view(torch.int32)
    best_t = rec[0]
    size = tables.stack_size
    st_ref = torch.zeros((n, size), dtype=torch.long, device=dev)
    st_cnt = torch.zeros((n, size), dtype=torch.long, device=dev)
    st_t = torch.zeros((n, size), dtype=torch.float32, device=dev)
    sp = torch.zeros((n,), dtype=torch.long, device=dev)
    ref = torch.zeros((n,), dtype=torch.long, device=dev)  # the root
    cnt = torch.zeros((n,), dtype=torch.long, device=dev)
    live = torch.nonzero(active).flatten()
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    n_wide, n_box, n_tris, n_culled = zero.clone(), zero.clone(), zero.clone(), zero.clone()
    w_node, w_tri = zero.clone(), zero.clone()
    num_warps = -(-n // 32)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    while live.numel():
        c = cnt[live]
        is_leaf = c > 0
        pop = is_leaf.clone()
        rays = live[is_leaf]
        n_tris += c[is_leaf].sum()
        w_node += _warp_steps(live[~is_leaf], torch.ones_like(live[~is_leaf]), num_warps)
        w_tri += _warp_steps(rays, c[is_leaf], num_warps)
        _test_leaves(origin, direction, tables.tri, rays, ~ref[rays], c[is_leaf], rec)

        r = live[~is_leaf]
        rows = ref[r]
        line, lbits = wide[rows], bits[rows]
        o, inv, bt = origin[r], inv_d[r], best_t[r][:, None]
        ax = [((line[:, 2 * a * w:(2 * a + 1) * w] - o[:, a:a + 1]) * inv[:, a:a + 1],
               (line[:, (2 * a + 1) * w:(2 * a + 2) * w] - o[:, a:a + 1]) * inv[:, a:a + 1])
              for a in range(3)]
        mins = [torch.minimum(t0, t1) for t0, t1 in ax]
        maxs = [torch.maximum(t0, t1) for t0, t1 in ax]
        tmin = torch.maximum(torch.maximum(mins[0], mins[1]), mins[2])
        tmax = torch.minimum(torch.minimum(maxs[0], maxs[1]), maxs[2])
        child_cnt = lbits[:, 7 * w:8 * w].long()
        hit = (tmax >= torch.clamp(tmin, min=tm.EPS)) & (tmin < bt) & (child_cnt >= 0)
        n_wide += r.numel()
        n_box += (child_cnt >= 0).sum()
        t = list(torch.where(hit, tmin, inf).unbind(1))
        k = list(torch.arange(w, device=dev).expand(r.numel(), w).unbind(1))
        cr = list(lbits[:, 6 * w:7 * w].long().unbind(1))
        cc = list(child_cnt.unbind(1))
        _sort(t, k, cr, cc)
        for j in range(w - 1, 0, -1):  # far-to-near, so the nearest pops first
            q = t[j] != inf
            rq = r[q]
            pos = sp[rq]
            st_ref[rq, pos], st_cnt[rq, pos], st_t[rq, pos] = cr[j][q], cc[j][q], t[j][q]
            sp[rq] += 1
        go = t[0] != inf
        ref[r[go]], cnt[r[go]] = cr[0][go], cc[0][go]
        pop[~is_leaf] = ~go

        # Pop until an entry nearer than the best hit, or finish on an
        # empty stack.
        pending = live[pop]
        done = []
        while pending.numel():
            has = sp[pending] > 0
            done.append(pending[~has])
            p = pending[has]
            sp[p] -= 1
            near = st_t[p, sp[p]] < best_t[p]
            q = p[near]
            ref[q], cnt[q] = st_ref[q, sp[q]], st_cnt[q, sp[q]]
            n_culled += (~near).sum()
            pending = p[~near]
        if done:
            fin = torch.zeros((n,), dtype=torch.bool, device=dev)
            fin[torch.cat(done)] = True
            live = live[~fin[live]]
    return {"wide_inner": n_wide, "box_tests": n_box, "tri_tests": n_tris,
            "culled_pops": n_culled, "warp_node_steps": w_node, "warp_tri_steps": w_tri}


def intersect_plain(origin, direction, active, tables: BVHTables,
                    counts: Optional[Dict[str, torch.Tensor]] = None) -> SurfaceHit:
    """The kernel's traversal as vectorised PyTorch: every live ray holds a
    current node and a stack; each step handles one node per ray, in the
    kernel's order, until no ray has work left.

    counts: if given, receives the work these rays needed, as 0-d tensors:
    "tri_tests", and at width 2 "inner" node visits (two box tests each),
    at widths 4 and 8 "wide_inner" node visits, "box_tests" (their
    non-empty children) and "culled_pops" (stack entries skipped on pop). Also the
    kernel's work as warps of 32 consecutive rays issue it, one step of
    this loop being one iteration of the kernel's: "warp_node_steps", the
    warp-iterations with a ray at an inner node, and "warp_tri_steps", the
    triangle-test iterations of warps with a ray at a leaf (each the most
    triangles a ray of the warp tests there). Node visits over 32 x
    warp_node_steps is the share of lanes doing useful box work, as tri_tests
    over 32 x warp_tri_steps is of triangle work."""
    n = origin.shape[0]
    dev = origin.device
    safe = torch.where(direction.abs() < 1e-12,
                       torch.copysign(torch.full_like(direction, 1e-12), direction),
                       direction)
    inv_d = 1.0 / safe
    best_t = torch.full((n,), FLT_MAX, dtype=torch.float32, device=dev)
    best = torch.full((n,), -1, dtype=torch.long, device=dev)
    bu = torch.zeros((n,), dtype=torch.float32, device=dev)
    bv = torch.zeros((n,), dtype=torch.float32, device=dev)
    rec = (best_t, best, bu, bv)
    walk = _walk_wide if tables.width > 2 else _walk_binary
    work = walk(origin, direction, inv_d, active, tables, rec)
    if counts is not None:
        for key, val in work.items():
            counts[key] = counts.get(key, 0) + val
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
