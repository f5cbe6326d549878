"""Host-side binned-SAH BVH builder (numpy), plus the native C++ builder.

A copy of tracy_tpu/accel/bvh_build.py (the JAX package cannot load without
jax) with a ctypes binding of native/bvh_builder.cpp, as tracy_tpu/accel/
native.py binds it. Top-down binned SAH (64 bins, all 3 axes), fixed element
ranges (every triangle lands in exactly one leaf), max-depth bounded,
flattened to arrays:

  node_bounds [Nn, 6]  (min xyz, max xyz) float32
  node_meta   [Nn, 3]  int32: leaf  -> (first_slot, count,  -1)
                               inner -> (left_child, 0, right_child)
  tri_order   [T]      permutation: slot -> original triangle id
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np

from tracy_tpu_torch.utils.log import warn
from tracy_tpu_torch.utils.native import get_native_lib

NUM_BINS = 64
TRAVERSAL_COST = 1.0
INTERSECT_COST = 2.0


@dataclasses.dataclass
class HostBVH:
    node_bounds: np.ndarray  # [Nn, 6] float32
    node_meta: np.ndarray  # [Nn, 3] int32
    tri_order: np.ndarray  # [T] int32
    max_depth: int  # deepest node depth actually produced (root = 0)

    @property
    def num_nodes(self) -> int:
        return len(self.node_meta)


def build_bvh(
    tri_min: np.ndarray,  # [T, 3]
    tri_max: np.ndarray,  # [T, 3]
    leaf_size: int = 8,
    max_depth: int = 60,
) -> HostBVH:
    t_count = len(tri_min)
    assert t_count > 0
    centroids = 0.5 * (tri_min + tri_max)
    order = np.arange(t_count, dtype=np.int64)

    nb: list = []  # bounds rows
    nm: list = []  # meta rows
    deepest = 0

    # Stack of (node_id, start, end, depth); node rows appended before children
    # are known, then patched.
    nb.append(np.zeros(6, np.float32))
    nm.append(np.zeros(3, np.int32))
    stack = [(0, 0, t_count, 0)]

    while stack:
        node_id, start, end, depth = stack.pop()
        deepest = max(deepest, depth)
        idx = order[start:end]
        bmin = tri_min[idx].min(axis=0)
        bmax = tri_max[idx].max(axis=0)
        nb[node_id] = np.concatenate([bmin, bmax]).astype(np.float32)

        count = end - start
        if count <= leaf_size or depth >= max_depth:
            nm[node_id] = np.array([start, count, -1], np.int32)
            continue

        split = _find_split(centroids[idx], tri_min[idx], tri_max[idx],
                            count)
        if split is None:
            # Degenerate centroid spread: median split on largest axis.
            axis = int(np.argmax(bmax - bmin))
            key = np.argsort(centroids[idx, axis], kind="stable")
            mid = count // 2
            order[start:end] = idx[key]
        else:
            axis, go_left = split
            order[start:end] = np.concatenate([idx[go_left], idx[~go_left]])
            mid = int(go_left.sum())
            if mid == 0 or mid == count:
                key = np.argsort(centroids[idx, axis], kind="stable")
                order[start:end] = idx[key]
                mid = count // 2

        left_id = len(nb)
        nb.append(np.zeros(6, np.float32))
        nm.append(np.zeros(3, np.int32))
        right_id = len(nb)
        nb.append(np.zeros(6, np.float32))
        nm.append(np.zeros(3, np.int32))
        nm[node_id] = np.array([left_id, 0, right_id], np.int32)
        # Push right first so the left child is processed next (DFS order).
        stack.append((right_id, start + mid, end, depth + 1))
        stack.append((left_id, start, start + mid, depth + 1))

    return HostBVH(
        node_bounds=np.stack(nb),
        node_meta=np.stack(nm),
        tri_order=order.astype(np.int32),
        max_depth=deepest,
    )


def _surface_area(bmin, bmax):
    d = np.maximum(bmax - bmin, 0.0)
    return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]


def _find_split(cent, tmin, tmax, count):
    """Binned SAH over all 3 axes; returns (axis, go_left mask) or None."""
    cmin = cent.min(axis=0)
    cmax = cent.max(axis=0)
    extent = cmax - cmin
    best = None

    best_cost = INTERSECT_COST * count  # making this a leaf

    for axis in range(3):
        if extent[axis] <= 1e-12:
            continue
        scale = NUM_BINS * (1.0 - 1e-6) / extent[axis]
        bin_id = ((cent[:, axis] - cmin[axis]) * scale).astype(np.int64)
        np.clip(bin_id, 0, NUM_BINS - 1, out=bin_id)

        counts = np.bincount(bin_id, minlength=NUM_BINS)
        binned_min = np.full((NUM_BINS, 3), np.inf)
        binned_max = np.full((NUM_BINS, 3), -np.inf)
        for c in range(3):
            np.minimum.at(binned_min[:, c], bin_id, tmin[:, c])
            np.maximum.at(binned_max[:, c], bin_id, tmax[:, c])

        # Prefix/suffix sweep.
        lmin = np.minimum.accumulate(binned_min, axis=0)
        lmax = np.maximum.accumulate(binned_max, axis=0)
        rmin = np.minimum.accumulate(binned_min[::-1], axis=0)[::-1]
        rmax = np.maximum.accumulate(binned_max[::-1], axis=0)[::-1]
        lcount = np.cumsum(counts)
        rcount = count - lcount

        # Split after bin b (b in 0..NUM_BINS-2).
        la = _surface_area(lmin[:-1], lmax[:-1])
        ra = _surface_area(rmin[1:], rmax[1:])
        valid = (lcount[:-1] > 0) & (rcount[:-1] > 0)
        parent_area = max(_surface_area(tmin.min(axis=0), tmax.max(axis=0)), 1e-30)
        cost = TRAVERSAL_COST + INTERSECT_COST * (
            la * lcount[:-1] + ra * rcount[:-1]
        ) / parent_area
        cost = np.where(valid, cost, np.inf)
        b = int(np.argmin(cost))
        if cost[b] < best_cost:
            best_cost = cost[b]
            best = (axis, bin_id <= b)

    return best


def build_bvh_native(tri_min: np.ndarray, tri_max: np.ndarray, leaf_size: int = 8,
                     max_depth: int = 60) -> HostBVH:
    """The same build by native/bvh_builder.cpp (bit-identical to build_bvh)."""
    lib = get_native_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    t = len(tri_min)
    tri_min = np.ascontiguousarray(tri_min, dtype=np.float32)
    tri_max = np.ascontiguousarray(tri_max, dtype=np.float32)
    node_bounds = np.empty((2 * t + 2, 6), dtype=np.float32)
    node_meta = np.empty((2 * t + 2, 3), dtype=np.int32)
    tri_order = np.empty((t,), dtype=np.int32)
    out_depth = np.zeros((1,), dtype=np.int32)
    n = lib.tracy_build_bvh(
        tri_min.ctypes.data_as(ctypes.c_void_p),
        tri_max.ctypes.data_as(ctypes.c_void_p),
        t, leaf_size, max_depth, 0,  # cost mode 0: per-triangle SAH
        node_bounds.ctypes.data_as(ctypes.c_void_p),
        node_meta.ctypes.data_as(ctypes.c_void_p),
        tri_order.ctypes.data_as(ctypes.c_void_p),
        out_depth.ctypes.data_as(ctypes.c_void_p),
    )
    if n < 0:
        raise RuntimeError("tracy_build_bvh failed")
    return HostBVH(node_bounds=node_bounds[:n].copy(), node_meta=node_meta[:n].copy(),
                   tri_order=tri_order, max_depth=int(out_depth[0]))


def build_bvh_auto(tri_min, tri_max, leaf_size: int = 8, max_depth: int = 60) -> HostBVH:
    """The native builder when its library loads, else the numpy builder;
    both give the same tree (tracy_tpu/accel/bvh.py::_build_auto)."""
    if get_native_lib() is not None:
        return build_bvh_native(tri_min, tri_max, leaf_size, max_depth)
    warn("native BVH builder unavailable; using the numpy builder")
    return build_bvh(tri_min, tri_max, leaf_size, max_depth)
