"""Two-level acceleration structure: one BLAS per object, a TLAS over them.

Port of tracy_tpu/accel/tlas.py. Each object's BLAS is built on its own
and kept; the TLAS over the objects' boxes (leaf size 1) and every BLAS are
stitched into one flat binary tree in the single-level build's layout
(accel/bvh_build.py::HostBVH), so the same kernel tables
(accel/tables.py::tables_from_host: binary, 4- or 8-wide) and K1 walk it
unchanged. What the two levels buy is on the host: moving or deforming one
object rebuilds only its BLAS and the small TLAS (`update_object`), and the
result equals a fresh `build_two_level` array for array.

The stitched tree is a valid single BVH: its renders equal the
single-level build's up to which of two equal-t triangles wins.

`_stitch`'s depth (max BLAS depth + TLAS depth + object count) is an upper
bound; tables_from_host sizes the traversal stack from the real depth, found
by walking the tree.
"""

from __future__ import annotations

import dataclasses
import functools
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from tracy_tpu_torch.accel.bvh_build import HostBVH, build_bvh_auto
from tracy_tpu_torch.accel.tables import tables_from_host
from tracy_tpu_torch.core import math as tm
from tracy_tpu_torch.ops.intersect import intersect


@dataclasses.dataclass
class TwoLevelBVH:
    """Host-side two-level structure and its stitched flat form."""

    blas: Dict[int, HostBVH]  # object id -> BLAS over its local triangle ids
    tri_ranges: Tuple[Tuple[int, int], ...]
    stitched: HostBVH  # flat tree in global triangle ids
    leaf_size: int
    max_depth: int
    rebuild_counts: Dict[int, int] = dataclasses.field(default_factory=dict)


def _host_arrays(scene):
    pos = scene.vertex_pos.detach().cpu().numpy().astype(np.float32)
    idx = scene.indices.cpu().numpy()
    return pos, idx


def _object_bounds(pos: np.ndarray, idx: np.ndarray,
                   rng: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    start, count = rng
    tri_idx = idx[start:start + count]
    v0, v1, v2 = pos[tri_idx[:, 0]], pos[tri_idx[:, 1]], pos[tri_idx[:, 2]]
    return (np.minimum(np.minimum(v0, v1), v2),
            np.maximum(np.maximum(v0, v1), v2))


def _build_blas(pos: np.ndarray, idx: np.ndarray, rng: Tuple[int, int],
                leaf_size: int, max_depth: int) -> HostBVH:
    tri_min, tri_max = _object_bounds(pos, idx, rng)
    return build_bvh_auto(tri_min.astype(np.float32), tri_max.astype(np.float32),
                          leaf_size, max_depth)


def _stitch(blas: Dict[int, HostBVH], tri_ranges: Tuple[Tuple[int, int], ...],
            max_depth: int = 40) -> HostBVH:
    """TLAS over the objects' boxes (leaf size 1), each BLAS root inlined
    at its TLAS leaf, everything re-indexed into one flat node array and
    one tri_order. A TLAS leaf that the depth cap left holding several
    objects becomes a left-deep chain of inner nodes over their roots."""
    n_obj = len(tri_ranges)
    obj_min = np.stack([blas[i].node_bounds[0, :3] for i in range(n_obj)])
    obj_max = np.stack([blas[i].node_bounds[0, 3:6] for i in range(n_obj)])

    if n_obj == 1:
        b = blas[0]
        return HostBVH(node_bounds=b.node_bounds.copy(), node_meta=b.node_meta.copy(),
                       tri_order=b.tri_order + tri_ranges[0][0], max_depth=b.max_depth)

    tlas = build_bvh_auto(obj_min, obj_max, 1, max_depth)

    nb_out: List[np.ndarray] = []
    nm_out: List[np.ndarray] = []
    tri_out: List[np.ndarray] = []
    slot_base = 0

    def emit(bounds_row, meta_row) -> int:
        nb_out.append(bounds_row)
        nm_out.append(meta_row)
        return len(nm_out) - 1

    def copy_blas(obj: int) -> int:
        """Append object `obj`'s BLAS; return its new root id."""
        nonlocal slot_base
        b = blas[obj]
        base = len(nm_out)
        nb_out.extend(b.node_bounds)
        for meta in b.node_meta:
            first, count, right = int(meta[0]), int(meta[1]), int(meta[2])
            if count > 0:  # leaf: slots shift by this BLAS's slot base
                nm_out.append(np.array([first + slot_base, count, -1], np.int32))
            else:  # inner: children shift by the node base
                nm_out.append(np.array([first + base, 0, right + base], np.int32))
        tri_out.append(b.tri_order + tri_ranges[obj][0])
        slot_base += len(b.tri_order)
        return base

    def copy_tlas(node: int) -> int:
        first, count, right = (int(x) for x in tlas.node_meta[node, :3])
        if count > 0:
            objs = [int(tlas.tri_order[first + k]) for k in range(count)]
            if len(objs) == 1:
                return copy_blas(objs[0])
            me = emit(tlas.node_bounds[node].copy(), np.array([0, 0, 0], np.int32))
            left = copy_blas(objs[0])
            rest = objs[1:]
            cur = me
            while len(rest) > 1:
                lo = np.min([nb_out[left][:3]] + [blas[o].node_bounds[0, :3] for o in rest],
                            axis=0)
                hi = np.max([nb_out[left][3:6]] + [blas[o].node_bounds[0, 3:6] for o in rest],
                            axis=0)
                nxt = emit(np.concatenate([lo, hi]), np.array([0, 0, 0], np.int32))
                nm_out[cur] = np.array([left, 0, nxt], np.int32)
                cur = nxt
                left = copy_blas(rest[0])
                rest = rest[1:]
            nm_out[cur] = np.array([left, 0, copy_blas(rest[0])], np.int32)
            return me
        me = emit(tlas.node_bounds[node].copy(), np.array([0, 0, 0], np.int32))
        li = copy_tlas(first)
        ri = copy_tlas(right)
        nm_out[me] = np.array([li, 0, ri], np.int32)
        return me

    # One frame per TLAS level (the TLAS is depth-capped at max_depth);
    # the limit is raised as tracy_tpu raises it, for callers with a deep cap.
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        root = copy_tlas(0)
    finally:
        sys.setrecursionlimit(old_limit)
    assert root == 0

    depth = max(b.max_depth for b in blas.values()) + int(tlas.max_depth) + n_obj
    return HostBVH(node_bounds=np.asarray(nb_out, np.float32),
                   node_meta=np.asarray(nm_out, np.int32),
                   tri_order=np.concatenate(tri_out), max_depth=depth)


def build_two_level(scene, leaf_size: int = 64, max_depth: int = 40) -> TwoLevelBVH:
    """One BLAS per object (scene.object_tri_ranges; the whole soup when
    the scene has none) and the TLAS, stitched into one flat HostBVH."""
    pos, idx = _host_arrays(scene)
    tri_ranges = tuple(scene.object_tri_ranges or ((0, len(idx)),))
    blas = {i: _build_blas(pos, idx, rng, leaf_size, max_depth)
            for i, rng in enumerate(tri_ranges)}
    return TwoLevelBVH(blas=blas, tri_ranges=tri_ranges,
                       stitched=_stitch(blas, tri_ranges, max_depth),
                       leaf_size=leaf_size, max_depth=max_depth,
                       rebuild_counts={i: 1 for i in blas})


def update_object(two: TwoLevelBVH, scene, obj: int) -> TwoLevelBVH:
    """Rebuild object `obj`'s BLAS (its vertices changed) and restitch.

    Every other BLAS is reused as it is; the result equals a fresh
    build_two_level of the updated scene array for array."""
    pos, idx = _host_arrays(scene)
    two.blas[obj] = _build_blas(pos, idx, two.tri_ranges[obj], two.leaf_size, two.max_depth)
    two.rebuild_counts[obj] = two.rebuild_counts.get(obj, 0) + 1
    two.stitched = _stitch(two.blas, two.tri_ranges, two.max_depth)
    return two


def transform_object(scene, obj: int, matrix):
    """A new SceneArrays, on the scene's device, with object `obj`'s
    vertices transformed by the 4x4 `matrix`.

    Positions go by M, normals by normalize((M^-1)^T n) (reference
    Mesh::Transform, mesh.h:115-125), tangents, which are surface
    directions, by M. The products are float32 mul-adds on the tensors;
    the norm's root is core/math.py::sqrt, correctly rounded on every
    device."""
    m = np.asarray(matrix, np.float32)
    nrm_m = np.linalg.inv(m).T
    vstart, vcount = scene.object_vert_ranges[obj]
    sl = slice(vstart, vstart + vcount)
    dev = scene.device

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def mul(v, mat3):  # v @ mat3.T, summed over the columns in order
        return v[:, 0:1] * mat3[:, 0] + v[:, 1:2] * mat3[:, 1] + v[:, 2:3] * mat3[:, 2]

    m3, t3, n3 = f32(m[:3, :3]), f32(m[:3, 3]), f32(nrm_m[:3, :3])
    pos = scene.vertex_pos.detach().clone()
    nrm = scene.vertex_normal.detach().clone()
    tan = scene.vertex_tangent.detach().clone()
    pos[sl] = mul(pos[sl], m3) + t3
    n = mul(nrm[sl], n3)
    norm = tm.sqrt(tm.dot(n, n))
    nrm[sl] = n / torch.clamp(norm, min=1e-20)
    tan[sl] = mul(tan[sl], m3)
    return dataclasses.replace(scene, vertex_pos=pos, vertex_normal=nrm, vertex_tangent=tan)


def make_two_level_intersector(scene, two: TwoLevelBVH, width: int = 4):
    """K1 over the stitched two-level tree (tracy_tpu's
    make_two_level_intersector): an intersector (origin, direction, active)
    -> SurfaceHit on tables_from_host(scene, two.stitched, width), with uv
    and tangent where the scene's textures need them, as on 'packet'."""
    return functools.partial(intersect, tables=tables_from_host(scene, two.stitched, width))
