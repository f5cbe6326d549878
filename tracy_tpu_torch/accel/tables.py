"""BVH tables for the intersect kernel (ops/intersect.py).

The port's counterpart of tracy_tpu/accel/packet.py::pack_bvh and
ops/pallas_packet.py::build_tables. The TPU tables realign leaves into
128-slot chunks and pack Woop rows for one DMA per leaf visit; a GPU thread
traverses its own ray and gathers freely, so the port keeps the builder's
binary tree as it is, and at width 4 or 8 (RenderConfig.pallas_bvh_width,
as tracy_tpu's) adds a wide tree collapsed from it:

  node_bounds [Nn, 8] f32   (min xyz, 0, max xyz, 0): two float4 loads
  node_meta   [Nn, 4] i32   leaf: (first_slot, count, -1, 0)
                            inner: (left, 0, right, 0)
  tri         [T, 12] f32   per slot: p0 xyz 0, e1 xyz 0, e2 xyz 0
  tri_meta    [T, 4] i32    per slot: vertex ids v0 v1 v2, material
  tri_id      [T] i32       slot -> original triangle id
  vertex_normal [V, 3] f32  for the winner's interpolated normal
  vertex_uv     [V, 2] f32  texture uv, or None: only when some non-sky
                            material is textured (pallas_packet.py:448)
  vertex_tangent [V, 3] f32 tangent, or None: only with uv and a normal map
  wide [NW, 8W] f32         width 4 or 8: one node per row, W children,
                            read by the kernel as 2W float4s (width 4: one
                            128-byte line, 8 float4s; width 8: two
                            lines, 16 float4s):
                              0-6W-1  child boxes by axis: lo.x[W] hi.x[W]
                                      lo.y[W] hi.y[W] lo.z[W] hi.z[W]
                              6W-7W-1 child references (int bits): an
                                      inner child's wide row, or
                                      ~first_slot of a leaf child
                              7W-8W-1 child triangle counts (int bits):
                                      > 0 leaf, 0 inner, -1 empty slot
                                      (its box is never-hit, lo = +BIG,
                                      hi = -BIG, but the min/max slab test
                                      hits inverted boxes, so the count
                                      masks it)

The wide tree is tracy_tpu's _collapse4 (ops/pallas_packet.py:232): each
kept inner node's child list starts as its two binary children, and each
round of the collapse (one at width 4, two at width 8) replaces every inner
child by its two children, leaves staying. A wide node may thus have fewer
than W children; its empty slots are the masked ones above. Its leaves are
the binary leaves, so the slot tables serve every width. A leaf holds any
number of triangles (the BVH build's depth cap can leave more than
leaf_size), so no triangle is ever dropped. The binary traversal's stack
holds at most one entry per tree level (max_depth + 1); the W-wide one at
most W - 1 per wide level, (W - 1) * depthW + 1. Both are sized from the
real depth, and the kernel refuses a tree deeper than its fixed stack.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tracy_tpu_torch.accel.bvh_build import HostBVH, build_bvh_auto
from tracy_tpu_torch.render.material import scene_has_textures
from tracy_tpu_torch.scene.scene import TEX_NORMAL

# Entries of the kernel's per-thread stacks (csrc/traverse.cuh STACK_MAX,
# STACK4_MAX, STACK8_MAX). The binary stack holds max_depth + 1 <= 64
# entries, so a table's binary depth D is at most 63. A wide node's inner
# children sit two binary levels below it at width 4 and three at width 8
# (one and two rounds of the collapse, each expanding every inner child),
# so depthW <= (D - 1) // r + 1 with r = 2 or 3: D = 63 gives depth4 32
# and 97 entries (the default depth cap of the BVH build, 60, gives 91),
# and depth8 21 and 7 * 21 + 1 = 148 entries (D = 60: 141).
KERNEL_STACK_MAX = 64
KERNEL_STACK4_MAX = 97
KERNEL_STACK8_MAX = 148
WIDTHS = (2, 4, 8)
BIG = np.float32(3.4028235e38)  # tracy_tpu/ops/pallas_packet.py BIG


@dataclasses.dataclass
class BVHTables:
    node_bounds: torch.Tensor
    node_meta: torch.Tensor
    tri: torch.Tensor
    tri_meta: torch.Tensor
    tri_id: torch.Tensor
    vertex_normal: torch.Tensor
    max_depth: int  # deepest node (root = 0)
    vertex_uv: Optional[torch.Tensor] = None
    vertex_tangent: Optional[torch.Tensor] = None
    width: int = 2  # the tree K1 and K5 walk: 2 (binary), 4 or 8 (`wide`)
    wide: Optional[torch.Tensor] = None  # [NW, 8 * width], widths 4 and 8
    depth4: int = 0  # deepest chain of wide inner nodes (root = 1), any width

    @property
    def stack_size(self) -> int:
        """Entries the near-first traversal can hold: at width 2 one pushed
        far child per level above the deepest node, plus one spare; at
        width W > 2 up to W - 1 pushed children per wide level, plus one."""
        if self.width > 2:
            return (self.width - 1) * self.depth4 + 1
        return self.max_depth + 1

    @property
    def stack_max(self) -> int:
        """Entries of the kernel's fixed stack at this width."""
        return {2: KERNEL_STACK_MAX, 4: KERNEL_STACK4_MAX, 8: KERNEL_STACK8_MAX}[self.width]

    def binary(self) -> "BVHTables":
        """The same tables walked as the binary tree (width 2)."""
        return dataclasses.replace(self, width=2, wide=None, depth4=0)

    @property
    def device(self) -> torch.device:
        return self.node_bounds.device


def attribute_flags(scene):
    """(has_uv, with_tangent): which extra attributes K1 interpolates.

    As tracy_tpu/ops/pallas_packet.py:448-466 decides them, on textured
    scenes only: uv when any non-sky material references a texture (the
    sky's uv comes from the ray direction), the tangent only with uv and a
    normal map somewhere."""
    if not scene_has_textures(scene):
        return False, False
    tex_idx = scene.materials.tex_index.cpu().numpy()
    has_uv = bool((tex_idx[1:] >= 0).any())
    return has_uv, has_uv and bool((tex_idx[:, TEX_NORMAL] >= 0).any())


def collapse4(nb: np.ndarray, meta: np.ndarray, width: int = 4):
    """The binary BVH (node bounds [N, >=6] min xyz max xyz; meta [N, >=3]
    leaf (first, count > 0, .), inner (left, 0, right)) collapsed to
    `width` (4 or 8), as tracy_tpu/ops/pallas_packet.py::_collapse4 does it.

    Each kept binary inner node becomes a wide node whose child slots are
    its two binary children after log2(width) - 1 rounds, each of which
    replaces every inner child by its two children (leaves stay); the wide
    nodes are numbered in the order a depth-first walk (last pushed first)
    discovers them. Returns (bounds [NW, 6 * width] f32: per slot lo xyz hi
    xyz; meta [NW, 2 * width] i32: per slot (value, tag), tag 1 a leaf
    child (value its binary node), 0 an inner child (value its wide row),
    -1 an empty slot (never-hit box, value 0); depthW, the deepest chain of
    wide inner nodes, root = 1), or None when the root is a leaf (nothing
    to collapse)."""
    if meta[0, 1] > 0:
        return None

    def is_leaf(c):
        return meta[c, 1] > 0

    rows_b = [np.zeros(6 * width, np.float32)]
    rows_m = [np.zeros(2 * width, np.int32)]
    idmap = {0: 0}
    depth = {0: 1}
    depth_w = 1
    stack = [0]
    while stack:
        n = stack.pop()
        kids = [int(meta[n, 0]), int(meta[n, 2])]
        for _ in range(width.bit_length() - 2):
            kids = [g for c in kids
                    for g in ([c] if is_leaf(c) else [int(meta[c, 0]), int(meta[c, 2])])]
        brow = np.empty(6 * width, np.float32)
        mrow = np.empty(2 * width, np.int32)
        for k in range(width):
            if k < len(kids):
                b = kids[k]
                brow[6 * k:6 * k + 6] = nb[b, 0:6]
                if is_leaf(b):
                    mrow[2 * k], mrow[2 * k + 1] = b, 1
                else:
                    if b not in idmap:
                        idmap[b] = len(rows_b)
                        rows_b.append(None)
                        rows_m.append(None)
                        depth[b] = depth[n] + 1
                        depth_w = max(depth_w, depth[b])
                        stack.append(b)
                    mrow[2 * k], mrow[2 * k + 1] = idmap[b], 0
            else:
                brow[6 * k:6 * k + 3] = BIG
                brow[6 * k + 3:6 * k + 6] = -BIG
                mrow[2 * k], mrow[2 * k + 1] = 0, -1
        rows_b[idmap[n]] = brow
        rows_m[idmap[n]] = mrow
    return np.stack(rows_b), np.stack(rows_m), depth_w


def wide_lines(bounds_w: np.ndarray, meta_w: np.ndarray, meta: np.ndarray) -> np.ndarray:
    """collapse4's tables as the kernel's [NW, 8W] rows (module docstring):
    boxes by axis, then references and triangle counts as int bits."""
    nw, width = bounds_w.shape[0], meta_w.shape[1] // 2
    box = bounds_w.reshape(nw, width, 6)  # [node, slot, lo xyz hi xyz]
    val, tag = meta_w[:, 0::2], meta_w[:, 1::2]
    leaf = tag == 1
    first, count = meta[val, 0], meta[val, 1]
    ref = np.where(leaf, ~first, np.where(tag == 0, val, 0)).astype(np.int32)
    cnt = np.where(leaf, count, np.where(tag == 0, 0, -1)).astype(np.int32)
    out = np.empty((nw, 8 * width), np.float32)
    for a in range(3):  # x, y, z
        out[:, 2 * a * width:(2 * a + 1) * width] = box[:, :, a]
        out[:, (2 * a + 1) * width:(2 * a + 2) * width] = box[:, :, 3 + a]
    out[:, 6 * width:7 * width] = ref.view(np.float32)
    out[:, 7 * width:8 * width] = cnt.view(np.float32)
    return out


def tree_depth(meta: np.ndarray) -> int:
    """The deepest node of a binary tree (root = 0, depth 0), found by
    walking it from the root over node_meta rows (first, count, right):
    the real depth, which a stitched two-level tree's recorded max_depth
    only bounds (accel/tlas.py)."""
    deepest = 0
    stack = [(0, 0)]
    while stack:
        n, dep = stack.pop()
        deepest = max(deepest, dep)
        if meta[n, 1] == 0:
            stack.append((int(meta[n, 0]), dep + 1))
            stack.append((int(meta[n, 2]), dep + 1))
    return deepest


def host_bvh(scene, leaf_size: int = 8, max_depth: int = 60) -> HostBVH:
    """The single-level binned-SAH BVH over the scene's triangles, built on
    the host."""
    pos = scene.vertex_pos.detach().cpu().numpy().astype(np.float32)
    idx = scene.indices.cpu().numpy().astype(np.int64)
    v0, v1, v2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    return build_bvh_auto(np.minimum(np.minimum(v0, v1), v2),
                          np.maximum(np.maximum(v0, v1), v2),
                          leaf_size, max_depth)


def build_tables(scene, leaf_size: int = 8, max_depth: int = 60, width: int = 4) -> BVHTables:
    """Build the BVH on the host and upload the tables to scene's device.

    width 4 (RenderConfig.pallas_bvh_width's default) or 8 adds the wide
    tree; when the root is a leaf there is nothing to collapse, and the
    tables are the binary ones (width 2), as in tracy_tpu
    (pallas_packet.py:497-500)."""
    if width not in WIDTHS:
        raise ValueError(f"BVH width {width}: the port walks widths {WIDTHS}")
    return tables_from_host(scene, host_bvh(scene, leaf_size, max_depth), width)


def tables_from_host(scene, host: HostBVH, width: int = 4) -> BVHTables:
    """The kernel's tables for a host BVH over the scene's triangles: a
    single-level build (build_tables) or a stitched two-level tree
    (accel/tlas.py), which feed the same binary tables and wide rows.

    The depth (and so the traversal stack) is the tree's real depth, found
    by walking it: a stitched tree's recorded max_depth is only a bound. A
    tree deeper than the kernel's stack is refused with its depth, never
    cut."""
    if width not in WIDTHS:
        raise ValueError(f"BVH width {width}: the port walks widths {WIDTHS}")
    pos = scene.vertex_pos.detach().cpu().numpy().astype(np.float32)
    idx = scene.indices.cpu().numpy().astype(np.int64)
    order = host.tri_order.astype(np.int64)
    if not np.array_equal(np.sort(order), np.arange(len(idx))):
        raise RuntimeError("BVH slot order is not a permutation of the triangles")
    depth = tree_depth(host.node_meta)
    if depth + 1 > KERNEL_STACK_MAX:
        raise ValueError(f"BVH depth {depth} needs a traversal stack of "
                         f"{depth + 1} > {KERNEL_STACK_MAX} entries")

    nn = host.num_nodes
    nb = np.zeros((nn, 8), np.float32)
    nb[:, 0:3] = host.node_bounds[:, 0:3]
    nb[:, 4:7] = host.node_bounds[:, 3:6]
    nm = np.zeros((nn, 4), np.int32)
    nm[:, 0:3] = host.node_meta

    # Edges in float32, exactly as the brute-force oracle forms them.
    s_idx = idx[order]
    p0, p1, p2 = pos[s_idx[:, 0]], pos[s_idx[:, 1]], pos[s_idx[:, 2]]
    tri = np.zeros((len(order), 12), np.float32)
    tri[:, 0:3] = p0
    tri[:, 4:7] = p1 - p0
    tri[:, 8:11] = p2 - p0
    tmeta = np.zeros((len(order), 4), np.int32)
    tmeta[:, 0:3] = s_idx
    tmeta[:, 3] = scene.tri_material.cpu().numpy()[order]

    dev = scene.device
    wide, depth4 = None, 0
    tree = collapse4(host.node_bounds, host.node_meta, width) if width > 2 else None
    if tree is None:
        width = 2
    else:
        wide = torch.as_tensor(wide_lines(tree[0], tree[1], host.node_meta), device=dev)
        depth4 = tree[2]
    has_uv, with_tangent = attribute_flags(scene)
    return BVHTables(
        node_bounds=torch.as_tensor(nb, device=dev),
        node_meta=torch.as_tensor(nm, device=dev),
        tri=torch.as_tensor(tri, device=dev),
        tri_meta=torch.as_tensor(tmeta, device=dev),
        tri_id=torch.as_tensor(order.astype(np.int32), device=dev),
        vertex_normal=scene.vertex_normal.contiguous(),
        max_depth=depth,
        vertex_uv=scene.vertex_uv.contiguous() if has_uv else None,
        vertex_tangent=scene.vertex_tangent.contiguous() if with_tangent else None,
        width=width,
        wide=wide,
        depth4=depth4,
    )
