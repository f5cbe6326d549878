"""BVH tables for the intersect kernel (ops/intersect.py).

The port's counterpart of tracy_tpu/accel/packet.py::pack_bvh and
ops/pallas_packet.py::build_tables. The TPU tables realign leaves into
128-slot chunks and pack Woop rows for one DMA per leaf visit; a GPU thread
traverses its own ray and gathers freely, so the port keeps the builder's
binary tree as it is:

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

A leaf holds any number of triangles (the builder's depth cap can leave
more than leaf_size), so no triangle is ever dropped. The traversal stack
holds at most one entry per tree level; `stack_size` is sized from the real
depth and the kernel refuses a tree deeper than its fixed stack.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tracy_tpu_torch.accel.bvh_build import build_bvh_auto
from tracy_tpu_torch.render.material import scene_has_textures
from tracy_tpu_torch.scene.scene import TEX_NORMAL

# Slots in the kernel's per-thread stack (csrc/intersect.cu STACK_MAX).
KERNEL_STACK_MAX = 64


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

    @property
    def stack_size(self) -> int:
        """Entries the near-first traversal can hold: one pushed far child
        per level above the deepest node, plus one spare."""
        return self.max_depth + 1

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


def build_tables(scene, leaf_size: int = 8, max_depth: int = 60) -> BVHTables:
    """Build the BVH on the host and upload the tables to scene's device."""
    pos = scene.vertex_pos.detach().cpu().numpy().astype(np.float32)
    idx = scene.indices.cpu().numpy().astype(np.int64)
    v0, v1, v2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    host = build_bvh_auto(np.minimum(np.minimum(v0, v1), v2),
                          np.maximum(np.maximum(v0, v1), v2),
                          leaf_size, max_depth)
    order = host.tri_order.astype(np.int64)
    if not np.array_equal(np.sort(order), np.arange(len(idx))):
        raise RuntimeError("BVH slot order is not a permutation of the triangles")
    if host.max_depth + 1 > KERNEL_STACK_MAX:
        raise ValueError(f"BVH depth {host.max_depth} needs a traversal stack of "
                         f"{host.max_depth + 1} > {KERNEL_STACK_MAX} entries")

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
    has_uv, with_tangent = attribute_flags(scene)
    return BVHTables(
        node_bounds=torch.as_tensor(nb, device=dev),
        node_meta=torch.as_tensor(nm, device=dev),
        tri=torch.as_tensor(tri, device=dev),
        tri_meta=torch.as_tensor(tmeta, device=dev),
        tri_id=torch.as_tensor(order.astype(np.int32), device=dev),
        vertex_normal=scene.vertex_normal.contiguous(),
        max_depth=int(host.max_depth),
        vertex_uv=scene.vertex_uv.contiguous() if has_uv else None,
        vertex_tangent=scene.vertex_tangent.contiguous() if with_tangent else None,
    )
