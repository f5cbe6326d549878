"""Host-side (numpy) triangle mesh with the reference's geometry processing.

Equivalent of reference src/mesh.h (Mesh: vertex/index buffers + transform /
normal / tangent / bbox computation) but SoA numpy arrays and fully vectorized
— no per-vertex C++ loops. These run once at scene-build time on the host; the
results are flattened into the device-side SceneArrays tensors. A numpy copy
of tracy_tpu/scene/hostmesh.py (the JAX package cannot load without jax).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class HostMesh:
    """SoA triangle mesh. positions [V,3], indices [F,3] (int32)."""

    positions: np.ndarray
    indices: np.ndarray
    normals: Optional[np.ndarray] = None  # [V,3]
    uvs: Optional[np.ndarray] = None  # [V,2]
    tangents: Optional[np.ndarray] = None  # [V,3]
    bitangents: Optional[np.ndarray] = None  # [V,3]
    material_id: int = -1
    aabb_min: Optional[np.ndarray] = None
    aabb_max: Optional[np.ndarray] = None

    def __post_init__(self):
        self.positions = np.ascontiguousarray(self.positions, dtype=np.float64)
        self.indices = np.ascontiguousarray(self.indices, dtype=np.int32).reshape(-1, 3)
        if self.normals is None:
            self.normals = np.zeros_like(self.positions)
        if self.uvs is None:
            self.uvs = np.zeros((len(self.positions), 2), dtype=np.float64)
        self.normals = np.ascontiguousarray(self.normals, dtype=np.float64)
        self.uvs = np.ascontiguousarray(self.uvs, dtype=np.float64)

    @property
    def num_vertices(self) -> int:
        return len(self.positions)

    @property
    def num_triangles(self) -> int:
        return len(self.indices)

    # -- geometry processing (reference mesh.h:116-201) ----------------------

    def transform(self, matrix: np.ndarray) -> "HostMesh":
        """Apply a 4x4 transform: positions by M, normals by (M^-1)^T.

        Matches reference Mesh::Transform (mesh.h:116-125), including its
        quirk of running normals through the full inverse-transpose with w=1
        and then normalizing.
        """
        m = np.asarray(matrix, dtype=np.float64)
        p = self.positions @ m[:3, :3].T + m[:3, 3]
        nmat = np.linalg.inv(m).T
        n = self.normals @ nmat[:3, :3].T + nmat[:3, 3]
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        n = n / np.maximum(norm, 1e-30)
        self.positions, self.normals = p, n
        return self

    def compute_normals(self) -> "HostMesh":
        """Flat face normals, later faces overwriting shared vertices.

        Matches reference Mesh::ComputeNormals (mesh.h:127-140): every vertex
        of a face gets that face's normal; a vertex shared by several faces
        ends up with the *last* face's normal (assignment order semantics).
        numpy fancy assignment with duplicate indices keeps the last write,
        reproducing that exactly.
        """
        v0 = self.positions[self.indices[:, 0]]
        v1 = self.positions[self.indices[:, 1]]
        v2 = self.positions[self.indices[:, 2]]
        fn = np.cross(v1 - v0, v2 - v0)
        fn = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-30)
        # Face-major write order: each vertex keeps the normal of the LAST
        # face-corner that references it (seq = face*3 + corner).
        flat_idx = self.indices.reshape(-1).astype(np.int64)
        seq = np.arange(flat_idx.size, dtype=np.int64)
        last = np.full(self.num_vertices, -1, dtype=np.int64)
        np.maximum.at(last, flat_idx, seq)
        normals = np.zeros_like(self.positions)
        written = last >= 0
        normals[written] = fn[last[written] // 3]
        self.normals = normals
        return self

    def compute_bounding_box(self) -> "HostMesh":
        self.aabb_min = self.positions.min(axis=0)
        self.aabb_max = self.positions.max(axis=0)
        return self

    def compute_tangents(self) -> "HostMesh":
        """Lengyel tangent-space basis (reference mesh.h:154-195).

        The reference accumulates per-face tangents with the statement
        `v1.tangent += v2.tangent = v3.tangent = tangent;` — i.e. corners 1 and
        2 are *assigned* (resetting any accumulated value) while corner 0
        *accumulates*, in face order. This reproduces that sequential
        semantics, vectorized.

        Degenerate UVs (r = 1/0) produce non-finite tangents in the reference;
        we sanitize those to an arbitrary normal-orthogonal frame since they
        are only consumed by normal mapping.
        """
        idx = self.indices
        f = len(idx)
        v0, v1, v2 = (self.positions[idx[:, c]] for c in range(3))
        w0, w1, w2 = (self.uvs[idx[:, c]] for c in range(3))

        dp1, dp2 = v1 - v0, v2 - v0
        du1, du2 = w1 - w0, w2 - w0

        denom = du1[:, 0] * du2[:, 1] - du1[:, 1] * du2[:, 0]
        with np.errstate(divide="ignore", invalid="ignore"):
            r = 1.0 / denom
            t_face = (dp1 * du2[:, 1:2] - dp2 * du1[:, 1:2]) * r[:, None]
            b_face = (dp2 * du1[:, 0:1] - dp1 * du2[:, 0:1]) * r[:, None]
        t_face = np.nan_to_num(t_face, nan=0.0, posinf=0.0, neginf=0.0)
        b_face = np.nan_to_num(b_face, nan=0.0, posinf=0.0, neginf=0.0)

        nv = self.num_vertices
        tangent = np.zeros((nv, 3))
        bitangent = np.zeros((nv, 3))
        if f > 0:
            # Last assigning face per vertex via corners 1 and 2.
            face_ids = np.arange(f)
            fstar = np.full(nv, -1, dtype=np.int64)
            np.maximum.at(fstar, idx[:, 1], face_ids)
            np.maximum.at(fstar, idx[:, 2], face_ids)
            assigned = fstar >= 0
            tangent[assigned] = t_face[fstar[assigned]]
            bitangent[assigned] = b_face[fstar[assigned]]
            # Corner-0 accumulations that happen *after* the last assignment.
            mask = face_ids > fstar[idx[:, 0]]
            np.add.at(tangent, idx[mask, 0], t_face[mask])
            np.add.at(bitangent, idx[mask, 0], b_face[mask])

        # Orthonormalize against the vertex normal + handedness fix
        # (mesh.h:182-192).
        n = self.normals
        t = tangent - n * np.sum(n * tangent, axis=-1, keepdims=True)
        tlen = np.linalg.norm(t, axis=-1, keepdims=True)
        degenerate = (tlen < 1e-12).ravel() | ~np.isfinite(tlen).ravel()
        t = np.where(degenerate[:, None], _any_orthogonal(n), t / np.maximum(tlen, 1e-30))
        sign = np.where(np.sum(np.cross(n, t) * bitangent, axis=-1) < 0.0, -1.0, 1.0)
        b = sign[:, None] * np.cross(n, t)

        self.tangents, self.bitangents = t, b
        return self


def _any_orthogonal(n: np.ndarray) -> np.ndarray:
    """A unit vector orthogonal to each row of n (fallback tangent frame)."""
    a = np.where(np.abs(n[:, 0:1]) < 0.9, np.array([[1.0, 0.0, 0.0]]), np.array([[0.0, 1.0, 0.0]]))
    t = np.cross(n, np.broadcast_to(a, n.shape))
    return t / np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-30)
