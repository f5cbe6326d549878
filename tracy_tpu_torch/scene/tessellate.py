"""Procedural geometry: UV-sphere, box, single triangle.

Vectorized numpy equivalents of reference Scene::AddSphere / AddBox /
AddTriangle (src/scene.cpp:50-222). Vertex layouts, winding and UVs match the
reference exactly (4 vertices per lat/long quad, dedicated cap triangles, the
24-vertex + 4 extra box layout) so that images and tessellation-dependent
sampling agree.
"""

from __future__ import annotations

import numpy as np

from tracy_tpu_torch.scene.hostmesh import HostMesh


def sphere(center, radius: float, steps: int = 32) -> HostMesh:
    """UV sphere. Mirrors scene.cpp:50-131 (including its 4-verts-per-quad
    duplication and cap handling)."""
    center = np.asarray(center, dtype=np.float64)
    lon = np.arange(steps, dtype=np.float64)  # [steps]
    lat = np.arange(steps, dtype=np.float64)

    d_theta1 = lon / steps
    d_theta2 = (lon + 1) / steps
    theta1, theta2 = d_theta1 * np.pi, d_theta2 * np.pi
    d_phi1 = lat / steps
    d_phi2 = (lat + 1) / steps
    phi1, phi2 = d_phi1 * 2 * np.pi, d_phi2 * 2 * np.pi

    # Broadcast to [steps(lon), steps(lat)] quads.
    def unit(theta, phi):
        st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
        return np.stack(
            [
                st * np.cos(phi)[None, :],
                st * np.sin(phi)[None, :],
                np.broadcast_to(ct, (steps, steps)),
            ],
            axis=-1,
        )  # [lon, lat, 3]

    # The 4 quad corners, in the reference's emit order (vertex1..vertex4).
    p1 = unit(theta1, phi1)
    p2 = unit(theta1, phi2)
    p3 = unit(theta2, phi2)
    p4 = unit(theta2, phi1)

    def uv(dphi, dtheta):
        return np.stack(
            np.broadcast_arrays(dphi[None, :], dtheta[:, None]), axis=-1
        )  # [lon, lat, 2]

    uv1 = uv(d_phi1, d_theta1)
    uv2 = uv(d_phi2, d_theta1)
    uv3 = uv(d_phi2, d_theta2)
    uv4 = uv(d_phi1, d_theta2)

    # Interleave per quad: [lon, lat, 4, 3] -> flat [N*4, 3] in loop order
    # (lon outer, lat inner), matching vertices.emplace_back order.
    pos_unit = np.stack([p1, p2, p3, p4], axis=2).reshape(-1, 3)
    uvs = np.stack([uv1, uv2, uv3, uv4], axis=2).reshape(-1, 2)
    positions = center + pos_unit * radius
    normals = pos_unit / np.linalg.norm(pos_unit, axis=-1, keepdims=True)

    # Indices: base = quad_id*4. Top cap (lon==0): (0,3,2); end cap
    # (lon==steps-1): (2,1,0); else two triangles (0,3,1),(1,3,2).
    quad_id = np.arange(steps * steps).reshape(steps, steps)
    base = quad_id * 4
    tris = []
    top = base[0]
    tris.append(np.stack([top + 0, top + 3, top + 2], axis=-1))
    mid = base[1 : steps - 1].reshape(-1)
    if len(mid):
        tris.append(np.stack([mid + 0, mid + 3, mid + 1], axis=-1))
        tris.append(np.stack([mid + 1, mid + 3, mid + 2], axis=-1))
    bot = base[steps - 1]
    tris.append(np.stack([bot + 2, bot + 1, bot + 0], axis=-1))
    indices = np.concatenate(tris, axis=0)

    m = HostMesh(positions, indices, normals=normals, uvs=uvs)
    return m.compute_bounding_box().compute_tangents()


# Box layout tables transcribed from scene.cpp:133-213: 24 corner-id /
# normal-id / uv-id triplets plus the per-face triangle index lists.
_BOX_CORNER = [4, 2, 0, 2, 7, 3, 6, 5, 7, 1, 7, 5, 0, 3, 1, 4, 1, 5, 6, 6, 4, 3, 2, 0]
_BOX_NORMAL_ID = [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5, 0, 1, 2, 3, 4, 5]
_BOX_UV_ID = [0, 3, 1, 1, 2, 3, 1, 2, 3, 3, 0, 2, 1, 2, 3, 1, 2, 3, 2, 0, 0, 1, 0, 0]
_BOX_INDICES = [
    [0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10, 11], [12, 13, 14], [15, 16, 17],
    [0, 18, 1], [3, 19, 4], [6, 20, 7], [9, 21, 10], [12, 22, 13], [15, 23, 16],
]
_BOX_NORMALS = np.array(
    [[0, 1, 0], [0, 0, 1], [-1, 0, 0], [0, -1, 0], [1, 0, 0], [0, 0, -1]],
    dtype=np.float64,
)
_BOX_UVS = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], dtype=np.float64)


def box(bottom, top, transform: np.ndarray | None = None) -> HostMesh:
    """Axis-aligned box as a 24-vertex/36-index tri list (scene.cpp:133-214),
    optionally transformed (the reference rotates boxes about their center)."""
    bottom = np.asarray(bottom, dtype=np.float64)
    top = np.asarray(top, dtype=np.float64)
    # Corner table from scene.cpp:135-144 (index bit pattern of the reference's
    # `vertices[]` array: 0..3 use top.x, 4..7 bottom.x, etc.).
    corners = np.array(
        [
            [top[0], top[1], bottom[2]],
            [top[0], bottom[1], bottom[2]],
            [top[0], top[1], top[2]],
            [top[0], bottom[1], top[2]],
            [bottom[0], top[1], bottom[2]],
            [bottom[0], bottom[1], bottom[2]],
            [bottom[0], top[1], top[2]],
            [bottom[0], bottom[1], top[2]],
        ]
    )
    positions = corners[_BOX_CORNER]
    normals = _BOX_NORMALS[_BOX_NORMAL_ID]
    uvs = _BOX_UVS[_BOX_UV_ID]
    indices = np.asarray(_BOX_INDICES, dtype=np.int32)

    m = HostMesh(positions, indices, normals=normals, uvs=uvs)
    if transform is not None:
        m.transform(transform)
    return m.compute_bounding_box().compute_tangents()


def triangle(v1, v2, v3) -> HostMesh:
    """Single triangle with computed flat normal (scene.cpp:216-222)."""
    positions = np.stack([np.asarray(v, dtype=np.float64) for v in (v1, v2, v3)])
    indices = np.array([[0, 1, 2]], dtype=np.int32)
    m = HostMesh(positions, indices)
    return m.compute_bounding_box().compute_normals().compute_tangents()
