"""Ray-triangle intersection: the exact brute-force oracle.

Port of tracy_tpu/render/intersect.py. Möller–Trumbore with backface
culling, as the reference's collision::RayTriangle (src/collision.h:33-74):
`det < EPS` culls degenerate and back-facing triangles, u and v are tested
against EPS and det before the division, and t must lie in (EPS, t_max).

The JAX oracle skips triangle chunks whose box no ray reaches; that cull
only saves work, so the port leaves it out and tests every triangle.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tracy_tpu_torch.core import math as tm

FLT_MAX = 3.4028234663852886e38  # float32 max


class Hit(NamedTuple):
    """SoA hit record (reference HitData, common.h:237)."""

    t: torch.Tensor  # [N] hit distance (FLT_MAX on a miss)
    tri: torch.Tensor  # [N] int32 triangle index in the global soup
    uv: torch.Tensor  # [N, 2] barycentric (u, v)
    mask: torch.Tensor  # [N] bool


def ray_triangle_grid(origin, direction, p0, e1, e2, t_max):
    """All-pairs Möller–Trumbore over rays [N, 3] x triangles [C, 3].

    Returns (t, u, v), each [N, C]; a missing pair has t = FLT_MAX, and u/v
    are already divided by det.
    """
    d = direction[:, None, :]
    pvec = tm.cross(d, e2[None, :, :])
    det = tm.dot(e1[None, :, :], pvec, keepdim=False)
    tvec = origin[:, None, :] - p0[None, :, :]
    u = tm.dot(tvec, pvec, keepdim=False)
    qvec = tm.cross(tvec, e1[None, :, :])
    v = tm.dot(d, qvec, keepdim=False)
    t_scaled = tm.dot(e2[None, :, :], qvec, keepdim=False)

    ok = det > tm.EPS
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                          torch.zeros_like(det))
    t = t_scaled * inv_det
    valid = (ok & (u >= tm.EPS) & (u <= det) & (v >= tm.EPS) & (u + v <= det)
             & (t > tm.EPS) & (t < t_max[:, None]))
    t = torch.where(valid, t, torch.full_like(t, FLT_MAX))
    return t, u * inv_det, v * inv_det


def intersect_bruteforce(origin, direction, p0, e1, e2,
                         t_max: Optional[torch.Tensor] = None,
                         tri_chunk: int = 512,
                         active: Optional[torch.Tensor] = None) -> Hit:
    """Closest hit over the whole triangle soup, `tri_chunk` triangles at a
    time. On equal t the lower triangle index wins."""
    n = origin.shape[0]
    dev = origin.device
    best_t = torch.full((n,), FLT_MAX, dtype=origin.dtype, device=dev) if t_max is None else t_max
    tri = torch.zeros((n,), dtype=torch.int32, device=dev)
    uv = torch.zeros((n, 2), dtype=origin.dtype, device=dev)
    mask = torch.zeros((n,), dtype=torch.bool, device=dev)
    rows = torch.arange(n, device=dev)
    for base in range(0, p0.shape[0], tri_chunk):
        sl = slice(base, base + tri_chunk)
        t, u, v = ray_triangle_grid(origin, direction, p0[sl], e1[sl], e2[sl], best_t)
        best = torch.argmin(t, dim=-1)  # first minimum, like jnp.argmin
        bt = t[rows, best]
        improved = bt < best_t
        best_t = torch.where(improved, bt, best_t)
        tri = torch.where(improved, (base + best).to(torch.int32), tri)
        uv = torch.where(improved[:, None],
                         torch.stack([u[rows, best], v[rows, best]], dim=-1), uv)
        mask = mask | improved
    if active is not None:
        mask = mask & active
    return Hit(t=best_t, tri=tri, uv=uv, mask=mask)
