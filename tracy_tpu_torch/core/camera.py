"""Pinhole camera and batched inverse-view-projection ray generation.

Port of tracy_tpu/core/camera.py (reference src/camera.h:11-85): rays
un-project the NDC point (s, t, 1)*2-1 through inverse(projection @ view).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tracy_tpu_torch.core import math as tm
from tracy_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass
class Camera:
    """Eye position and the 4x4 matrices, as float32 tensors on one device."""

    eye: torch.Tensor  # [3]
    inv_view_projection: torch.Tensor  # [4, 4]
    view: torch.Tensor  # [4, 4]
    projection: torch.Tensor  # [4, 4]

    @classmethod
    def setup(cls, eye, center, up, fov_degrees: float, aspect_ratio: float,
              znear: float = 0.1, zfar: float = 10000.0,
              device=DEFAULT_DEVICE) -> "Camera":
        """Build from lookAt parameters (reference Camera::Setup). The
        matrices are computed in float64 on the host, then cast once, onto
        the card by default (device="cpu" for the CPU)."""
        device = resolve_device(device)
        view = tm.look_at(eye, center, up)
        proj = tm.perspective(tm.radians(fov_degrees), aspect_ratio, znear, zfar)
        inv_vp = np.linalg.inv(proj @ view)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return cls(eye=f32(eye), inv_view_projection=f32(inv_vp),
                   view=f32(view), projection=f32(proj))

    def generate_rays(self, s, t):
        """Reference Camera::GetRayFrom (camera.h:28-35) over [...] samples.

        Returns (origins [..., 3], normalized directions [..., 3]). The 4x4
        product stays as explicit mul-adds, in the JAX package's order.
        """
        ndc = torch.stack([s, t, torch.ones_like(s)], dim=-1) * 2.0 - 1.0
        p = torch.cat([ndc, torch.ones_like(ndc[..., :1])], dim=-1)
        m = self.inv_view_projection
        world = (
            p[..., 0:1] * m[:, 0]
            + p[..., 1:2] * m[:, 1]
            + p[..., 2:3] * m[:, 2]
            + p[..., 3:4] * m[:, 3]
        )
        world = world[..., :3] / world[..., 3:4]
        direction = tm.normalize(world - self.eye)
        origin = self.eye.expand(direction.shape)
        return origin, direction


def pixel_samples_rows(width: int, height: int, rows, jitter_u, jitter_v):
    """(s, t) sample coordinates for a band of global image rows.

    Image row 0 is the top; the reference's v counts from the bottom, so a
    pixel at row r uses v = (height - 1 - r + jitter) / height.

    Args:
      rows: [R] global image row indices.
      jitter_u/jitter_v: [R, width] jitters in [0, 1).
    Returns: (s, t) each [R, width].
    """
    r = rows.to(jitter_v.dtype)[:, None]
    x = torch.arange(width, dtype=jitter_u.dtype, device=jitter_u.device)[None, :]
    y = (height - 1) - r
    # Divide by tensors: torch's CUDA division by a Python number multiplies
    # by its reciprocal, one ulp off the quotient that the CPU (and XLA)
    # compute, which moved 24 of 3072 camera rays on the H100.
    w, h = (torch.full((), n, dtype=jitter_u.dtype, device=jitter_u.device)
            for n in (width, height))
    s = (x + jitter_u) / w
    t = (y + jitter_v) / h
    shape = (jitter_u.shape[0], width)
    return s.expand(shape), t.expand(shape)
