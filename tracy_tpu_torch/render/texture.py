"""Texture sampling from the flat atlas, and the per-lane texel row layout.

Port of tracy_tpu/render/texture.py::sample_nearest (reference
Texture::GetPixel, src/texture.h:50-57): nearest neighbour, repeat wrap via
frac(), v flipped (`frac(1 - v)`), indices clipped to the texture, all in
float32 in the JAX package's operation order, so that both packages pick
the same texel. One ulp of uv can move a texel index at a cell edge.

`sample_bilinear` is the raster preview's GL_LINEAR + GL_REPEAT filter
(tracy_tpu/render/texture.py::sample_bilinear, opengl_render.cpp:476-480),
and `fetch_texels_bilinear` lays its samples out as K3's texel rows for
render/material.py::gather_surface_params(tex_filter="bilinear"). In the
JAX package this filter is XLA, not a kernel, so it is plain torch here on
every device.

`sky_uv` is the equirect mapping of a miss direction
(tracy_tpu/render/integrator.py::sky_emission, cpu_trace.cpp:149).

TEXEL_COLS is the row that the texel fetch (ops/texfetch.py, K3) writes
per lane, which the textured shade stage (ops/shade.py, K4) keeps in
registers and its plain version reads: the five material slots at full
resolution, the TPU kernel's page rows (tracy_tpu/ops/pallas_texfetch.py
TX_*), plus one column of padding so a row is three 16-byte vectors.
"""

from __future__ import annotations

import numpy as np
import torch

from tracy_tpu_torch.core.math import gather_rows

# Texel row columns (tracy_tpu/ops/pallas_texfetch.py TX_* order).
TX_BCR, TX_BCG, TX_BCB = 0, 1, 2
TX_NMR, TX_NMG, TX_NMB = 3, 4, 5
TX_ROUGH, TX_METAL = 6, 7
TX_EMR, TX_EMG, TX_EMB = 8, 9, 10
TEXEL_ROWS = 11  # texel values per lane
TEXEL_COLS = 12  # with one column of padding
# First column and channel count of each texture slot (TEX_* order).
SLOT_COLUMNS = ((TX_BCR, 3), (TX_NMR, 3), (TX_ROUGH, 1), (TX_METAL, 1), (TX_EMR, 3))

# float32(2 pi) and float32(pi): the constants `2.0 * jnp.pi` and `jnp.pi`
# become when they meet a float32 array.
TWO_PI_F32 = float(np.float32(2.0 * np.pi))
PI_F32 = float(np.float32(np.pi))


def texel_index(tex_table, tex_id, uv) -> torch.Tensor:
    """Flat atlas row of the nearest texel: [N] int64. tex_id -1 lanes
    address texture 0 (the caller selects a fallback value)."""
    entry = tex_table[tex_id.clamp(min=0).long()]
    offset, width, height = entry[:, 0].long(), entry[:, 1], entry[:, 2]
    wf = width.to(uv.dtype)
    hf = height.to(uv.dtype)
    u = uv[:, 0]
    v = uv[:, 1]
    fu = u - torch.floor(u)
    fv = (1.0 - v) - torch.floor(1.0 - v)
    zero = torch.zeros((), dtype=uv.dtype, device=uv.device)
    i = torch.minimum(torch.maximum(fu * wf, zero), wf - 1.0).to(torch.int32)
    j = torch.minimum(torch.maximum(fv * hf, zero), hf - 1.0).to(torch.int32)
    return offset + (j * width + i).long()


def sample_nearest(tex_data, tex_table, tex_id, uv) -> torch.Tensor:
    """RGBA [N, 4] of texture tex_id [N] at uv [N, 2]."""
    return gather_rows(tex_data, texel_index(tex_table, tex_id, uv))


def sample_bilinear(tex_data, tex_table, tex_id, uv) -> torch.Tensor:
    """RGBA [N, 4] of texture tex_id [N] at uv [N, 2], bilinear from level 0
    with repeat wrap: texel centres at half-integers, the 2x2 footprint
    wrapped modulo the texture size, v flipped as sample_nearest flips it
    (tracy_tpu's sample_bilinear, in its float32 operation order)."""
    entry = tex_table[tex_id.clamp(min=0).long()]
    offset, width, height = entry[:, 0].long(), entry[:, 1].long(), entry[:, 2].long()
    wf = width.to(uv.dtype)
    hf = height.to(uv.dtype)
    u = uv[:, 0]
    v = uv[:, 1]
    fu = u - torch.floor(u)
    fv = (1.0 - v) - torch.floor(1.0 - v)
    x = fu * wf - 0.5
    y = fv * hf - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    ax = (x - x0)[:, None]
    ay = (y - y0)[:, None]

    def wrap(i, n):  # repeat wrap: i may be -1 or n after the + 1
        return torch.where(i < 0, i + n, torch.where(i >= n, i - n, i))

    i0 = wrap(x0.long(), width)
    j0 = wrap(y0.long(), height)
    i1 = wrap(i0 + 1, width)
    j1 = wrap(j0 + 1, height)

    def texel(i, j):
        return gather_rows(tex_data, offset + j * width + i)

    top = texel(i0, j0) * (1.0 - ax) + texel(i1, j0) * ax
    bot = texel(i0, j1) * (1.0 - ax) + texel(i1, j1) * ax
    return top * (1.0 - ay) + bot * ay


def fetch_texels_bilinear(mat_id, uv, direction, hit_mask, alive, tex_data, tex_table,
                          tex_index) -> torch.Tensor:
    """[N, TEXEL_COLS] texel rows, as K3 (ops/texfetch.py) lays them out,
    of each lane's material slots sampled bilinearly at uv. Every lane
    samples (the raster preview resolves its pixels first); a slot with no
    texture reads texture 0, which the caller does not select. direction,
    hit_mask and alive are the texel fetch's arguments, unused here."""
    n = mat_id.shape[0]
    tids = tex_index[mat_id.long()]
    out = torch.zeros((n, TEXEL_COLS), dtype=tex_data.dtype, device=tex_data.device)
    for slot, (col, channels) in enumerate(SLOT_COLUMNS):
        out[:, col:col + channels] = sample_bilinear(tex_data, tex_table, tids[:, slot],
                                                     uv)[:, :channels]
    return out


def sky_uv(direction) -> torch.Tensor:
    """Equirect uv of unit directions [N, 3]: (atan2(z, x) / 2pi + .5,
    asin(y) / pi + .5), divided by the float32 constants of the JAX code."""
    d = direction
    two_pi = torch.full((), TWO_PI_F32, dtype=d.dtype, device=d.device)
    pi = torch.full((), PI_F32, dtype=d.dtype, device=d.device)
    u = torch.atan2(d[:, 2], d[:, 0]) / two_pi + 0.5
    v = torch.asin(torch.clamp(d[:, 1], -1.0, 1.0)) / pi + 0.5
    return torch.stack([u, v], dim=-1)
