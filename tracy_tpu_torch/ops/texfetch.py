"""K3: per-lane texel fetch from the flat texture atlas.

`fetch_texels` launches the hand-written kernel csrc/texfetch.cu on CUDA
tensors; on CPU tensors, and only there, it runs `fetch_texels_plain`. The
kernel replaces tracy_tpu/ops/pallas_texfetch.py::_fetch_kernel (entered
through fetch_texels, addressed by lane_page_indices / _texel_ij), but
reads the flat atlas directly instead of the TPU's texel pages. The
textured AOVs call it, once a frame (render/material.py::
gather_surface_params). The beauty paths do not: K4
(ops/shade.py::shade_textured) fetches the same texels itself, through
the same device functions (csrc/texfetch_lane.cuh), and its plain version
and the differentiable bounce call `fetch_texels_plain`.

Output: [N, TEXEL_COLS] float32 rows in render/texture.py's layout. A live
hit lane gets every texture slot of its material at its uv; a live miss
lane gets the textured sky's emissive texel at the equirect uv of its
direction; every other value is zero.
"""

from __future__ import annotations

import torch

from tracy_tpu_torch.core.math import gather_rows
from tracy_tpu_torch.ops.build import LIBRARY
from tracy_tpu_torch.ops.launch import LaunchCount, check, raise_on_error
from tracy_tpu_torch.render.texture import (
    SLOT_COLUMNS,
    TEXEL_COLS,
    sky_uv,
    texel_index,
)
from tracy_tpu_torch.scene.scene import NUM_TEX_SLOTS, SKY_MATERIAL_ID, TEX_EMISSIVE

COUNT = LaunchCount()
# Shared memory for the staged tables: the 48 KB a block gets without
# opting in.
SMEM_LIMIT = 48 * 1024


def fetch_texels(mat_id, uv, direction, hit_mask, alive, tex_data, tex_table,
                 tex_index) -> torch.Tensor:
    """Texel rows [N, TEXEL_COLS] for N lanes.

    mat_id [N] int32; uv [N, 2] float32 interpolated texture uv, or None
    (read as zero: no material but the sky is textured); direction [N, 3];
    hit_mask, alive [N] bool; tex_data [P, 4] float32; tex_table [K, 4] and
    tex_index [M, 5] int32 (scene/scene.py).
    """
    if mat_id.device.type == "cpu":
        COUNT.plain += 1
        return fetch_texels_plain(mat_id, uv, direction, hit_mask, alive, tex_data,
                                  tex_table, tex_index)
    n = mat_id.shape[0]
    dev = mat_id.device
    check("mat_id", mat_id, torch.int32, (n,), dev)
    if uv is not None:
        check("uv", uv, torch.float32, (n, 2), dev)
    check("direction", direction, torch.float32, (n, 3), dev)
    check("hit_mask", hit_mask, torch.bool, (n,), dev)
    check("alive", alive, torch.bool, (n,), dev)
    check_texture_tables(tex_data, tex_table, tex_index, dev)
    smem = 16 * tex_table.shape[0] + 4 * NUM_TEX_SLOTS * tex_index.shape[0]
    if smem > SMEM_LIMIT:
        raise ValueError(f"fetch_texels: {tex_index.shape[0]} materials and "
                         f"{tex_table.shape[0]} textures need {smem} bytes of shared "
                         f"memory, more than the kernel's {SMEM_LIMIT}")

    out = torch.empty((n, TEXEL_COLS), dtype=torch.float32, device=dev)
    lib = LIBRARY.get()
    code = lib.tracy_texfetch(
        mat_id.data_ptr(), 0 if uv is None else uv.data_ptr(), direction.data_ptr(),
        hit_mask.data_ptr(), alive.data_ptr(), n, tex_data.data_ptr(),
        tex_table.data_ptr(), tex_table.shape[0], tex_index.data_ptr(),
        tex_index.shape[0], out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error("texfetch", code)
    COUNT.kernel += 1
    return out


def check_texture_tables(tex_data, tex_table, tex_index, device):
    """Raise unless the atlas and its tables are what the kernels read:
    tex_data [P, 4] float32 and tex_table [K, 4] int32, 16-byte aligned
    (read as 16-byte vectors), tex_index [M, 5] int32 with M >= 1."""
    check("tex_data", tex_data, torch.float32, (tex_data.shape[0], 4), device)
    check("tex_table", tex_table, torch.int32, (tex_table.shape[0], 4), device)
    check("tex_index", tex_index, torch.int32, (tex_index.shape[0], NUM_TEX_SLOTS), device)
    for name, x in (("tex_data", tex_data), ("tex_table", tex_table)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: the kernels read it in 16-byte vectors; "
                             "it must be 16-byte aligned")
    if tex_index.shape[0] < 1:
        raise ValueError("tex_index: needs at least the sky material")


def texel_addresses(mat_id, uv, direction, hit_mask, alive, tex_table,
                    tex_index) -> torch.Tensor:
    """The atlas row each lane reads for each texture slot: [N, 5] int64,
    -1 where it reads nothing. A miss lane's sky texel sits in the emissive
    slot. Materials out of range read as material 0, as in K2."""
    n = mat_id.shape[0]
    dev = mat_id.device
    num_m, num_t = tex_index.shape[0], tex_table.shape[0]
    mat = mat_id.long()
    tex = tex_index[torch.where((mat >= 0) & (mat < num_m), mat, 0)]  # [N, 5]
    safe = tex.clamp(max=num_t - 1)  # out-of-range ids read nothing, as in the kernel
    if uv is None:
        uv = torch.zeros((n, 2), dtype=direction.dtype, device=dev)
    live_hit = alive & hit_mask
    none = torch.full((), -1, dtype=torch.int64, device=dev)
    flat = torch.stack(
        [torch.where(live_hit & (tex[:, s] >= 0) & (tex[:, s] < num_t),
                     texel_index(tex_table, safe[:, s], uv), none)
         for s in range(NUM_TEX_SLOTS)], dim=1)
    sky_tid = tex_index[SKY_MATERIAL_ID, TEX_EMISSIVE].expand(n)
    sky = alive & ~hit_mask & (sky_tid >= 0) & (sky_tid < num_t)
    flat[:, TEX_EMISSIVE] = torch.where(
        sky, texel_index(tex_table, sky_tid.clamp(max=num_t - 1), sky_uv(direction)),
        flat[:, TEX_EMISSIVE])
    return flat


def fetch_texels_plain(mat_id, uv, direction, hit_mask, alive, tex_data, tex_table,
                       tex_index) -> torch.Tensor:
    """The kernel's fetch in PyTorch: addresses, then one gather per slot."""
    flat = texel_addresses(mat_id, uv, direction, hit_mask, alive, tex_table, tex_index)
    out = torch.zeros((mat_id.shape[0], TEXEL_COLS), dtype=tex_data.dtype,
                      device=tex_data.device)
    zero = torch.zeros((), dtype=tex_data.dtype, device=tex_data.device)
    for s, (c0, nch) in enumerate(SLOT_COLUMNS):
        rgba = gather_rows(tex_data, flat[:, s].clamp(min=0))
        out[:, c0:c0 + nch] = torch.where(flat[:, s, None] >= 0, rgba[:, :nch], zero)
    return out
