"""Software rasterizer: the raster preview.

Port of tracy_tpu/raster/rasterizer.py (reference CPU rasterizer,
src/kernels/raster/cpu/cpu_render.cpp:17-253): the inverse-vertex-matrix
homogeneous edge functions (Olano-Greer). Per triangle, the 3x3 matrix of
raster-space (x, y, w) columns; a triangle is culled when det >= 0; the
adjugate inverse's rows are the edge functions, normalised by |a| + |b|;
1/w and z interpolate linearly in screen space; attributes are
perspective-correct, (sample . (Minv @ attr)) * w. TriangleEval's
tie-break (cpu_render.cpp:22-43) decides a pixel on an edge through exact
`== 0.0` tests.

The JAX package computes this in XLA, with no Pallas kernel, so the port
is plain PyTorch on every device: one loop over triangle chunks, each a
[pixels, chunk] grid of edge values, with a running (depth, winner) pair;
the depth resolve comes first, then one shade per pixel. The chunk is
capped so that the grid holds at most MAX_GRID lanes (1080p x 64 is 133 M
lanes, 0.53 GB a float32 tensor, and a chunk step holds a few of them).
Where XLA evaluates every pixel of every chunk, the port evaluates only
the pixels inside the box of the chunk's front-facing triangles' projected
corners, and the whole image for a chunk with a triangle crossing the
eye's plane: the other pixels cannot be covered, so the image is the same,
and a chunk of a tessellated mesh touches a small part of a 1080p frame.

The products are mul-adds in the JAX package's order, so both packages
form the same edge values up to an ulp of XLA CPU against torch CPU; an
ulp can move a pixel on an edge (tests/test_torch_raster.py bounds that).
The fragment shader is FS (cpu_render.cpp:79-96): albedo, or an AOV view;
shaded=True is the OpenGL ubershader (opengl_render.cpp:98-231) with
bilinear textures and the equirect sky behind. Raster row 0 is the top of
the view, the image's convention.
"""

from __future__ import annotations

import numpy as np
import torch

from tracy_tpu_torch.config import RenderConfig
from tracy_tpu_torch.core import math as tm
from tracy_tpu_torch.render.integrator import sky_emission
from tracy_tpu_torch.render.material import gather_surface_params, material_table_lookup
from tracy_tpu_torch.render.texture import PI_F32
from tracy_tpu_torch.scene.scene import SceneArrays

FLT_MAX = float(np.float32(3.4028235e38))
MAX_GRID = 1 << 27  # lanes of one chunk's [pixels, chunk] grid


def _det3(m):
    """Determinant of [..., 3, 3]."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]))


def _inv3(m, det):
    """Adjugate / det inverse of [..., 3, 3]."""
    def c(i, j):
        return m[..., i, j]

    adj = torch.stack([
        torch.stack([c(1, 1) * c(2, 2) - c(1, 2) * c(2, 1),
                     c(0, 2) * c(2, 1) - c(0, 1) * c(2, 2),
                     c(0, 1) * c(1, 2) - c(0, 2) * c(1, 1)], dim=-1),
        torch.stack([c(1, 2) * c(2, 0) - c(1, 0) * c(2, 2),
                     c(0, 0) * c(2, 2) - c(0, 2) * c(2, 0),
                     c(0, 2) * c(1, 0) - c(0, 0) * c(1, 2)], dim=-1),
        torch.stack([c(1, 0) * c(2, 1) - c(1, 1) * c(2, 0),
                     c(0, 1) * c(2, 0) - c(0, 0) * c(2, 1),
                     c(0, 0) * c(1, 1) - c(0, 1) * c(1, 0)], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def _matvec3(m, v):
    """[..., 3, 3] @ [..., 3] -> [..., 3], each row summed j = 0, 1, 2."""
    return m[..., 0] * v[..., None, 0] + m[..., 1] * v[..., None, 1] + m[..., 2] * v[..., None, 2]


def _transform4(m, p):
    """[..., 3] points through a [4, 4] matrix -> [..., 4]."""
    return p[..., 0:1] * m[:, 0] + p[..., 1:2] * m[:, 1] + p[..., 2:3] * m[:, 2] + m[:, 3]


def _triangle_setup(scene: SceneArrays, width: int, height: int):
    """Per-triangle raster quantities [T, ...]: edge functions, the 1/w and
    z interpolators, the inverse vertex matrix, and the front-facing flag."""
    proj, view = scene.camera.projection, scene.camera.view
    mvp = (proj[:, 0:1] * view[0] + proj[:, 1:2] * view[1] + proj[:, 2:3] * view[2]
           + proj[:, 3:4] * view[3])
    idx = scene.indices.long()
    clip = [_transform4(mvp, scene.vertex_pos[idx[:, c]]) for c in range(3)]  # 3x [T, 4]

    def raster(v):  # (w * (x + wc) / 2, h * (wc - y) / 2), cpu_render.cpp:17-20
        return (width * (v[:, 0] + v[:, 3]) * 0.5, height * (v[:, 3] - v[:, 1]) * 0.5)

    rast = [raster(v) for v in clip]
    # m[t, vertex, (x', y', w)]: rows of the inverse are the edge functions
    # and Minv @ (1, 1, 1) interpolates 1/w (cpu_render.cpp:151-156).
    m = torch.stack([torch.stack([rast[0][0], rast[1][0], rast[2][0]], dim=-1),
                     torch.stack([rast[0][1], rast[1][1], rast[2][1]], dim=-1),
                     torch.stack([clip[0][:, 3], clip[1][:, 3], clip[2][:, 3]], dim=-1)],
                    dim=-1)
    det = _det3(m)
    front = det < 0.0  # cpu_render.cpp:158-160
    one = torch.ones((), dtype=det.dtype, device=det.device)
    minv = _inv3(m, torch.where(det.abs() > 1e-20, det, one))
    # Edge functions: the columns of Minv (cpu_render.cpp:166-171), over |a| + |b|.
    minv_t = minv.transpose(-1, -2)
    norm = minv_t[..., 0].abs() + minv_t[..., 1].abs()
    edges = minv_t / torch.clamp(norm[..., None], min=1e-30)
    c_vec = _matvec3(minv, torch.ones_like(rast[0][0])[:, None].expand(-1, 3))
    zs = torch.stack([clip[0][:, 2], clip[1][:, 2], clip[2][:, 2]], dim=-1)
    z_vec = _matvec3(minv, zs)
    # Screen boxes (x0, x1, y0, y1) of the projected corners (x'/w, y'/w).
    # A pixel p is inside when its weights l = Minv p are all >= 0, and
    # p = sum (l_i w_i) (x'_i/w_i, y'_i/w_i, 1): with every w_i > 0 the
    # products are convex weights, so p lies in the corners' box; with
    # every w_i < 0 they are <= 0 and cannot sum to 1, so no pixel is
    # inside (the box bounds that too). NaN, the whole image, where the
    # corners' w change sign or touch 0.
    wc = torch.stack([v[:, 3] for v in clip], dim=-1)
    sx = torch.stack([r[0] for r in rast], dim=-1) / wc
    sy = torch.stack([r[1] for r in rast], dim=-1) / wc
    nan = torch.full((), float("nan"), dtype=det.dtype, device=det.device)
    one_side = (wc > 0.0).all(-1, keepdim=True) | (wc < 0.0).all(-1, keepdim=True)
    boxes = torch.where(one_side,
                        torch.stack([sx.amin(-1), sx.amax(-1), sy.amin(-1), sy.amax(-1)], -1),
                        nan)
    return edges, c_vec, z_vec, minv, front, boxes


def _chunk_boxes(boxes, front, chunk: int, w: int, h: int):
    """(first triangle, (y0, y1, x0, x1)) of each chunk of `chunk`
    triangles that holds a front-facing one: the pixel rectangle outside of
    which no triangle of the chunk covers a pixel centre. A triangle whose
    corners are all on one side of the eye's plane covers only pixels
    inside its projected corners' box (_triangle_setup; widened by two
    pixels against rounding); one that crosses the plane, or whose box is
    not finite, takes the whole image. A pixel outside every triangle
    keeps its depth and winner, so skipping it changes nothing; one
    device-to-host copy for the frame."""
    n = front.shape[0]
    pad = (-n) % chunk
    inf = torch.full((), float("inf"), dtype=boxes.dtype, device=boxes.device)
    whole = torch.tensor([-2.0, w + 2.0, -2.0, h + 2.0], dtype=boxes.dtype,
                         device=boxes.device)
    b = torch.where(torch.isfinite(boxes).all(-1, keepdim=True), boxes, whole)
    lo = torch.where(front[:, None], b[:, 0::2], inf)
    hi = torch.where(front[:, None], b[:, 1::2], -inf)
    lo = torch.nn.functional.pad(lo, (0, 0, 0, pad), value=float("inf"))
    hi = torch.nn.functional.pad(hi, (0, 0, 0, pad), value=float("-inf"))
    lo = lo.view(-1, chunk, 2).amin(1).cpu().numpy()  # [chunks, (x, y)]
    hi = hi.view(-1, chunk, 2).amax(1).cpu().numpy()
    for k in range(lo.shape[0]):
        if not lo[k, 0] <= hi[k, 0]:  # no front-facing triangle
            continue
        x0 = int(min(max(np.floor(lo[k, 0]) - 2, 0), w))
        x1 = int(min(max(np.ceil(hi[k, 0]) + 2, 0), w))
        y0 = int(min(max(np.floor(lo[k, 1]) - 2, 0), h))
        y1 = int(min(max(np.ceil(hi[k, 1]) + 2, 0), h))
        if x0 < x1 and y0 < y1:
            yield k * chunk, (y0, y1, x0, x1)


def _edge_inside(a, b, value):
    """TriangleEval's tie-break (cpu_render.cpp:22-43): inside when the edge
    value is positive, or zero on an edge with a > 0, or a == 0 and b >= 0."""
    return (value > 0.0) | ((value == 0.0) & ((a > 0.0) | ((a == 0.0) & (b >= 0.0))))


def render_raster(scene: SceneArrays, cfg: RenderConfig, tri_chunk: int = 64,
                  shaded: bool = False) -> torch.Tensor:
    """Rasterise to a float image [H, W, 3] in [0, 1] on the scene's device.

    shaded=False is the CPU raster kernel's FS (albedo, or cfg.aov's view);
    shaded=True the OpenGL kernel's ubershader: textured (bilinear)
    basecolor * (1 - metalness) / pi + emissive, normal mapping, and the
    equirect sky pass as the background. tri_chunk: triangles per step of
    the depth resolve, lowered where the [pixels, chunk] grid would pass
    MAX_GRID lanes."""
    w, h = cfg.width, cfg.height
    dev = scene.device
    f32 = dict(dtype=torch.float32, device=dev)
    n_tri = scene.indices.shape[0]
    edges, c_vec, z_vec, minv, front, boxes = _triangle_setup(scene, w, h)

    # Pixel centres (x + .5, y + .5); y is the raster row, 0 at the top.
    px = (torch.arange(w, **f32) + 0.5)[None, :].expand(h, w).reshape(-1)
    py = (torch.arange(h, **f32) + 0.5)[:, None].expand(h, w).reshape(-1)
    npx = h * w
    chunk = max(1, min(tri_chunk, MAX_GRID // npx))
    big = torch.full((), FLT_MAX, **f32)
    one = torch.ones((), **f32)
    zbuf = torch.full((h, w), FLT_MAX, **f32)
    winner = torch.full((h, w), -1, dtype=torch.int64, device=dev)
    xs = torch.arange(w, **f32) + 0.5
    ys = torch.arange(h, **f32) + 0.5
    for base, (y0, y1, x0, x1) in _chunk_boxes(boxes, front, chunk, w, h):
        sl = slice(base, min(base + chunk, n_tri))
        pxc = xs[x0:x1][None, :].expand(y1 - y0, x1 - x0).reshape(-1, 1)
        pyc = ys[y0:y1][:, None].expand(y1 - y0, x1 - x0).reshape(-1, 1)
        e = edges[sl]
        inside = front[sl][None, :]
        for row in range(3):
            a, b = e[:, row, 0][None, :], e[:, row, 1][None, :]
            value = a * pxc + b * pyc + e[:, row, 2][None, :]
            inside = inside & _edge_inside(a, b, value)
        cv, zv = c_vec[sl], z_vec[sl]
        one_over_w = cv[None, :, 0] * pxc + cv[None, :, 1] * pyc + cv[None, :, 2]
        z_over_w = zv[None, :, 0] * pxc + zv[None, :, 1] * pyc + zv[None, :, 2]
        z = z_over_w / torch.where(one_over_w.abs() > 1e-30, one_over_w, one)
        z = torch.where(inside, z, big)
        best_z, best = torch.min(z, dim=-1)
        # The reference's depth test is z <= depth; uncovered lanes carry
        # FLT_MAX and never win.
        zb = zbuf[y0:y1, x0:x1].reshape(-1)
        better = (best_z <= zb) & (best_z < FLT_MAX)
        zbuf[y0:y1, x0:x1] = torch.where(better, best_z, zb).view(y1 - y0, x1 - x0)
        wb = winner[y0:y1, x0:x1].reshape(-1)
        winner[y0:y1, x0:x1] = torch.where(better, base + best, wb).view(y1 - y0, x1 - x0)
    zbuf, winner = zbuf.reshape(-1), winner.reshape(-1)

    hit = winner >= 0
    tri = torch.clamp(winner, min=0)
    sample = torch.stack([px, py, torch.ones_like(px)], dim=-1)  # [P, 3]
    mi = minv[tri]
    cw = c_vec[tri]
    one_over_w = cw[:, 0] * sample[:, 0] + cw[:, 1] * sample[:, 1] + cw[:, 2] * sample[:, 2]
    frag_w = 1.0 / torch.where(one_over_w.abs() > 1e-30, one_over_w, one)
    idx = scene.indices.long()[tri]

    def interp(attr):  # [V, K] -> [P, K]
        corners = torch.stack([attr[idx[:, 0]], attr[idx[:, 1]], attr[idx[:, 2]]], dim=-1)
        pv = _matvec3(mi[:, None], corners)  # [P, K, 3]: Minv @ corners per component
        s = pv[..., 0] * sample[:, None, 0] + pv[..., 1] * sample[:, None, 1] \
            + pv[..., 2] * sample[:, None, 2]
        return s * frag_w[:, None]

    mat_id = scene.tri_material[tri]
    albedo, rough, metal, _ior, emis, _tr = material_table_lookup(scene.materials, mat_id)
    aov = cfg.aov
    if aov == "normals":
        color = tm.normalize(interp(scene.vertex_normal)) * 0.5 + 0.5
    elif aov == "metalness":
        color = metal[:, None].expand(npx, 3)
    elif aov == "roughness":
        color = rough[:, None].expand(npx, 3)
    elif aov == "emissive":
        color = emis
    elif aov == "depth":
        color = torch.where(hit, zbuf, torch.zeros((), **f32))[:, None].expand(npx, 3)
    elif shaded:
        nrm = interp(scene.vertex_normal)
        params = gather_surface_params(scene, mat_id, interp(scene.vertex_uv)[:, :2], nrm,
                                       interp(scene.vertex_tangent), None, hit,
                                       tex_filter="bilinear")
        diffuse = params.basecolor * (1.0 - params.metalness[:, None])
        color = diffuse / torch.full((), PI_F32, **f32) + params.emissive
    else:  # beauty, basecolor: FS returns the albedo (cpu_render.cpp:94)
        color = albedo

    if shaded and aov != "depth":
        # The sky pass: the equirect emissive along each pixel's un-projected
        # view ray (opengl_render.cpp:178-231).
        s = (torch.arange(w, **f32) + 0.5) / torch.full((), w, **f32)
        t = 1.0 - (torch.arange(h, **f32) + 0.5) / torch.full((), h, **f32)
        _, view_dir = scene.camera.generate_rays(s[None, :].expand(h, w).reshape(-1),
                                                 t[:, None].expand(h, w).reshape(-1))
        color = torch.where(hit[:, None], color, sky_emission(scene, view_dir))
    else:
        color = torch.where(hit[:, None], color, torch.zeros((), **f32))
    return torch.clamp(color, 0.0, 1.0).reshape(h, w, 3)
