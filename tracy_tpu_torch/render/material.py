"""Material lookup, textures and scatter: the Unreal-ish BRDF/BTDF.

Port of tracy_tpu/render/material.py (reference Material::Scatter,
src/material.h:210-268, and the textured parameter getters,
material.h:164-203), branch-free over all lanes:

* spec direction = lerp(reflect, normal + unit_sphere_sample, roughness);
* BRDF: specular chance = lerp(lerp(.1, 1, metalness), 1,
  (1-roughness) * schlick(-VdotN, 1)); specular colour = lerp(0.85,
  basecolor, metalness); diffuse = normal + unit sphere sample;
* BTDF (translucent > EPS): inside test VdotN > EPS, Snell cosine, eta
  swap, refraction lerped to the diffuse sample by roughness, Schlick
  choosing reflection or transmission, attenuation basecolor;
* the new origin is offset by RAY_OFFSET along the new direction;
* a textured slot overrides its parameter; a normal map perturbs the
  shading normal through the interpolated, unnormalised tangent (a
  reference quirk kept by the JAX package);
* gather_surface_params reads a lane's parameters (the first-hit AOVs,
  render/integrator.py::trace_aov): on CUDA tensors its texel rows come
  from K3 (ops/texfetch.py), unless the caller passes another fetch:
  diff/gradients.py::render_loss passes the plain gather, which carries
  the gradient to the texels.

On total internal reflection the Snell cosine is clamped to 0, so the ray
reflects (the JAX package's deliberate, NaN-free divergence from the
reference). Powers are explicit products, in the order jax.lax.integer_pow
multiplies, so that both packages round alike.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tracy_tpu_torch.core import math as tm
from tracy_tpu_torch.ops.texfetch import fetch_texels
from tracy_tpu_torch.render.texture import SLOT_COLUMNS
from tracy_tpu_torch.scene.scene import (
    TEX_BASECOLOR,
    TEX_EMISSIVE,
    TEX_METALNESS,
    TEX_NORMAL,
    TEX_ROUGHNESS,
)

RAY_OFFSET = 1.0e-3  # kRayOffset, material.h:213
EPS = tm.EPS


class SurfaceParams(NamedTuple):
    basecolor: torch.Tensor  # [N, 3]
    roughness: torch.Tensor  # [N]
    metalness: torch.Tensor  # [N]
    ior: torch.Tensor  # [N]
    emissive: torch.Tensor  # [N, 3]
    translucent: torch.Tensor  # [N]
    normal: torch.Tensor  # [N, 3] shading normal


class ScatterResult(NamedTuple):
    origin: torch.Tensor
    direction: torch.Tensor
    attenuation: torch.Tensor
    emission: torch.Tensor


def schlick(cos, ref_idx):
    """material.h:137-142: r0 + (1 - r0) (1 - cos)^5."""
    r = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r * r
    c = 1.0 - cos
    c2 = c * c
    return r0 + (1.0 - r0) * (c * (c2 * c2))


def random_on_unit_sphere(r1, r2):
    """material.h:144-157: r1 -> z, r2 -> phi."""
    z = 2.0 * r1 - 1.0
    phi = 2.0 * tm.PI * r2
    r = tm.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def material_table_lookup(materials, mat_id):
    """Material rows for [N] ids: (albedo, roughness, metalness, ior,
    emissive, translucent). A gather: cheap on a GPU, exact everywhere."""
    i = mat_id.long()
    m = materials
    return tuple(tm.gather_rows(x, i) for x in (m.albedo, m.roughness, m.metalness, m.ior,
                                                m.emissive, m.translucent))


def scene_has_textures(scene) -> bool:
    """tracy_tpu's static check, quirk and all: the atlas placeholder is a
    single texel, so a scene whose only texture is 1x1 counts as untextured."""
    return scene.tex_data.shape[0] > 1


def apply_textures(params: SurfaceParams, texels, has, tangent) -> SurfaceParams:
    """The textured branch of tracy_tpu's gather_surface_params
    (material.h:164-203), on texel rows that K3 (ops/texfetch.py) fetched.

    texels: [N, TEXEL_COLS] rows (render/texture.py layout); has: [N, 5] bool,
    slot present (TEX_* order); tangent: [N, 3] interpolated, unnormalised.
    Normal mapping: tbn columns = [bitangent, RAW tangent, shading normal]
    with bitangent = cross(N, normalize(T - dot(T, N) N)).
    """
    def col(slot):
        return texels[:, SLOT_COLUMNS[slot][0]]

    def rgb(slot):
        return texels[:, SLOT_COLUMNS[slot][0]:SLOT_COLUMNS[slot][0] + 3]

    n = params.normal
    n_tex = rgb(TEX_NORMAL) * 2.0 - 1.0
    t_ortho = tm.normalize(tangent - tm.dot(tangent, n) * n)
    bitangent = tm.cross(n, t_ortho)
    mapped = tm.normalize(bitangent * n_tex[:, 0:1] + tangent * n_tex[:, 1:2]
                          + n * n_tex[:, 2:3])
    return SurfaceParams(
        basecolor=torch.where(has[:, TEX_BASECOLOR, None], rgb(TEX_BASECOLOR),
                              params.basecolor),
        roughness=torch.where(has[:, TEX_ROUGHNESS], col(TEX_ROUGHNESS),
                              params.roughness),
        metalness=torch.where(has[:, TEX_METALNESS], col(TEX_METALNESS),
                              params.metalness),
        ior=params.ior,
        emissive=torch.where(has[:, TEX_EMISSIVE, None], rgb(TEX_EMISSIVE),
                             params.emissive),
        translucent=params.translucent,
        normal=torch.where(has[:, TEX_NORMAL, None], mapped, n),
    )


def gather_surface_params(scene, mat_id, uv, shading_normal, tangent, direction, hit_mask,
                          fetch_fn=None) -> SurfaceParams:
    """Surface parameters of [N] lanes (tracy_tpu's gather_surface_params,
    material.h:164-203), nearest texel filtering only.

    mat_id [N] int32; uv [N, 2] interpolated texture uv, or None when the
    intersector carries none (no material but the sky is textured);
    shading_normal [N, 3]; tangent [N, 3] interpolated, unnormalised, or
    None (read as zero); direction [N, 3] and hit_mask [N] bool, which say
    which lanes read their material's texels (only hit lanes do: a miss
    lane's parameters are never read). fetch_fn: the texel fetch,
    (mat_id, uv, direction, hit_mask, alive, tex_data, tex_table,
    tex_index) -> [N, TEXEL_COLS]. None picks K3's wrapper (the kernel on
    CUDA tensors, its plain version on CPU ones). K3 has no backward, so
    the differentiable route (diff/gradients.py::render_loss) passes the
    plain gather, which is differentiable in the texel values.
    """
    m = scene.materials
    albedo, rough, metal, ior, emis, transl = material_table_lookup(m, mat_id)
    params = SurfaceParams(basecolor=albedo, roughness=rough, metalness=metal, ior=ior,
                           emissive=emis, translucent=transl, normal=shading_normal)
    if not scene_has_textures(scene):
        return params
    if fetch_fn is None:
        fetch_fn = fetch_texels
    texels = fetch_fn(mat_id, uv, direction, hit_mask, hit_mask, scene.tex_data,
                      scene.tex_table, m.tex_index)
    mat = mat_id.long()
    has = m.tex_index[torch.where((mat >= 0) & (mat < m.tex_index.shape[0]), mat, 0)] >= 0
    if tangent is None:
        tangent = torch.zeros_like(shading_normal)
    return apply_textures(params, texels, has, tangent)


def scatter(ray_dir, hit_point, params: SurfaceParams, u_sphere_z, u_sphere_phi,
            u_spec) -> ScatterResult:
    """Branch-free Material::Scatter over all lanes at once."""
    normal = params.normal
    roughness = params.roughness[:, None]
    v_dot_n = tm.dot(ray_dir, normal)[..., 0]

    scattered = normal + random_on_unit_sphere(u_sphere_z, u_sphere_phi)
    specular = tm.lerp(tm.reflect(ray_dir, normal), scattered, roughness)

    # BTDF (material.h:236-249)
    inside = v_dot_n > EPS
    ior = params.ior
    cos_in = tm.sqrt(torch.clamp(1.0 - (ior * ior) * (1.0 - v_dot_n * v_dot_n), min=0.0))
    cosine = torch.where(inside, cos_in, -v_dot_n)
    eta = torch.where(inside, ior, 1.0 / torch.clamp(ior, min=1e-8))
    transmitted = tm.lerp(tm.refract(ray_dir, normal, eta[:, None]), scattered, roughness)
    btdf_is_spec = u_spec < schlick(cosine, eta)
    btdf_dir = torch.where(btdf_is_spec[:, None], specular, transmitted)

    # BRDF (material.h:250-261)
    metalness = params.metalness
    specularcolor = tm.lerp(torch.full_like(params.basecolor, 0.85), params.basecolor,
                            metalness[:, None])
    mat_spec_chance = 0.1 + (1.0 - 0.1) * metalness
    fresnel = (1.0 - params.roughness) * schlick(-v_dot_n, 1.0)
    spec_chance = mat_spec_chance + (1.0 - mat_spec_chance) * fresnel
    brdf_is_spec = u_spec < spec_chance
    brdf_dir = torch.where(brdf_is_spec[:, None], specular, scattered)
    brdf_atten = torch.where(brdf_is_spec[:, None], specularcolor, params.basecolor)

    translucent = params.translucent[:, None] > EPS
    direction = tm.normalize(torch.where(translucent, btdf_dir, brdf_dir))
    attenuation = torch.where(translucent, params.basecolor, brdf_atten)
    return ScatterResult(origin=hit_point + RAY_OFFSET * direction,
                         direction=direction, attenuation=attenuation,
                         emission=params.emissive)
