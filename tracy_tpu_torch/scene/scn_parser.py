"""`.scn` scene-description parser.

Port of tracy_tpu/scene/scn_parser.py (reference Scene::Init,
src/scene.cpp:231-545). Line-oriented tags; `#` and blank lines skipped:

  SCN <name>
  OUT <width> <height>
  CAM (ex,ey,ez) (cx,cy,cz) (ux,uy,uz) <fov>
  MTL <name> (r,g,b) <roughness> <metalness> [ior] [emissive] [translucency]
  TEX <mtl> <B|N|R|M|E> <path> [SRGB]
  SKY ((r,g,b) | <path> [SRGB])
  OBJ S (center) <radius> <mtl>
  OBJ B (min) (max) [(rotation)] <mtl>
  OBJ T (v1) (v2) (v3) <mtl>
  TRI <path> <mtl> [(translation) (rotation) <scale>]

As in the JAX package, a texture or OBJ file that cannot be found or read
degrades gracefully: a warning, then a grey texel, the procedural sky, or no
mesh. Each such substitution is also recorded in `builder.fallbacks`, so a
caller can refuse a render that does not show what the scene names.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import numpy as np

from tracy_tpu_torch.core import math as tm
from tracy_tpu_torch.scene.hostmesh import HostMesh
from tracy_tpu_torch.scene.objloader_native import load_obj_fast
from tracy_tpu_torch.scene.scene import (
    TEX_BASECOLOR,
    TEX_EMISSIVE,
    TEX_METALNESS,
    TEX_NORMAL,
    TEX_ROUGHNESS,
    SceneBuilder,
)
from tracy_tpu_torch.scene.textures import fallback_sky, load_image_rgba
from tracy_tpu_torch.utils.log import log, warn

_VEC_RE = re.compile(r"\(([^)]*)\)")

_TEX_SLOT = {
    "B": TEX_BASECOLOR,
    "N": TEX_NORMAL,
    "R": TEX_ROUGHNESS,
    "M": TEX_METALNESS,
    "E": TEX_EMISSIVE,
}


def _vecs(params: str) -> List[np.ndarray]:
    """All parenthesized float tuples in the param string."""
    return [np.array([float(x) for x in m.group(1).split(",")], dtype=np.float64)
            for m in _VEC_RE.finditer(params)]


def _scalars_after_vecs(params: str) -> List[str]:
    """Tokens of the param string with parenthesized groups removed."""
    return _VEC_RE.sub(" ", params).split()


def _resolve(path: str, search_dirs: List[str]) -> Optional[str]:
    if os.path.isabs(path) and os.path.exists(path):
        return path
    for d in search_dirs:
        cand = os.path.join(d, path)
        if os.path.exists(cand):
            return cand
    return None


def load_scene(scn_path: str, data_root: Optional[str] = None, width: int = 640,
               height: int = 480) -> SceneBuilder:
    """Parse a .scn file into a SceneBuilder (call .build() for tensors).

    Relative texture and OBJ paths are looked up in `data_root` (if given),
    the working directory, the scene's directory and its two parents.
    `width`/`height` apply when the scene has no OUT tag.
    """
    scn_dir = os.path.dirname(os.path.abspath(scn_path))
    search_dirs = [os.getcwd(), scn_dir, os.path.dirname(scn_dir),
                   os.path.dirname(os.path.dirname(scn_dir))]
    if data_root:
        search_dirs.insert(0, data_root)

    builder = SceneBuilder(width=width, height=height)
    material_ids = {}  # name -> id (reference material_id map)
    texture_ids = {}  # path -> atlas id (reference texture_id map)

    def load_texture(file_name: str, srgb: bool, for_sky: bool = False) -> int:
        if file_name in texture_ids:
            return texture_ids[file_name]
        resolved = _resolve(file_name, search_dirs)
        img = load_image_rgba(resolved) if resolved else None
        if img is None:
            warn(f"texture '{file_name}' not found; using procedural fallback")
            builder.fallbacks.append(f"texture {file_name}")
            img = fallback_sky() if for_sky else np.full((1, 1, 4), 0.5, np.float32)
            srgb = False
        tid = builder.add_texture(img, srgb=srgb)
        texture_ids[file_name] = tid
        return tid

    with open(scn_path, "r") as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.strip().split(None, 1)
            if len(parts) < 2 or len(parts[0]) != 3:
                continue
            tag, params = parts[0], parts[1]

            if tag == "SCN":
                builder.name = params.strip()
            elif tag == "OUT":
                toks = params.split()
                if len(toks) >= 2:
                    builder.width, builder.height = int(toks[0]), int(toks[1])
            elif tag == "CAM":
                vs = _vecs(params)
                sc = _scalars_after_vecs(params)
                if len(vs) >= 3 and sc:
                    builder.set_camera(eye=vs[0], center=vs[1], up=vs[2],
                                       fov_degrees=float(sc[0]))
            elif tag == "MTL":
                vs = _vecs(params)
                sc = _scalars_after_vecs(params)
                if len(vs) >= 1 and len(sc) >= 3:
                    nums = [float(x) for x in sc[1:]]
                    roughness, metalness = nums[0], nums[1]
                    ior = nums[2] if len(nums) > 2 else 1.0
                    emissive = nums[3] if len(nums) > 3 else 0.0
                    translucency = nums[4] if len(nums) > 4 else 0.0
                    material_ids[sc[0]] = builder.add_material(
                        vs[0], roughness, metalness, ior, emissive, translucency)
            elif tag == "TEX":
                toks = params.split()
                if len(toks) >= 3:
                    mtl, tex_type, file_name = toks[0], toks[1], toks[2]
                    srgb = len(toks) >= 4 and toks[3].startswith("SRGB")
                    slot = _TEX_SLOT.get(tex_type)
                    if slot is None or mtl not in material_ids:
                        warn(f"TEX line skipped: {line.strip()}")
                        continue
                    tid = load_texture(file_name, srgb)
                    builder.set_material_texture(material_ids[mtl], slot, tid)
            elif tag == "SKY":
                vs = _vecs(params)
                if vs and len(vs[0]) == 3:
                    builder.set_sky_color(vs[0])
                else:
                    toks = params.split()
                    srgb = len(toks) >= 2 and toks[1].startswith("SRGB")
                    builder.set_sky_texture(load_texture(toks[0], srgb, for_sky=True))
            elif tag == "OBJ":
                _parse_obj_line(builder, material_ids, params)
            elif tag == "TRI":
                _parse_tri_line(builder, material_ids, params, search_dirs)
            else:
                warn(f"unsupported: {line.strip()}")

    return builder


def _parse_obj_line(builder: SceneBuilder, material_ids, params: str):
    obj_type = params[0]
    sub = params[1:].strip()
    vs = _vecs(sub)
    sc = _scalars_after_vecs(sub)

    def mat(name: str) -> int:
        # The reference inserts 0 for unknown names (operator[]); warn too.
        if name not in material_ids:
            warn(f"unknown material '{name}', using sky slot 0")
            return 0
        return material_ids[name]

    if obj_type == "S" and len(vs) >= 1 and len(sc) >= 2:
        builder.add_sphere(vs[0], float(sc[0]), mat(sc[1]))
    elif obj_type == "B" and len(vs) >= 2 and len(sc) >= 1:
        transform = None
        if len(vs) >= 3:
            # Rotation about the box center (scene.cpp:421-428).
            center = (vs[0] + vs[1]) * 0.5
            rot = vs[2]
            transform = (
                tm.translate(center)
                @ tm.rotate_axis(tm.radians(rot[0]), (1, 0, 0))
                @ tm.rotate_axis(tm.radians(rot[1]), (0, 1, 0))
                @ tm.rotate_axis(tm.radians(rot[2]), (0, 0, 1))
                @ tm.translate(-center)
            )
        builder.add_box(vs[0], vs[1], mat(sc[0]), transform)
    elif obj_type == "T" and len(vs) >= 3 and len(sc) >= 1:
        builder.add_triangle(vs[0], vs[1], vs[2], mat(sc[0]))
    else:
        warn(f"OBJ line not understood: {params}")


def _parse_tri_line(builder: SceneBuilder, material_ids, params: str, search_dirs):
    vs = _vecs(params)
    sc = _scalars_after_vecs(params)
    if len(sc) < 2:
        warn(f"TRI line not understood: {params}")
        return
    file_name, mat_name = sc[0], sc[1]
    translation = vs[0] if len(vs) >= 1 else np.zeros(3)
    rotation = vs[1] if len(vs) >= 2 else np.zeros(3)
    scaling = float(sc[2]) if len(sc) >= 3 else 1.0

    # Reference transform order (scene.cpp:478-483): M = Rx Ry Rz T S (the
    # translation is rotated; the scale applies to the raw vertex first).
    transform = (
        tm.rotate_axis(tm.radians(rotation[0]), (1, 0, 0))
        @ tm.rotate_axis(tm.radians(rotation[1]), (0, 1, 0))
        @ tm.rotate_axis(tm.radians(rotation[2]), (0, 0, 1))
        @ tm.translate(translation)
        @ tm.scale(scaling)
    )

    mat_id = material_ids.get(mat_name)
    if mat_id is None:
        warn(f"unknown material '{mat_name}', using sky slot 0")
        mat_id = 0

    resolved = _resolve(file_name, search_dirs)
    if resolved is None:
        warn(f"OBJ file '{file_name}' not found; skipping TRI")
        builder.fallbacks.append(f"mesh {file_name}")
        return

    for shape in load_obj_fast(resolved):
        mesh = HostMesh(positions=shape.positions, indices=shape.indices,
                        normals=shape.normals, uvs=shape.uvs)
        builder.add_mesh(mesh, mat_id, transform=transform,
                         compute_normals=shape.recompute_normals)
    log(f"loaded TRI mesh '{file_name}'")


def default_scene(width: int = 640, height: int = 480) -> SceneBuilder:
    """Built-in scene: a grey sphere and a glossy metal sphere on a plane
    under a lit sky (tracy_tpu's default_scene)."""
    b = SceneBuilder(width=width, height=height, name="Default")
    b.set_camera(eye=(0.0, 1.0, 4.0), center=(0.0, 0.5, 0.0), up=(0.0, 1.0, 0.0),
                 fov_degrees=60.0)
    b.set_sky_color((0.7, 0.8, 1.0))
    grey = b.add_material((0.5, 0.5, 0.5), roughness=1.0, metalness=0.0)
    metal = b.add_material((0.95, 0.93, 0.88), roughness=0.1, metalness=1.0)
    floor = b.add_material((0.3, 0.3, 0.3), roughness=1.0, metalness=0.0)
    b.add_sphere((-0.7, 0.5, 0.0), 0.5, grey)
    b.add_sphere((0.7, 0.5, 0.0), 0.5, metal)
    b.add_box((-20.0, -0.2, -20.0), (20.0, 0.0, 20.0), floor)
    return b


def sphere_grid(width: int, height: int, nsph: int = 64, steps: int = 28) -> SceneBuilder:
    """default_scene plus a square grid of `nsph` UV spheres (radius 1,
    `steps` tessellation steps), the loop of tools/tpu_bigscene.py.

    nsph=64, steps=28 is the `grid64x28` scene: 100,748 triangles, the
    dragon's scale, built from nothing outside the repository.
    """
    b = default_scene(width, height)
    g = int(np.ceil(np.sqrt(nsph)))
    for i in range(nsph):
        b.add_sphere((i % g * 2.5 - g, 0.5, i // g * 2.5 - g), 1.0,
                     1 + (i % 3), steps=steps)
    return b
