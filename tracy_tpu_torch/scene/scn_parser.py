"""`.scn` scene-description parser, untextured subset.

Port of tracy_tpu/scene/scn_parser.py (reference Scene::Init,
src/scene.cpp:231-545). Supported tags: SCN, OUT, CAM, MTL, SKY with a
colour, and OBJ S/B/T. TEX, TRI (OBJ meshes) and textured skies raise
NotImplementedError: they belong to the textured slice.
"""

from __future__ import annotations

import re
from typing import List

import numpy as np

from tracy_tpu.utils.log import warn
from tracy_tpu_torch.core import math as tm
from tracy_tpu_torch.scene.scene import TEXTURED_SLICE, SceneBuilder

_VEC_RE = re.compile(r"\(([^)]*)\)")


def _vecs(params: str) -> List[np.ndarray]:
    """All parenthesized float tuples in the param string."""
    return [np.array([float(x) for x in m.group(1).split(",")], dtype=np.float64)
            for m in _VEC_RE.finditer(params)]


def _scalars_after_vecs(params: str) -> List[str]:
    """Tokens of the param string with parenthesized groups removed."""
    return _VEC_RE.sub(" ", params).split()


def load_scene(scn_path: str, width: int = 640, height: int = 480) -> SceneBuilder:
    """Parse a .scn file into a SceneBuilder (call .build() for tensors).

    `width`/`height` apply when the scene has no OUT tag.
    """
    builder = SceneBuilder(width=width, height=height)
    material_ids = {}

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
            elif tag == "SKY":
                vs = _vecs(params)
                if not (vs and len(vs[0]) == 3):
                    raise NotImplementedError(f"SKY {params.strip()}: {TEXTURED_SLICE}")
                builder.set_sky_color(vs[0])
            elif tag == "OBJ":
                _parse_obj_line(builder, material_ids, params)
            elif tag in ("TEX", "TRI"):
                raise NotImplementedError(f"{tag} {params.strip()}: {TEXTURED_SLICE}")
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
