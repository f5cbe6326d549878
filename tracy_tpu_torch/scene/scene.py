"""Scene container: host-side builder -> flat tensors on one device.

Port of tracy_tpu/scene/scene.py. The scene is a global triangle soup with a
shared vertex buffer, a SoA material table, a flat texture atlas
(scene/textures.py) and the camera. Material slot 0 is the sky (reference
scene.h:21); its emissive texture slot holds the equirect sky.

`SceneBuilder.build()` puts the tensors on the card unless the caller asks
for the CPU (`build(device="cpu")`).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from tracy_tpu_torch.core.camera import Camera
from tracy_tpu_torch.scene import tessellate
from tracy_tpu_torch.scene.hostmesh import HostMesh
from tracy_tpu_torch.scene.textures import TextureAtlas
from tracy_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from tracy_tpu_torch.utils.log import log

SKY_MATERIAL_ID = 0
# Texture slot order matches reference Material::TextureID (material.h:17).
TEX_BASECOLOR, TEX_NORMAL, TEX_ROUGHNESS, TEX_METALNESS, TEX_EMISSIVE = range(5)
NUM_TEX_SLOTS = 5


@dataclasses.dataclass
class HostMaterial:
    """Host-side material record (reference Material, material.h:103-117).

    `emissive` is premultiplied by albedo, like the reference constructor.
    """

    albedo: np.ndarray
    roughness: float = 1.0
    metalness: float = 0.0
    ior: float = 1.0
    emissive_multiplier: float = 0.0
    translucency: float = 0.0
    textures: np.ndarray = None  # [5] int, -1 = unset

    def __post_init__(self):
        self.albedo = np.asarray(self.albedo, dtype=np.float64).reshape(3)
        if self.textures is None:
            self.textures = np.full((NUM_TEX_SLOTS,), -1, dtype=np.int32)

    @property
    def emissive(self) -> np.ndarray:
        return self.emissive_multiplier * self.albedo


@dataclasses.dataclass
class MaterialTable:
    """SoA material parameters on device."""

    albedo: torch.Tensor  # [M, 3]
    roughness: torch.Tensor  # [M]
    metalness: torch.Tensor  # [M]
    ior: torch.Tensor  # [M]
    emissive: torch.Tensor  # [M, 3] (premultiplied)
    translucent: torch.Tensor  # [M]
    tex_index: torch.Tensor  # [M, 5] int32, -1 = none

    @property
    def num_materials(self) -> int:
        return self.albedo.shape[0]


@dataclasses.dataclass
class SceneArrays:
    """The complete scene as tensors on one device (global triangle soup)."""

    vertex_pos: torch.Tensor  # [V, 3] f32
    vertex_normal: torch.Tensor  # [V, 3] f32
    vertex_uv: torch.Tensor  # [V, 2] f32
    vertex_tangent: torch.Tensor  # [V, 3] f32
    indices: torch.Tensor  # [T, 3] int32
    tri_material: torch.Tensor  # [T] int32
    materials: MaterialTable
    tex_data: torch.Tensor  # [P, 4] f32 atlas (one white texel if none)
    tex_table: torch.Tensor  # [K, 4] int32 (offset, width, height, 0)
    camera: Camera
    width: int = 640
    height: int = 480
    name: str = ""
    # Per-object contiguous ranges into the global soup, ((start, count),
    # ...) over triangles and vertices: the object structure the two-level
    # BVH (accel/tlas.py) builds on, as tracy_tpu's SceneArrays carries it.
    object_tri_ranges: tuple = ()
    object_vert_ranges: tuple = ()

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0]

    @property
    def num_vertices(self) -> int:
        return self.vertex_pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vertex_pos.device

    def triangle_vertices(self):
        """The three corner positions of every triangle: 3x [T, 3]."""
        idx = self.indices.long()
        return tuple(self.vertex_pos[idx[:, c]] for c in range(3))

    def to(self, device) -> "SceneArrays":
        """This scene with every tensor (materials and camera too) on
        `device`; the scene itself when it is there already."""
        device = resolve_device(device)
        if device == self.device:
            return self
        return _move(self, device)


def _move(obj, device):
    """A copy of dataclass `obj` with its tensors, and those of the
    dataclasses it holds, on `device`."""
    def one(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        return _move(x, device) if dataclasses.is_dataclass(x) else x

    return dataclasses.replace(obj, **{f.name: one(getattr(obj, f.name))
                                       for f in dataclasses.fields(obj)})


class SceneBuilder:
    """Host-side scene assembly (reference Scene::AddSphere/AddBox/AddTriangle/
    AddMesh/AddTexture, scene.h:24-32).

    `fallbacks` lists every texture or mesh file the parser could not load
    and replaced (a grey texel, the procedural sky) or skipped, as the JAX
    package does; a caller that must not render a substitute checks it.
    """

    def __init__(self, width: int = 640, height: int = 480, name: str = ""):
        self.width = width
        self.height = height
        self.name = name
        self.meshes: List[HostMesh] = []
        # Slot 0 = sky (default: black emissive), like the reference.
        self.materials: List[HostMaterial] = [HostMaterial(albedo=np.zeros(3))]
        self.atlas = TextureAtlas()
        self.fallbacks: List[str] = []
        self.camera_params = dict(
            eye=(0.0, 0.0, 1.0), center=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0), fov_degrees=60.0
        )

    def set_camera(self, eye, center, up, fov_degrees: float):
        self.camera_params = dict(eye=eye, center=center, up=up, fov_degrees=fov_degrees)
        return self

    @property
    def num_objects(self) -> int:
        return len(self.meshes)

    @property
    def num_triangles(self) -> int:
        return sum(m.num_triangles for m in self.meshes)

    @property
    def has_translucent(self) -> bool:
        """Any BTDF material: its rays refract through and survive Russian
        roulette for all bounces, so the waves stay dense
        (accel/reorder.py::pick_compact_group)."""
        return any(m.translucency > 0.0 for m in self.materials)

    def add_material(self, albedo, roughness=1.0, metalness=0.0, ior=1.0,
                     emissive=0.0, translucency=0.0) -> int:
        self.materials.append(
            HostMaterial(albedo, roughness, metalness, ior, emissive, translucency)
        )
        return len(self.materials) - 1

    def add_texture(self, image: np.ndarray, srgb: bool = False) -> int:
        return self.atlas.add(image, srgb=srgb)

    def set_material_texture(self, material_id: int, slot: int, texture_id: int):
        self.materials[material_id].textures[slot] = texture_id
        return self

    def set_sky_color(self, albedo):
        """SKY constant: Material(albedo, 0, 0, 0, 1) per scene.cpp:368."""
        sky = HostMaterial(albedo, roughness=0.0, metalness=0.0, ior=0.0,
                           emissive_multiplier=1.0)
        sky.textures = self.materials[SKY_MATERIAL_ID].textures
        self.materials[SKY_MATERIAL_ID] = sky
        return self

    def set_sky_texture(self, texture_id: int):
        self.materials[SKY_MATERIAL_ID].textures[TEX_EMISSIVE] = texture_id
        return self

    def _add(self, mesh: HostMesh, material_id: int) -> HostMesh:
        mesh.material_id = material_id
        self.meshes.append(mesh)
        return mesh

    def add_sphere(self, center, radius, material_id: int, steps: int = 32) -> HostMesh:
        return self._add(tessellate.sphere(center, radius, steps), material_id)

    def add_box(self, bottom, top, material_id: int, transform=None) -> HostMesh:
        return self._add(tessellate.box(bottom, top, transform), material_id)

    def add_triangle(self, v1, v2, v3, material_id: int) -> HostMesh:
        return self._add(tessellate.triangle(v1, v2, v3), material_id)

    def add_mesh(self, mesh: HostMesh, material_id: int, transform=None,
                 compute_normals: bool = False) -> HostMesh:
        """Mirrors Scene::AddMesh (scene.cpp:224-229): transform, bbox, then
        (optionally) flat normals, then tangents."""
        if transform is not None:
            mesh.transform(transform)
        mesh.compute_bounding_box()
        if compute_normals:
            mesh.compute_normals()
        mesh.compute_tangents()
        return self._add(mesh, material_id)

    def build(self, device=DEFAULT_DEVICE) -> SceneArrays:
        """Flatten into tensors on `device` (float32 / int32): the card by
        default; raises if there is none. Pass device="cpu" for the CPU."""
        device = resolve_device(device)
        tri_ranges, vert_ranges = [], []
        if self.meshes:
            pos, nrm, uv, tan, idx, mat = [], [], [], [], [], []
            voffset = toffset = 0
            for m in self.meshes:
                if m.tangents is None:
                    m.compute_tangents()
                pos.append(m.positions)
                nrm.append(m.normals)
                uv.append(m.uvs)
                tan.append(m.tangents)
                idx.append(m.indices.astype(np.int64) + voffset)
                mid = m.material_id if m.material_id >= 0 else 0
                mat.append(np.full((m.num_triangles,), mid, dtype=np.int32))
                tri_ranges.append((toffset, m.num_triangles))
                vert_ranges.append((voffset, m.num_vertices))
                voffset += m.num_vertices
                toffset += m.num_triangles
            pos, nrm, uv, tan = (np.concatenate(a) for a in (pos, nrm, uv, tan))
            idx = np.concatenate(idx).astype(np.int32)
            mat = np.concatenate(mat)
        else:
            # Degenerate placeholder triangle keeps shapes non-empty.
            pos = np.zeros((3, 3))
            nrm = np.tile(np.array([[0.0, 0.0, 1.0]]), (3, 1))
            uv = np.zeros((3, 2))
            tan = np.tile(np.array([[1.0, 0.0, 0.0]]), (3, 1))
            idx = np.array([[0, 1, 2]], dtype=np.int32)
            mat = np.zeros((1,), dtype=np.int32)

        mats = self.materials
        arrays = dict(
            vertex_pos=pos, vertex_normal=nrm, vertex_uv=uv, vertex_tangent=tan,
            indices=idx, tri_material=mat,
            mat_albedo=np.stack([m.albedo for m in mats]),
            mat_roughness=[m.roughness for m in mats],
            mat_metalness=[m.metalness for m in mats],
            mat_ior=[m.ior for m in mats],
            mat_emissive=np.stack([m.emissive for m in mats]),
            mat_translucent=[m.translucency for m in mats],
            mat_tex_index=np.stack([m.textures for m in mats]),
        )
        arrays["tex_data"], arrays["tex_table"] = self.atlas.pack()
        log("scene '%s': %d objects, %d tris, %d verts, %d materials, %d textures"
            % (self.name, self.num_objects, len(idx), len(pos), len(mats),
               len(self.atlas)))
        camera = Camera.setup(
            aspect_ratio=float(self.width) / float(max(self.height, 1)),
            device=device, **self.camera_params)
        return _scene_from_arrays(arrays, camera, self.width, self.height,
                                  self.name, device, tuple(tri_ranges), tuple(vert_ranges))


def _scene_from_arrays(a: dict, camera: Camera, width: int, height: int,
                       name: str, device, tri_ranges: tuple = (),
                       vert_ranges: tuple = ()) -> SceneArrays:
    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    def i32(x):
        return torch.tensor(np.asarray(x, np.int32), device=device)

    return SceneArrays(
        vertex_pos=f32(a["vertex_pos"]),
        vertex_normal=f32(a["vertex_normal"]),
        vertex_uv=f32(a["vertex_uv"]),
        vertex_tangent=f32(a["vertex_tangent"]),
        indices=i32(a["indices"]),
        tri_material=i32(a["tri_material"]),
        materials=MaterialTable(
            albedo=f32(a["mat_albedo"]),
            roughness=f32(a["mat_roughness"]),
            metalness=f32(a["mat_metalness"]),
            ior=f32(a["mat_ior"]),
            emissive=f32(a["mat_emissive"]),
            translucent=f32(a["mat_translucent"]),
            tex_index=i32(a["mat_tex_index"]),
        ),
        tex_data=f32(a["tex_data"]),
        tex_table=i32(a["tex_table"]),
        camera=camera,
        width=width,
        height=height,
        name=name,
        object_tri_ranges=tri_ranges,
        object_vert_ranges=vert_ranges,
    )


def from_jax_arrays(src, device=DEFAULT_DEVICE) -> SceneArrays:
    """The port's SceneArrays from a tracy_tpu SceneArrays, textures and
    all, on the card by default (device="cpu" for the CPU).

    `src` is read only through numpy (np.asarray of its fields), so this
    module needs no jax; a test can hand both packages the very same scene.
    """
    device = resolve_device(device)
    m, cam = src.materials, src.camera
    a = dict(
        vertex_pos=src.vertex_pos, vertex_normal=src.vertex_normal,
        vertex_uv=src.vertex_uv, vertex_tangent=src.vertex_tangent,
        indices=src.indices, tri_material=src.tri_material,
        mat_albedo=m.albedo, mat_roughness=m.roughness, mat_metalness=m.metalness,
        mat_ior=m.ior, mat_emissive=m.emissive, mat_translucent=m.translucent,
        mat_tex_index=m.tex_index, tex_data=src.tex_data, tex_table=src.tex_table,
    )
    a = {k: np.asarray(v) for k, v in a.items()}

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    camera = Camera(eye=f32(cam.eye), inv_view_projection=f32(cam.inv_view_projection),
                    view=f32(cam.view), projection=f32(cam.projection))
    def ranges(r):
        return tuple((int(start), int(count)) for start, count in r)

    return _scene_from_arrays(a, camera, src.width, src.height, src.name, device,
                              ranges(src.object_tri_ranges), ranges(src.object_vert_ranges))
