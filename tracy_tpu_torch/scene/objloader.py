"""Wavefront OBJ loading.

A numpy copy of tracy_tpu/scene/objloader.py, which replaces the
reference's tiny_obj_loader + per-index dedup remap (src/scene.cpp:458-530):

* shapes split on `o`/`g` statements (tinyobj behavior), each shape becoming
  its own mesh;
* polygon faces triangulated as a fan;
* the dedup remap keys on the *position* index only: a position shared by
  face-vertices with different normals/uvs keeps the attributes of its
  first occurrence;
* `recompute_normals` is true for a shape iff no face-vertex referenced a
  normal (scene.cpp:489,505-507).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class ObjShape:
    name: str
    positions: np.ndarray  # [V, 3] deduped by position index
    normals: Optional[np.ndarray]  # [V, 3] or None if none referenced
    uvs: Optional[np.ndarray]  # [V, 2] or None
    indices: np.ndarray  # [F, 3] int32 into positions
    has_normals: bool = False

    @property
    def recompute_normals(self) -> bool:
        return not self.has_normals


def load_obj(path: str) -> List[ObjShape]:
    v_chunks: List[str] = []
    vn_chunks: List[str] = []
    vt_chunks: List[str] = []
    shapes: List[tuple] = []  # (name, faces: List[List[str]])
    cur_faces: List[List[str]] = []
    cur_name = ""

    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                v_chunks.append(line[2:])
            elif line.startswith("f "):
                cur_faces.append(line[2:].split())
            elif line.startswith("vn "):
                vn_chunks.append(line[3:])
            elif line.startswith("vt "):
                vt_chunks.append(line[3:])
            elif line.startswith(("o ", "g ")):
                if cur_faces:
                    shapes.append((cur_name, cur_faces))
                    cur_faces = []
                cur_name = line[2:].strip()
    if cur_faces:
        shapes.append((cur_name, cur_faces))

    positions = _parse_floats(v_chunks, 3)
    normals = _parse_floats(vn_chunks, 3)
    uvs = _parse_floats(vt_chunks, 2)
    return [_build_shape(name, faces, positions, normals, uvs) for name, faces in shapes]


def _parse_floats(chunks: List[str], width: int) -> np.ndarray:
    if not chunks:
        return np.zeros((0, width))
    flat = np.array(" ".join(chunks).split(), dtype=np.float64)
    # Some exporters write `vt u v w`; trim to the expected width per row.
    if flat.size % width != 0:
        rows = [np.array(c.split(), dtype=np.float64)[:width] for c in chunks]
        return np.stack(rows)
    return flat.reshape(-1, width)


def shape_from_flat(name, vi, ti, ni, positions, normals, uvs) -> ObjShape:
    """Build a deduped ObjShape from flat 0-based corner index arrays
    (-1 = attribute absent). Shared by the Python and native loaders."""
    vi = np.asarray(vi, dtype=np.int64)
    ni = np.asarray(ni, dtype=np.int64)
    ti = np.asarray(ti, dtype=np.int64)

    has_normals = bool((ni >= 0).any())

    # Dedup on position index only, first occurrence wins (reference quirk).
    uniq, first, inverse = np.unique(vi, return_index=True, return_inverse=True)
    out_pos = positions[uniq]
    out_idx = inverse.astype(np.int32).reshape(-1, 3)

    out_normals = None
    if has_normals:
        sel = ni[first]
        out_normals = np.where((sel >= 0)[:, None], normals[np.maximum(sel, 0)], 0.0)
    out_uvs = None
    if bool((ti >= 0).any()):
        sel = ti[first]
        out_uvs = np.where((sel >= 0)[:, None], uvs[np.maximum(sel, 0), :2], 0.0)

    return ObjShape(name=name, positions=out_pos, normals=out_normals, uvs=out_uvs,
                    indices=out_idx, has_normals=has_normals)


def _build_shape(name, faces, positions, normals, uvs) -> ObjShape:
    # Triangulate (fan) and flatten to parallel index arrays.
    vi: List[int] = []
    ni: List[int] = []
    ti: List[int] = []
    nv, nn, nt = len(positions), len(normals), len(uvs)

    def parse_tok(tok: str):
        parts = tok.split("/")
        v = int(parts[0])
        t = int(parts[1]) if len(parts) > 1 and parts[1] else 0
        n = int(parts[2]) if len(parts) > 2 and parts[2] else 0
        # OBJ is 1-based; negatives are relative to current count.
        v = v - 1 if v > 0 else nv + v
        t = t - 1 if t > 0 else (nt + t if t < 0 else -1)
        n = n - 1 if n > 0 else (nn + n if n < 0 else -1)
        return v, t, n

    for toks in faces:
        corners = [parse_tok(t) for t in toks]
        for k in range(1, len(corners) - 1):
            for c in (corners[0], corners[k], corners[k + 1]):
                vi.append(c[0])
                ti.append(c[1])
                ni.append(c[2])

    return shape_from_flat(name, vi, ti, ni, positions, normals, uvs)
