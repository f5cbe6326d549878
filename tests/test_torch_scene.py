"""Port scene build and BVH against tracy_tpu's, plus BVH table invariants.

Contract: the host builders are numpy copies of the JAX package's, so every
array of the port's build() must EQUAL tracy_tpu's (both round the same
float64 host values to float32 once), and the BVH node arrays must be
equal too, as must the 4-wide collapse of one binary tree. The kernel
tables, binary and 4-wide, must reach every triangle exactly once, every
node box must contain the triangles below it, and the stack bounds must
cover the trees' depths.
"""

import os

import numpy as np
import pytest
import torch

from tracy_tpu.accel.bvh import _build_auto as j_build_auto
from tracy_tpu.accel.bvh_build import build_bvh as j_build_bvh
from tracy_tpu.scene import scn_parser as jscn
from tracy_tpu_torch.accel.bvh_build import build_bvh, build_bvh_auto
from tracy_tpu.ops.pallas_packet import _collapse4 as j_collapse4
from tracy_tpu_torch.accel.tables import (BIG, KERNEL_STACK4_MAX, KERNEL_STACK8_MAX,
                                          KERNEL_STACK_MAX, build_tables, collapse4,
                                          wide_lines)
from tracy_tpu_torch.ops.intersect import check_tables
from tracy_tpu_torch.scene import scn_parser as tscn

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCN = os.path.join(REPO, "tests", "goldens", "scn")
SCENES = ["furnace", "cornell", "testtree", "random", "default", "grid", "spheres"]


def _path(name):
    if name == "default":
        return os.path.join(REPO, "data", "scenes", "default.scn")
    return os.path.join(SCN, f"{name}.scn")


def builders(name):
    """(tracy_tpu builder, port builder) for one in-repo scene."""
    if name == "grid":  # a small sphere grid (tools/tpu_bigscene.py's loop)
        jb = jscn.default_scene(32, 24)
        g = 3
        for i in range(9):
            jb.add_sphere((i % g * 2.5 - g, 0.5, i // g * 2.5 - g), 1.0, 1 + (i % 3), steps=8)
        return jb, tscn.sphere_grid(32, 24, nsph=9, steps=8)
    return jscn.load_scene(_path(name)), tscn.load_scene(_path(name))


def _tri_bounds(pos, idx):
    v = pos[idx]
    return v.min(axis=1), v.max(axis=1)


def assert_scenes_equal(ts, js):
    """Every array of the port's SceneArrays equals tracy_tpu's."""
    assert (ts.width, ts.height, ts.name) == (js.width, js.height, js.name)
    for field in ("vertex_pos", "vertex_normal", "vertex_uv", "vertex_tangent",
                  "indices", "tri_material", "tex_data", "tex_table"):
        np.testing.assert_array_equal(getattr(ts, field).numpy(),
                                      np.asarray(getattr(js, field)), err_msg=field)
    for field in ("albedo", "roughness", "metalness", "ior", "emissive",
                  "translucent", "tex_index"):
        np.testing.assert_array_equal(getattr(ts.materials, field).numpy(),
                                      np.asarray(getattr(js.materials, field)),
                                      err_msg=field)
    for field in ("eye", "inv_view_projection", "view", "projection"):
        np.testing.assert_array_equal(getattr(ts.camera, field).numpy(),
                                      np.asarray(getattr(js.camera, field)), err_msg=field)


@pytest.mark.parametrize("name", SCENES)
def test_build_arrays_equal(name):
    """spheres.scn's HDR sky (tests/goldens/data/sky.hdr) gives the same
    atlas, tex_table and tex_index as tracy_tpu's."""
    jb, tb = builders(name)
    assert tb.fallbacks == []
    assert_scenes_equal(tb.build(device="cpu"), jb.build())


@pytest.mark.parametrize("name", ["cornell", "testtree", "random", "grid"])
def test_bvh_nodes_equal(name):
    """numpy builder vs numpy builder, and the auto (native) route vs the
    JAX package's auto route: identical trees."""
    _, tb = builders(name)
    s = tb.build(device="cpu")
    lo, hi = _tri_bounds(s.vertex_pos.numpy(), s.indices.numpy())
    pairs = [(build_bvh(lo, hi, 8, 36), j_build_bvh(lo, hi, 8, 36)),
             (build_bvh_auto(lo, hi, 4, 20), j_build_auto(lo, hi, 4, 20))]
    for got, ref in pairs:
        np.testing.assert_array_equal(got.node_bounds, ref.node_bounds)
        np.testing.assert_array_equal(got.node_meta, ref.node_meta)
        np.testing.assert_array_equal(got.tri_order, ref.tri_order)
        assert got.max_depth == ref.max_depth


@pytest.mark.parametrize("name,leaf,depth", [("random", 8, 60), ("grid", 4, 6)])
def test_tables_reach_every_triangle(name, leaf, depth):
    """Every triangle sits in exactly one leaf reachable from the root, every
    node box contains its subtree's triangles, slot data matches the scene,
    and the stack bound covers the real depth. depth=6 forces leaves far
    wider than leaf_size: none may drop a triangle."""
    _, tb = builders(name)
    s = tb.build(device="cpu")
    tab = build_tables(s, leaf_size=leaf, max_depth=depth)
    nb, nm = tab.node_bounds.numpy(), tab.node_meta.numpy()
    pos, idx = s.vertex_pos.numpy(), s.indices.numpy()
    lo, hi = _tri_bounds(pos, idx)
    tri_id = tab.tri_id.numpy()

    seen = np.zeros(len(idx), np.int64)
    deepest = 0

    def walk(node, depth_now):
        nonlocal deepest
        deepest = max(deepest, depth_now)
        first, count, right = nm[node, :3]
        if count > 0:
            tris = tri_id[first:first + count]
            np.add.at(seen, tris, 1)
        else:
            tris = np.concatenate([walk(first, depth_now + 1), walk(right, depth_now + 1)])
        assert (nb[node, 0:3] <= lo[tris].min(axis=0)).all()
        assert (nb[node, 4:7] >= hi[tris].max(axis=0)).all()
        return tris

    walk(0, 0)
    assert (seen == 1).all()
    assert deepest == tab.max_depth <= depth and tab.stack_size > deepest
    if name == "grid":
        assert nm[nm[:, 1] > 0, 1].max() > leaf
    order = tri_id.astype(np.int64)
    tri = tab.tri.numpy()
    np.testing.assert_array_equal(tri[:, 0:3], pos[idx[order, 0]])
    np.testing.assert_array_equal(tri[:, 4:7], pos[idx[order, 1]] - pos[idx[order, 0]])
    np.testing.assert_array_equal(tri[:, 8:11], pos[idx[order, 2]] - pos[idx[order, 0]])
    np.testing.assert_array_equal(tab.tri_meta.numpy()[:, 0:3], idx[order])
    np.testing.assert_array_equal(tab.tri_meta.numpy()[:, 3], s.tri_material.numpy()[order])


def test_textured_features_raise():
    """The builder's texture calls raise where tracy_tpu's do: on a material
    or a slot out of range."""
    from tracy_tpu.scene.scene import SceneBuilder as JSceneBuilder
    from tracy_tpu_torch.scene.scene import SceneBuilder

    for cls in (JSceneBuilder, SceneBuilder):
        b = cls(width=8, height=8)
        grey = b.add_material((0.5, 0.5, 0.5))
        tid = b.add_texture(np.full((2, 2, 4), 0.5, np.float32))
        with pytest.raises(IndexError):
            b.set_material_texture(grey + 1, 0, tid)
        with pytest.raises(IndexError):
            b.set_material_texture(grey, 5, tid)


def test_textured_tags_load_or_list_fallbacks(tmp_path):
    """The textured tags load, and a file one names that is missing is
    replaced as tracy_tpu does and listed in builder.fallbacks."""
    for line, fallback in (("TEX Grey B tex.png", "texture tex.png"),
                           ("SKY sky.hdr", "texture sky.hdr"),
                           ("TRI mesh.obj Grey", "mesh mesh.obj")):
        p = tmp_path / "x.scn"
        p.write_text("MTL Grey (0.5, 0.5, 0.5) 1 0\n" + line + "\n")
        b = tscn.load_scene(str(p))
        assert b.fallbacks == [fallback]
        assert len(b.atlas) == (0 if fallback.startswith("mesh") else 1)
        assert np.isfinite(b.build(device="cpu").tex_data.numpy()).all()


@pytest.mark.parametrize("name,width", [
    pytest.param(n, w, id=n if w == 4 else f"{n}-width8")
    for w in (4, 8) for n in ("cornell", "random", "grid")])
def test_collapse4_equals_jax(name, width):
    """The port's collapse4 gives tracy_tpu's _collapse4 arrays at widths 4
    and 8 on the same binary tree, bit for bit."""
    _, tb = builders(name)
    s = tb.build(device="cpu")
    lo, hi = _tri_bounds(s.vertex_pos.numpy(), s.indices.numpy())
    host = build_bvh_auto(lo, hi, 4, 60)
    got, ref = collapse4(host.node_bounds, host.node_meta, width), j_collapse4(
        host.node_bounds, host.node_meta, width)
    assert got[0].shape[1] == 6 * width and got[1].shape[1] == 2 * width
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[2] == ref[2] > 1
    if width == 8:  # some 8-wide node has fewer than 8 children
        assert (got[1][:, 1::2] == -1).any()


@pytest.mark.parametrize("name,leaf,depth,width", [
    pytest.param("random", 8, 60, 4, id="random-8-60"),
    pytest.param("grid", 4, 6, 4, id="grid-4-6"),
    pytest.param("random", 8, 60, 8, id="random-8-60-width8"),
    pytest.param("grid", 4, 6, 8, id="grid-4-6-width8")])
def test_wide_tables_reach_every_triangle(name, leaf, depth, width):
    """The wide rows reach every triangle exactly once, every child box
    contains its subtree's triangles, empty slots are never-hit boxes with
    count -1, the rows are the binary tree's boxes and leaves, and the
    stack bound is (W - 1) * depthW + 1 within the kernel's stack."""
    _, tb = builders(name)
    s = tb.build(device="cpu")
    tab = build_tables(s, leaf_size=leaf, max_depth=depth, width=width)
    w = width
    assert tab.width == w and tab.wide.shape[1] == 8 * w
    line = tab.wide.numpy()
    bits = line.view(np.int32)
    pos, idx = s.vertex_pos.numpy(), s.indices.numpy()
    lo, hi = _tri_bounds(pos, idx)
    tri_id = tab.tri_id.numpy()
    seen = np.zeros(len(idx), np.int64)
    deepest = 0

    def walk(row, depth4):
        nonlocal deepest
        deepest = max(deepest, depth4)
        tris = []
        for k in range(w):
            ref, count = bits[row, 6 * w + k], bits[row, 7 * w + k]
            box_lo, box_hi = line[row, k:6 * w:2 * w], line[row, w + k:6 * w:2 * w]
            if count < 0:
                assert (box_lo == BIG).all() and (box_hi == -BIG).all()
                continue
            if count > 0:
                sub = tri_id[~ref:~ref + count]
                np.add.at(seen, sub, 1)
            else:
                sub = walk(ref, depth4 + 1)
            assert (box_lo <= lo[sub].min(axis=0)).all()
            assert (box_hi >= hi[sub].max(axis=0)).all()
            tris.append(sub)
        return np.concatenate(tris)

    walk(0, 1)
    assert (seen == 1).all()
    levels = 2 if w == 4 else 3  # binary levels between a wide node and its inner children
    assert deepest == tab.depth4 <= (tab.max_depth - 1) // levels + 1
    assert tab.stack_size == (w - 1) * tab.depth4 + 1 <= tab.stack_max


def chain_tree(depth):
    """A binary chain `depth` levels deep: inner node i (row 2i, depth i)
    has a leaf left child (row 2i+1) and inner node i+1 right; the last
    right child is a leaf at depth `depth`. Returns (bounds, meta)."""
    meta = np.zeros((2 * depth + 1, 3), np.int32)
    for i in range(depth):
        meta[2 * i] = (2 * i + 1, 0, 2 * i + 2)
        meta[2 * i + 1] = (i, 1, -1)
    meta[2 * depth] = (depth, 1, -1)
    return np.tile(np.array([0, 0, 0, 1, 1, 1], np.float32), (len(meta), 1)), meta


def test_wide_stack_bound_at_the_depth_cap():
    """A binary chain as deep as the builder's cap (60) and as the binary
    stack allows (63) collapses to depth4 30 and 32: stacks of 91 and 97
    entries, which the kernel's stack holds; one more level is refused."""
    for depth, want4 in ((60, 30), (63, 32)):
        nb, meta = chain_tree(depth)
        b4, m4, depth4 = collapse4(nb, meta)
        assert depth4 == want4 == j_collapse4(nb, meta, 4)[2]
        assert 3 * depth4 + 1 <= KERNEL_STACK4_MAX
        bits = wide_lines(b4, m4, meta).view(np.int32)
        assert (bits[:, 28:32] >= -1).all()
    tab = build_tables(builders("cornell")[1].build(device="cpu"), width=4)
    tab.depth4 = (KERNEL_STACK4_MAX - 1) // 3 + 1
    with pytest.raises(ValueError, match="stack"):
        check_tables(tab, torch.device("cpu"))


def test_wide8_stack_bound_at_the_depth_cap():
    """At width 8 each wide level covers three binary levels, so a chain as
    deep as the BVH build's cap (60) and as the binary stack allows (63)
    collapses to depth8 20 and 21: stacks of 141 and 148 entries, which the
    kernel's stack holds exactly; one more level is refused with a
    message, never walked with a cut stack."""
    assert KERNEL_STACK_MAX - 1 == 63
    for depth, want8 in ((60, 20), (63, 21)):
        nb, meta = chain_tree(depth)
        b8, m8, depth8 = collapse4(nb, meta, 8)
        assert depth8 == want8 == j_collapse4(nb, meta, 8)[2]
        assert 7 * depth8 + 1 <= KERNEL_STACK8_MAX
        rows = wide_lines(b8, m8, meta)
        assert rows.shape == (len(b8), 64)
        assert (rows.view(np.int32)[:, 56:64] >= -1).all()
    assert KERNEL_STACK8_MAX == 7 * 21 + 1
    tab = build_tables(builders("cornell")[1].build(device="cpu"), width=8)
    assert tab.width == 8 and tab.stack_size <= tab.stack_max == KERNEL_STACK8_MAX
    tab.depth4 = (KERNEL_STACK8_MAX - 1) // 7 + 1
    with pytest.raises(ValueError, match="148"):
        check_tables(tab, torch.device("cpu"))


def test_root_leaf_gives_binary_tables():
    """When the root is a leaf there is nothing to collapse: the tables are
    the binary ones and say so (width 2), as tracy_tpu's build_tables
    falls back (pallas_packet.py:497-500); K1's plain version runs them."""
    from tracy_tpu_torch.ops import intersect as k1

    _, tb = builders("testtree")
    s = tb.build(device="cpu")
    for width in (8, 4):
        tab = build_tables(s, leaf_size=8, width=width)
        assert tab.node_meta[0, 1] > 0
        assert tab.width == 2 and tab.wide is None and tab.depth4 == 0
    assert collapse4(tab.node_bounds.numpy(), tab.node_meta.numpy()) is None
    assert j_collapse4(tab.node_bounds.numpy(), tab.node_meta.numpy(), 4) is None
    o = torch.zeros((1, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]])
    hit = k1.intersect(o, d, torch.ones(1, dtype=torch.bool), tab).hit
    assert hit.t.shape == (1,)
