"""K1's plain version (BVH traversal over the kernel tables) against the JAX
package's exact oracle, intersect_bruteforce + interpolate_hit.

Contract and why: both sides run the same float32 Möller–Trumbore, but the
traversal visits triangles in another order than the brute-force scan, and
torch CPU and XLA CPU may round a sum differently in the last ulp. So:

* hit masks agree on >= 99.9% of rays; a disagreement is a grazing ray on a
  triangle edge, decided by one ulp;
* on rays both sides hit, |dt| <= 1e-4 * t + 1e-5;
* where both sides pick the same triangle, the interpolated normal agrees to
  rtol 1e-5 / atol 1e-6 and the material id exactly. (Equal-t ties between
  two triangles may pick either one.)

The port's own brute-force oracle is held to the same contract.

Across BVH widths the plain walks must find exactly the same nearest t on
every ray (the same float32 tests, another visiting order); which of two
equal-t triangles wins may differ ("near-first order decides ties"). The
wide walks order a node's children with the sorting networks of
csrc/traverse.cuh, which must sort and must be the header's comparators.
"""

import itertools
import os
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tracy_tpu.render.integrator import interpolate_hit as j_interpolate_hit
from tracy_tpu.render.intersect import intersect_bruteforce as j_bruteforce
from tracy_tpu_torch.accel.tables import build_tables
from tracy_tpu_torch.ops import intersect as k1
from tracy_tpu_torch.render.integrator import make_bruteforce_intersector
from tracy_tpu_torch.scene import from_jax_arrays
from test_torch_scene import builders

torch.set_num_threads(2)


def make_rays(scene, n, seed):
    """Half camera rays, half random-direction rays leaving random points on
    random triangles, 1e-4 of the scene's size off the surface, either side."""
    rng = np.random.default_rng(seed)
    k = n // 2
    s = torch.as_tensor(rng.uniform(size=k).astype(np.float32))
    t = torch.as_tensor(rng.uniform(size=k).astype(np.float32))
    o1, d1 = scene.camera.generate_rays(s, t)
    pos, idx = scene.vertex_pos.numpy(), scene.indices.numpy()
    tri = rng.integers(0, len(idx), n - k)
    a, b = rng.uniform(size=(2, n - k, 1))
    flip = a + b > 1
    a, b = np.where(flip, 1 - a, a), np.where(flip, 1 - b, b)
    v0, v1, v2 = pos[idx[tri, 0]], pos[idx[tri, 1]], pos[idx[tri, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-30)
    side = rng.choice([-1.0, 1.0], size=(n - k, 1))
    size = np.linalg.norm(pos.max(axis=0) - pos.min(axis=0))
    o2 = v0 + a * (v1 - v0) + b * (v2 - v0) + side * 1e-4 * size * fn
    d2 = rng.standard_normal((n - k, 3))
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    origin = np.concatenate([o1.numpy(), o2.astype(np.float32)])
    direction = np.concatenate([d1.numpy(), d2.astype(np.float32)])
    return origin, direction


def check_against_oracle(jscene, origin, direction, active, hit, normal, mat):
    p0, p1, p2 = jscene.triangle_vertices()
    jo, jd = jnp.asarray(origin), jnp.asarray(direction)
    ref = j_bruteforce(jo, jd, p0, p1 - p0, p2 - p0, active=jnp.asarray(active))
    attrs = j_interpolate_hit(jscene, ref, jo, jd)
    rmask, rt = np.asarray(ref.mask), np.asarray(ref.t)
    rtri = np.asarray(ref.tri)
    mask, t, tri = hit.mask.numpy(), hit.t.numpy(), hit.tri.numpy()

    assert not mask[~active].any()
    assert (mask == rmask).mean() >= 0.999
    both = mask & rmask
    assert both.sum() > len(mask) // 10
    np.testing.assert_array_less(np.abs(t[both] - rt[both]), 1e-4 * rt[both] + 1e-5)
    same = both & (tri == rtri)
    assert same.sum() >= 0.99 * both.sum()
    np.testing.assert_allclose(normal.numpy()[same], np.asarray(attrs.normal)[same],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(mat.numpy()[same], np.asarray(attrs.material)[same])
    assert (t[active & ~mask] == np.float32(3.4028235e38)).all()


@pytest.mark.parametrize("name", ["cornell", "testtree", "grid"])
@pytest.mark.parametrize("route,width", [pytest.param("k1_plain", 2, id="k1_plain"),
                                         pytest.param("k1_plain", 4, id="k1_plain-width4"),
                                         pytest.param("k1_plain", 8, id="k1_plain-width8"),
                                         pytest.param("bruteforce", None, id="bruteforce")])
def test_intersect_matches_jax_oracle(name, route, width):
    """K1's plain version at every BVH width (testtree's root is a leaf, so
    its wide tables are the binary ones), and the port's brute force."""
    jb, _ = builders(name)
    jscene = jb.build()
    scene = from_jax_arrays(jscene, device="cpu")
    origin, direction = make_rays(scene, 2048, seed=5)
    active = np.random.default_rng(6).uniform(size=len(origin)) < 0.9
    o, d, a = (torch.as_tensor(x) for x in (origin, direction, active))
    if route == "k1_plain":
        tables = build_tables(scene, leaf_size=4, max_depth=32, width=width)
        assert tables.width == (2 if name == "testtree" else width)
        before = k1.COUNT.plain
        hit, normal, mat = k1.intersect(o, d, a, tables)[:3]
        assert k1.COUNT.plain == before + 1  # CPU tensors take the plain route
    else:
        hit, normal, mat = make_bruteforce_intersector(scene)(o, d, a)[:3]
    check_against_oracle(jscene, origin, direction, active, hit, normal, mat)


@pytest.mark.parametrize("width", [2, 4, 8])
def test_plain_counts_warp_steps(width):
    """intersect_plain's warp counts: 32 copies of one ray keep every lane
    of the warp busy (share 1), one live ray per warp keeps one lane in 32
    busy, and the work counts do not depend on the batch's layout."""
    from tracy_tpu_torch.ops.compare import simt

    jb, _ = builders("grid")
    scene = from_jax_arrays(jb.build(), device="cpu")
    tables = build_tables(scene, width=width)
    origin, direction = (torch.as_tensor(x) for x in make_rays(scene, 64, seed=7))
    nodes = "wide_inner" if width > 2 else "inner"
    per_ray = []
    for layout in ("copies", "alone"):
        if layout == "copies":  # ray j repeated in lanes 32j .. 32j+31
            o, d = origin.repeat_interleave(32, 0), direction.repeat_interleave(32, 0)
            a = torch.ones(len(o), dtype=torch.bool)
        else:  # ray j in lane 32j, the other lanes dead
            o, d = origin.repeat_interleave(32, 0), direction.repeat_interleave(32, 0)
            a = torch.arange(len(o)) % 32 == 0
        counts = {}
        k1.intersect_plain(o, d, a, tables, counts=counts)
        share = simt(counts, nodes)
        want = 1.0 if layout == "copies" else 1.0 / 32
        assert share["node"] == pytest.approx(want) and share["tri"] == pytest.approx(want)
        per_ray.append((int(counts[nodes]) // int(a.sum() // 64), int(counts["tri_tests"])
                        // int(a.sum() // 64)))
    assert per_ray[0] == per_ray[1]


@pytest.mark.parametrize("name", ["cornell", "random", "grid"])
def test_widths_find_the_same_nearest_t(name):
    """The plain walks at widths 8, 4 and 2 give the same hit mask and the
    same nearest t, bit for bit, on every ray; only an equal-t tie may pick
    another triangle. The wide walks do less node work than the binary one."""
    _, tb = builders(name)
    scene = tb.build(device="cpu")
    origin, direction = make_rays(scene, 2048, seed=8)
    o, d = torch.as_tensor(origin), torch.as_tensor(direction)
    a = torch.as_tensor(np.random.default_rng(9).uniform(size=len(o)) < 0.9)
    hits, visits = {}, {}
    for width in (2, 4, 8):
        tables = build_tables(scene, leaf_size=4, max_depth=32, width=width)
        assert tables.width == width
        counts = {}
        hits[width] = k1.intersect_plain(o, d, a, tables, counts=counts)
        visits[width] = int(counts["wide_inner" if width > 2 else "inner"])
    ref = hits[2].hit
    assert int(ref.mask.sum()) > len(o) // 4
    for width in (4, 8):
        got = hits[width].hit
        assert torch.equal(got.mask, ref.mask) and torch.equal(got.t, ref.t)
        tie = got.tri != ref.tri
        assert int(tie.sum()) <= len(o) // 100
    assert visits[8] < visits[4] < visits[2]


def test_sorting_networks_sort_and_match_the_kernel():
    """Each wide width's network sorts every 0-1 input (so every input),
    and it is the comparator list of csrc/traverse.cuh sort_children<W>."""
    header = open(os.path.join(os.path.dirname(k1.__file__), "..", "csrc",
                               "traverse.cuh")).read()
    for w, net in k1.NETWORKS.items():
        assert len(net) == {4: 5, 8: 19}[w]
        for bits in itertools.product((0, 1), repeat=w):
            x = list(bits)
            for i, j in net:
                if x[j] < x[i]:
                    x[i], x[j] = x[j], x[i]
            assert x == sorted(x)
        body = header.split(f"sort_children<{w}>(Child* c, int* k) {{", 1)[1].split("}", 1)[0]
        pairs = tuple((int(i), int(j)) for i, j in
                      re.findall(r"order\(c\[(\d)\], k\[\d\], c\[(\d)\], k\[\d\]\)", body))
        assert pairs == net
