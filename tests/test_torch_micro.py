"""K6's plain version (tracy_tpu_torch/tools/micro.py) against the JAX
package's exact oracle, on the CPU.

tools/tpu_micro.py's kernel is nested inside its main() and takes Woop rows,
so it cannot be called as a function. What K6's leaf loop computes, the
closest front-facing hit over its 31 leaves of 8 triangles, is what
tracy_tpu/render/intersect.py::intersect_bruteforce computes over the same
248 triangles. So micro_plain("vres") is held to that oracle under
test_torch_intersect.py's contract (the same float32 Möller–Trumbore, in
another order of operations):

* hit masks agree on >= 99.9% of rays;
* on rays both sides hit, |dt| <= 1e-4 * t + 1e-5;
* where both pick the same triangle (the slot is the triangle's index), the
  interpolated normal agrees to rtol 1e-5 / atol 1e-6 and the material id
  exactly.

The other variants' outputs are held to what they share with vres.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracy_tpu.render.intersect import intersect_bruteforce as j_bruteforce
from tracy_tpu_torch.tools import micro as k6

torch.set_num_threads(2)
N = 2048


@pytest.fixture(scope="module")
def plain():
    leaves = k6.make_leaves(device="cpu")
    rays = k6.make_rays(N, device="cpu")
    return leaves, rays, {v: k6.micro(v, rays, leaves, iters=40) for v in k6.VARIANTS}


def test_vres_matches_bruteforce(plain):
    leaves, rays, out = plain
    got = out["vres"][0].numpy()
    p0, p1, p2 = (jnp.asarray(p) for p in leaves.vertices)
    r = rays.numpy()
    ref = j_bruteforce(jnp.asarray(r[:, 0:3]), jnp.asarray(r[:, 3:6]), p0, p1 - p0, p2 - p0)
    rmask, rt, rtri = np.asarray(ref.mask), np.asarray(ref.t), np.asarray(ref.tri)
    mask, t, slot = got[:, 1] >= 0, got[:, 0], got[:, 1].astype(np.int64)
    assert leaves.tri.shape[0] == 248
    assert (mask == rmask).mean() >= 0.999
    both = mask & rmask
    assert both.sum() > N // 2
    np.testing.assert_array_less(np.abs(t[both] - rt[both]), 1e-4 * rt[both] + 1e-5)
    same = both & (slot == rtri)
    assert same.sum() >= 0.99 * both.sum()
    meta = leaves.tri_meta.numpy()[rtri[same]]
    nrm = leaves.vertex_normal.numpy()
    uv = np.asarray(ref.uv)[same]
    u, v = uv[:, 0:1], uv[:, 1:2]
    want = (1.0 - u - v) * nrm[meta[:, 0]] + u * nrm[meta[:, 1]] + v * nrm[meta[:, 2]]
    np.testing.assert_allclose(got[same, 4:7], want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[same, 7], meta[:, 3])
    assert (t[~mask] == np.float32(3.4028235e38)).all()


def test_variants_share_their_outputs(plain):
    """vmt, vacc and vred find vres's winner; vred's counter counts the
    (warp, visit) pairs in which some ray of the warp found a nearer hit;
    v0 and vd reduce as the kernel does."""
    leaves, rays, out = plain
    res = out["vres"][0]
    assert torch.equal(out["vmt"][0][:, 0], res[:, 0])
    for v in ("vacc", "vred"):
        assert torch.equal(out[v][0][:, :4], res[:, :4])
    count = out["vred"][1]
    assert count.shape == (N // 32,) and 0 < int(count.sum()) <= (N // 32) * k6.NUM_LEAVES
    o = rays[:, 0]
    want = o.clone()
    for _ in range(40):
        want = want + 1.0e-7
    assert torch.equal(out["v0"][0][:, 0], want)
    t = leaves.tri
    assert torch.equal(out["vd"][0][:, 0],
                       torch.minimum(o, (t[:, 0] + t[:, 5] + t[:, 10])[None, :].add(
                           o[:, None]).amin(dim=1)))


def test_inputs_default_to_the_card():
    """make_leaves and make_rays put their tensors on the card unless the
    caller asks for the CPU, as the port's other entry points do."""
    if torch.cuda.is_available():
        assert k6.make_rays(64).device.type == "cuda"
        assert k6.make_leaves(num_leaves=2).tri.device.type == "cuda"
    else:
        for make in (lambda: k6.make_rays(64), lambda: k6.make_leaves(num_leaves=2)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
