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

The other variants' outputs are held to what they share with vres, and
core/math.py::fma, which rounds the kernel's fused product-sums in the
plain version, to exact arithmetic.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracy_tpu.render.intersect import intersect_bruteforce as j_bruteforce
from tracy_tpu_torch.core.math import fma
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


def _round_f32(x: Fraction) -> float:
    """x rounded to the nearest float32, ties to even (subnormals, and
    infinity past the largest float32, as IEEE rounds)."""
    if x == 0:
        return 0.0
    sign, x = (-1.0 if x < 0 else 1.0), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    e += (Fraction(2) ** (e + 1) <= x) - (Fraction(2) ** e > x)
    q = x / Fraction(2) ** (max(e, -126) - 23)
    n, rem = divmod(q.numerator, q.denominator)
    n += 2 * rem > q.denominator or (2 * rem == q.denominator and n % 2 == 1)
    v = n * Fraction(2) ** (max(e, -126) - 23)
    return sign * (float("inf") if v >= Fraction(2) ** 128 else float(v))


def _fma_cases():
    """Seeded float32 triples: random magnitudes (subnormal and overflowing
    results among them), ties of a * b that a tiny c must break (double
    rounding through float64 gets these wrong), and cancellation (c the
    negated rounded product, so the result is the product's rounding
    error, and that plus a tiny c)."""
    rng = np.random.default_rng(21)
    n = 3000
    a = rng.standard_normal(n) * 2.0 ** rng.integers(-75, 65, n)
    b = rng.standard_normal(n) * 2.0 ** rng.integers(-75, 65, n)
    c = rng.standard_normal(n) * 2.0 ** rng.integers(-150, 120, n)
    k, m = (2 * rng.integers(0, 512, (2, 600)) + 1) / 4096.0
    tie_c = rng.choice([0.0, 2.0 ** -80, -(2.0 ** -80), 2.0 ** -40, -(2.0 ** -40),
                        2.0 ** -24, -(2.0 ** -24)], 600)
    a32, b32 = np.float32(a), np.float32(b)
    canc = -(a32[:600].astype(np.float64) * b32[:600]).astype(np.float32)
    tiny = rng.choice([0.0, 2.0 ** -100, -(2.0 ** -100)], 600)
    # Past the largest float32, and into the subnormals.
    edge = np.array([[1.5 * 2.0 ** 64, 1.5 * 2.0 ** 64, 0.0],
                     [-1.9 * 2.0 ** 64, 2.0 ** 64, -(2.0 ** 127)],
                     [2.0 ** -70, 1.25 * 2.0 ** -70, 2.0 ** -140],
                     [3.0 * 2.0 ** -75, -(2.0 ** -70), 2.0 ** -126]]).T
    return [np.concatenate(v).astype(np.float32) for v in (
        (a, 1 + k, a32[:600], edge[0]), (b, 1 + m, b32[:600], edge[1]),
        (c, tie_c, canc + np.float32(tiny), edge[2]))]


def test_fma_is_exact_against_fractions():
    """core/math.py::fma, K6's plain version of the card's fmaf: every
    result equals a * b + c computed exactly and rounded once to float32,
    bit for bit; the same triples through float64 then float32 (two
    roundings) miss some ties, so the cases do test the rounding to odd."""
    a, b, c = _fma_cases()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    got = fma(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    with np.errstate(over="ignore"):
        twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (twice.view(np.int32) != want.view(np.int32)).sum() > 100
    assert np.isinf(want).any() and (np.abs(want[want != 0]) < 2.0 ** -126).any()
    # IEEE's signed zeros: a zero sum is -0 only where both terms are -0.
    signs = torch.signbit(fma(torch.tensor([-0.0, 0.0, -0.0, 0.0]),
                              torch.tensor([1.0, -1.0, -1.0, -1.0]),
                              torch.tensor([-0.0, 0.0, -0.0, -0.0])))
    assert signs.tolist() == [True, False, False, True]
