"""Port core (tracy_tpu_torch/core) against tracy_tpu/core on the same inputs.

Contract: the counter hashes and threefry (jax.random) are integer work
and must match bit for bit; camera rays are float work, held to 4 ulp (both
sides run the same float32 operations in the same order, so only a
reduction order may differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracy_tpu.core import math as jm
from tracy_tpu.core import rng as jrng
from tracy_tpu.core.camera import Camera as JCamera
from tracy_tpu.core.camera import pixel_samples as j_pixel_samples
from tracy_tpu.core.camera import pixel_samples_rows as j_pixel_samples_rows
from tracy_tpu_torch.core import math as tm
from tracy_tpu_torch.core import rng as trng
from tracy_tpu_torch.core.camera import Camera, pixel_samples, pixel_samples_rows

torch.set_num_threads(2)

SEED = 0xABCDEF


@pytest.mark.parametrize("kind", ["fast", "xorshift", "lcg", "threefry"])
def test_hash_bits_match(kind):
    """The 32 bits under each draw (a counter hash's, or threefry's x1 ^ x2
    of the draw's key at each position: jax.random.bits) and the uniform
    draw."""
    rng = np.random.default_rng(1)
    pix = rng.integers(0, 2**32, 50_000, dtype=np.uint64).astype(np.uint32)
    for frame, bounce, draw in ((0, 0, 0), (7, 3, 2), (2**32 - 1, 255, 1)):
        if kind == "threefry":
            key = jax.random.key(SEED)
            for d in (frame, bounce, draw):
                key = jax.random.fold_in(key, d)
            ref = np.asarray(jax.random.bits(key, pix.shape))
            pos = torch.arange(pix.size, dtype=torch.int64)
            y1, y2 = trng.threefry2x32(*trng.threefry_key(SEED, frame, bounce, draw),
                                       pos >> 32, pos & trng.MASK32)
            got = (y1 ^ y2).numpy()
        else:
            ref = np.asarray(jrng._mix(SEED, jnp.asarray(pix), frame, bounce, draw, kind))
            got = trng.mix(SEED, torch.as_tensor(pix.astype(np.int64)), frame, bounce,
                           draw, kind).numpy()
        np.testing.assert_array_equal(got, ref.astype(np.int64))
        ref_u = np.asarray(jrng.RngSpec(kind, SEED).uniform(jnp.asarray(pix), frame, bounce,
                                                            draw))
        got_u = trng.RngSpec(kind, SEED).uniform(
            torch.as_tensor(pix.astype(np.int64)), frame, bounce, draw).numpy()
        np.testing.assert_array_equal(got_u, ref_u)


def test_threefry_matches_jax_random():
    """RngSpec('threefry') against tracy_tpu's under jax.jit, bit for bit:
    shapes (1,), (7,) and (40, 64) (the counter is the flat position in the
    array, not the pixel id), a seed below and one above 2^31, frames 0
    and 2^32 - 1, bounces 0-4, draws 0-3."""
    for seed in (SEED, 3_000_000_000):
        ref_spec, spec = jrng.RngSpec("threefry", seed), trng.RngSpec("threefry", seed)
        draw_fn = jax.jit(ref_spec.uniform)
        for shape in ((1,), (7,), (40, 64)):
            pix = np.random.default_rng(2).integers(0, 2**31, shape).astype(np.uint32)
            for frame in (0, 2**32 - 1):
                for bounce in range(5):
                    for draw in range(4):
                        ref = np.asarray(draw_fn(jnp.asarray(pix), np.uint32(frame),
                                                 np.uint32(bounce), np.uint32(draw)))
                        got = spec.uniform(torch.as_tensor(pix.astype(np.int64)), frame,
                                           bounce, draw).numpy()
                        assert got.shape == shape and got.dtype == np.float32
                        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    # The counter follows the array's positions: the same pixels drawn
    # over another shape, or with their positions given, draw as such.
    pix = torch.arange(7, dtype=torch.int64)
    spec = trng.RngSpec("threefry", SEED)
    rev = spec.uniform(pix.flip(0), 3, 1, 2)
    assert not torch.equal(rev, spec.uniform(pix, 3, 1, 2).flip(0))
    assert torch.equal(spec.uniform(pix.flip(0), 3, 1, 2, position=pix.flip(0)),
                       spec.uniform(pix, 3, 1, 2).flip(0))


def test_vector_math_matches():
    """normalize / reflect / refract (incl. TIR -> zero) within 4 ulp."""
    rng = np.random.default_rng(2)
    v = rng.standard_normal((4096, 3)).astype(np.float32)
    n = rng.standard_normal((4096, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    d = v / np.linalg.norm(v, axis=-1, keepdims=True)
    eta = rng.uniform(0.5, 1.8, (4096, 1)).astype(np.float32)
    T = torch.as_tensor
    pairs = [
        (jm.normalize(jnp.asarray(v)), tm.normalize(T(v))),
        (jm.reflect(jnp.asarray(d), jnp.asarray(n)), tm.reflect(T(d), T(n))),
        (jm.refract(jnp.asarray(d), jnp.asarray(n), jnp.asarray(eta)),
         tm.refract(T(d), T(n), T(eta))),
    ]
    for ref, got in pairs:
        np.testing.assert_array_max_ulp(got.numpy(), np.asarray(ref), maxulp=4)
    tir = np.asarray(jm.refract(jnp.asarray(d), jnp.asarray(n), jnp.asarray(eta)))
    assert (tir == 0).all(axis=-1).any()  # some lanes hit total internal reflection



# The float32 functions the port's plain versions call on the CPU, each on
# the inputs it gets there, against float64 numpy. 4096 lanes: torch splits
# them into two tasks on two threads, as in the failure that
# core/math.py::sqrt repairs (ROADMAP, hazards), which this guards against
# coming back in another function.
CPU_MATH = {
    "sqrt (core/math.py)": (lambda r: r.uniform(0.0, 9.0, 4096), tm.sqrt, np.sqrt),
    "sin (random_on_unit_sphere)": (lambda r: r.uniform(0.0, 2 * np.pi, 4096), torch.sin,
                                    np.sin),
    "cos (random_on_unit_sphere)": (lambda r: r.uniform(0.0, 2 * np.pi, 4096), torch.cos,
                                    np.cos),
    "asin (sky_uv)": (lambda r: r.uniform(-1.0, 1.0, 4096), torch.asin, np.arcsin),
    "atan2 (sky_uv)": (lambda r: r.standard_normal((2, 4096)), lambda x: torch.atan2(*x),
                       lambda x: np.arctan2(*x)),
    "pow (srgb_from_linear)": (lambda r: r.uniform(1e-8, 1.0, 4096),
                               lambda x: torch.pow(x, 1.0 / 2.4), lambda x: x ** (1.0 / 2.4)),
}


@pytest.mark.parametrize("name", list(CPU_MATH))
def test_cpu_math_matches_float64(name):
    """Within 4 ulp of the float64 result rounded to float32 (the contract
    of test_vector_math_matches), on every lane."""
    draw, fn, ref = CPU_MATH[name]
    x = draw(np.random.default_rng(5)).astype(np.float32)
    got = fn(torch.as_tensor(x)).numpy()
    want = ref(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_max_ulp(got, want, maxulp=4)

def test_generate_rays_and_pixel_samples_match():
    args = dict(eye=(-0.5, 1.2, 1.5), center=(0.0, 0.0, -1.0), up=(0.0, 1.0, 0.0),
                fov_degrees=60.0, aspect_ratio=320 / 240)
    jc, tc = JCamera.setup(**args), Camera.setup(**args, device="cpu")
    for name in ("eye", "inv_view_projection", "view", "projection"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)))

    w, h = 320, 240
    rng = np.random.default_rng(3)
    rows = np.arange(0, h, 3, dtype=np.int32)
    ju = rng.uniform(size=(len(rows), w)).astype(np.float32)
    jv = rng.uniform(size=(len(rows), w)).astype(np.float32)
    js, jt = j_pixel_samples_rows(w, h, jnp.asarray(rows), jnp.asarray(ju), jnp.asarray(jv))
    ts, tt = pixel_samples_rows(w, h, torch.as_tensor(rows), torch.as_tensor(ju),
                                torch.as_tensor(jv))
    np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), maxulp=4)
    np.testing.assert_array_max_ulp(tt.numpy(), np.asarray(jt), maxulp=4)

    jo, jd = jc.generate_rays(js, jt)
    to, td = tc.generate_rays(torch.tensor(np.asarray(js)), torch.tensor(np.asarray(jt)))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_max_ulp(td.numpy(), np.asarray(jd), maxulp=4)


def test_pixel_samples_match():
    """pixel_samples (every row of the image) within 4 ulp, as the band's."""
    w, h = 96, 40
    rng = np.random.default_rng(4)
    ju, jv = (rng.uniform(size=(h, w)).astype(np.float32) for _ in range(2))
    js, jt = j_pixel_samples(w, h, jnp.asarray(ju), jnp.asarray(jv))
    ts, tt = pixel_samples(w, h, torch.as_tensor(ju), torch.as_tensor(jv))
    assert ts.shape == tt.shape == (h, w)
    np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), maxulp=4)
    np.testing.assert_array_max_ulp(tt.numpy(), np.asarray(jt), maxulp=4)


def test_length_srgb_and_luminance_match():
    """length (through core/math.py::sqrt), linear_from_srgb and luminance
    within 4 ulp of tracy_tpu's, on 4096 lanes."""
    rng = np.random.default_rng(5)
    v = rng.standard_normal((4096, 3)).astype(np.float32)
    x = rng.uniform(-0.1, 1.2, (4096, 3)).astype(np.float32)
    rgb = rng.uniform(0.0, 4.0, (4096, 3)).astype(np.float32)
    T = torch.as_tensor
    pairs = [(tm.length(T(v)), jm.length(jnp.asarray(v))),
             (tm.length(T(v), keepdim=False), jm.length(jnp.asarray(v), keepdims=False)),
             (tm.linear_from_srgb(T(x)), jm.linear_from_srgb(jnp.asarray(x))),
             (tm.luminance(T(rgb)), jm.luminance(jnp.asarray(rgb)))]
    for got, ref in pairs:
        assert got.shape == ref.shape
        np.testing.assert_array_max_ulp(got.numpy(), np.asarray(ref), maxulp=4)

