"""The port's Renderer on CPU against tracy_tpu's Renderer(accel='bvh',
use_pallas=False): same scene arrays, same seed, cornell at 64x64, and the
textured path (K1 with uv and tangent, K3, K4) on the textured fixture of
tests/test_pallas_texfetch.py at 32x24 and on spheres.scn (HDR equirect sky)
at 32x24, 2 frames each.

Both sides draw the same random numbers (bit-identical counter RNG), so the
paths are the same paths, and the images agree far more closely than two
independent estimates would. A path can still part ways where an ulp of
torch CPU vs XLA CPU flips a discrete decision, and one flipped path that
reaches the light moves a 16x16 block mean by up to about 0.03. Tolerances,
in linear radiance (the light is 15):

* mean over the image: 1e-3;  p95 of |block diff|: 5e-3;  max: 0.05;
* ray counts (one per live lane per bounce): within 0.1%.

The other intersectors and counter hashes that tracy_tpu renders
(accel 'bvh' and 'none', rng 'xorshift' and 'lcg') are held to the same
contract in tests/test_torch_settings.py.

On a textured sky a miss lane may also read a neighbouring texel where
torch's atan2/asin and XLA's differ by an ulp; that is one more source of a
parted path, held by the same limits.
"""

import os

import jax.numpy as jnp
import numpy as np
import torch

from tracy_tpu.config import RenderConfig
from tracy_tpu.render.renderer import Renderer as JRenderer
from tracy_tpu.render.renderer import init_state as j_init_state
from tracy_tpu.scene.scn_parser import load_scene as j_load_scene
from tracy_tpu_torch.ops import intersect as k1
from tracy_tpu_torch.ops import shade as k2
from tracy_tpu_torch.ops import texfetch as k3
from tracy_tpu_torch.render.renderer import Renderer, init_state
from tracy_tpu_torch.scene import from_jax_arrays
from tracy_tpu_torch.utils.parity import block_means
from test_torch_textures import textured_builders

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def render_both(jscene, textured: bool):
    """2 frames of jscene in both packages; returns (port renderer, state,
    rays, tracy_tpu renderer, state). Checks which plain versions ran."""
    cfg = RenderConfig(width=jscene.width, height=jscene.height, spp=1, accel="bvh",
                       use_pallas=False)
    jr = JRenderer(cfg)
    jst, _ = jr.step_many(jscene, j_init_state(cfg), 2)

    cfg_t = RenderConfig(width=jscene.width, height=jscene.height, spp=1)
    r = Renderer(cfg_t)
    counts = (k1.COUNT, k2.COUNT, k3.COUNT, k2.COUNT_TEX)
    before = [c.plain for c in counts]
    st, rays = r.step_many(from_jax_arrays(jscene, device="cpu"), init_state(cfg_t, "cpu"), 2)
    ran = [c.plain - b for c, b in zip(counts, before)]
    runs = 2 * cfg.max_bounces
    # K4 fetches its own texels: K3 is not called on the render path.
    assert ran == ([runs, 0, 0, runs] if textured else [runs, runs, 0, 0])
    assert st.frame == 2
    return r, st, rays, jr, jst


def assert_images_agree(got, rays, ref, jrays):
    assert np.isfinite(got).all()
    assert abs(rays - jrays) <= 1e-3 * jrays
    d = np.abs(block_means(got) - block_means(ref))
    assert abs(float(got.mean()) - float(ref.mean())) <= 1e-3
    assert float(np.percentile(d, 95)) <= 5e-3
    assert float(d.max()) <= 0.05


def test_cornell_render_matches_jax():
    b = j_load_scene(os.path.join(REPO, "tests", "goldens", "scn", "cornell.scn"))
    b.width = b.height = 64
    r, st, rays, jr, jst = render_both(b.build(), textured=False)
    got, ref = st.accum.numpy(), np.asarray(jst.accum)
    assert_images_agree(got, rays, ref, jr.total_rays)
    # Film: same accumulation, so the 8-bit images agree to one step (an ulp
    # of torch's pow vs XLA's can cross a quantization boundary).
    u8 = r.display_u8(st).astype(int)
    assert u8.shape == (64, 64, 3)
    assert np.abs(u8 - jr.display_u8(jst).astype(int)).max() <= 1


def test_sky_emission_matches_jax():
    from tracy_tpu.render.integrator import sky_emission as j_sky
    from tracy_tpu_torch.render.integrator import sky_emission

    jscene = j_load_scene(os.path.join(REPO, "data", "scenes", "default.scn")).build()
    d = np.random.default_rng(9).standard_normal((256, 3)).astype(np.float32)
    got = sky_emission(from_jax_arrays(jscene, device="cpu"), torch.as_tensor(d))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_sky(jscene, jnp.asarray(d))))


def test_textured_render_matches_jax():
    jb, _ = textured_builders()
    r, st, rays, jr, jst = render_both(jb.build(), textured=True)
    assert_images_agree(st.accum.numpy(), rays, np.asarray(jst.accum), jr.total_rays)


def test_spheres_render_matches_jax():
    b = j_load_scene(os.path.join(REPO, "tests", "goldens", "scn", "spheres.scn"))
    b.width, b.height = 32, 24
    r, st, rays, jr, jst = render_both(b.build(), textured=True)
    assert_images_agree(st.accum.numpy(), rays, np.asarray(jst.accum), jr.total_rays)


def test_textured_sky_emission_matches_jax():
    """The equirect sky of spheres.scn: the same texel as tracy_tpu's
    sky_emission, but for directions where torch's atan2/asin and XLA's
    part by an ulp at a texel edge (at most 0.1%)."""
    from tracy_tpu.render.integrator import sky_emission as j_sky
    from tracy_tpu_torch.render.integrator import sky_emission

    jscene = j_load_scene(os.path.join(REPO, "tests", "goldens", "scn", "spheres.scn")).build()
    d = np.random.default_rng(10).standard_normal((4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    got = sky_emission(from_jax_arrays(jscene, device="cpu"), torch.as_tensor(d)).numpy()
    ref = np.asarray(j_sky(jscene, jnp.asarray(d)))
    assert (got != ref).any(axis=1).mean() <= 1e-3
    assert got.std() > 0  # a real texture, not the constant sky
