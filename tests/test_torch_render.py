"""The port's Renderer on CPU against tracy_tpu's Renderer(accel='bvh',
use_pallas=False): same scene arrays, same seed, cornell at 64x64, 2 frames.

Both sides draw the same random numbers (bit-identical counter RNG), so the
paths are the same paths, and the images agree far more closely than two
independent estimates would. A path can still part ways where an ulp of
torch CPU vs XLA CPU flips a discrete decision, and one flipped path that
reaches the light moves a 16x16 block mean by up to about 0.03. Tolerances,
in linear radiance (the light is 15):

* mean over the image: 1e-3;  p95 of |block diff|: 5e-3;  max: 0.05;
* ray counts (one per live lane per bounce): within 0.1%.
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
from tracy_tpu_torch.render.renderer import Renderer, init_state
from tracy_tpu_torch.scene import from_jax_arrays
from tracy_tpu_torch.utils.parity import block_means

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cornell_render_matches_jax():
    b = j_load_scene(os.path.join(REPO, "tests", "goldens", "scn", "cornell.scn"))
    b.width = b.height = 64
    jscene = b.build()
    cfg = RenderConfig(width=64, height=64, spp=1, accel="bvh", use_pallas=False)
    jr = JRenderer(cfg)
    jst, _ = jr.step_many(jscene, j_init_state(cfg), 2)
    ref = np.asarray(jst.accum)

    cfg_t = cfg.replace(accel="packet")
    r = Renderer(cfg_t)
    k1_before, k2_before = k1.COUNT.plain, k2.COUNT.plain
    st, rays = r.step_many(from_jax_arrays(jscene), init_state(cfg_t, "cpu"), 2)
    got = st.accum.numpy()
    assert st.frame == 2
    assert k1.COUNT.plain - k1_before == k2.COUNT.plain - k2_before == 2 * cfg.max_bounces

    assert np.isfinite(got).all()
    assert abs(rays - jr.total_rays) <= 1e-3 * jr.total_rays
    d = np.abs(block_means(got) - block_means(ref))
    assert abs(float(got.mean()) - float(ref.mean())) <= 1e-3
    assert float(np.percentile(d, 95)) <= 5e-3
    assert float(d.max()) <= 0.05
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
    got = sky_emission(from_jax_arrays(jscene), torch.as_tensor(d))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_sky(jscene, jnp.asarray(d))))
