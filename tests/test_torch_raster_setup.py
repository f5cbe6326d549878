"""The raster preview's triangle set-up (raster/rasterizer.py::
_triangle_setup) against tracy_tpu's, on the CPU: the edge functions, the
1/w interpolator, the inverse vertex matrix and the culling flags equal
tracy_tpu's _triangle_setup run eagerly (one XLA op at a time, each
rounded as torch rounds it) bit for bit, on the default scene and on
cornell at 64x48. (Under jax.jit XLA contracts the mul-adds; the images
are held against the jitted rasterizer in tests/test_torch_raster.py.)
"""

import numpy as np
import pytest
import torch

from tracy_tpu.raster.rasterizer import _triangle_setup as j_triangle_setup
from tracy_tpu_torch.raster.rasterizer import _triangle_setup
from tracy_tpu_torch.scene import from_jax_arrays
from test_torch_raster import H, W, _jax_scene

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["default", "cornell"])
def test_triangle_setup_equals_eager_xla(name):
    js = _jax_scene(name)
    ref = [np.asarray(x) for x in j_triangle_setup(js, W, H)]  # eager: one XLA op at a time
    got = [x.numpy() for x in _triangle_setup(from_jax_arrays(js, device="cpu"), W, H)]
    for label, i in (("edges", 0), ("c_vec", 1), ("minv", 3), ("front", 4)):
        np.testing.assert_array_equal(got[i], ref[i], err_msg=label)
    assert ref[4].any() and not ref[4].all()
