"""K1 and K2 on the card against their plain PyTorch versions on the same
CUDA tensors, with the contracts of tracy_tpu_torch/ops/compare.py (those of
chip_smoke.py's kernel phase, at smaller sizes). Marked `cuda`: without an
NVIDIA GPU these tests skip. On a GPU machine without jax, where
tests/conftest.py cannot load, run them with

    python -m pytest tests/test_torch_kernels.py --noconftest -q
"""

import os

import numpy as np
import pytest
import torch

from tracy_tpu_torch import RenderConfig
from tracy_tpu_torch.accel.tables import build_tables
from tracy_tpu_torch.ops import compare
from tracy_tpu_torch.ops import intersect as k1
from tracy_tpu_torch.ops import shade as k2
from tracy_tpu_torch.render.renderer import Renderer, init_state
from tracy_tpu_torch.scene import load_scene, sphere_grid

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def test_intersect_kernel_matches_plain(cuda):
    scene = sphere_grid(64, 48, nsph=16, steps=16).build(device=cuda)
    tables = build_tables(scene)
    rays = compare.intersect_rays(scene, tables, 65536, seed=1)
    res = compare.compare_intersect(*rays, tables)
    assert res["hit_fraction"] > 0.2


@pytest.mark.parametrize("rr", [True, False])
def test_shade_kernel_matches_plain(cuda, rr):
    scene = load_scene(os.path.join(REPO, "data", "scenes", "default.scn")).build(device=cuda)
    mtab = k2.build_material_table(scene.materials)
    lanes = compare.canned_lanes(mtab.shape[0], 65536, seed=2, device=cuda)
    compare.compare_shade(lanes, mtab, 3, 1, seed=0xABCDEF, russian_roulette=rr)


def test_renderer_runs_on_the_kernels(cuda):
    scene = sphere_grid(64, 48, nsph=4, steps=12).build(device=cuda)
    cfg = RenderConfig(width=64, height=48, spp=1)
    r = Renderer(cfg)
    k1.COUNT.reset()
    k2.COUNT.reset()
    st, rays = r.step_many(scene, init_state(cfg, cuda), 2)
    assert k1.COUNT.kernel == k2.COUNT.kernel == 2 * cfg.max_bounces
    assert k1.COUNT.plain == k2.COUNT.plain == 0
    assert rays >= 2 * 64 * 48
    assert np.isfinite(r.display(st)).all()
