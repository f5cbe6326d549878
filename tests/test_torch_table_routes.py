"""The table routes of K2, K3 and K4 (ops/launch.py): where the material
and texture tables go, chosen from their bytes alone. The kernels
themselves run on the card (tests/test_torch_kernels.py, chip_smoke.py);
here the pure choice at its boundaries, the bytes each wrapper counts, the
refusal of a named route that cannot hold the tables, and the plain
versions at table sizes the old 48 KB limit refused.
"""

import numpy as np
import pytest
import torch

from tracy_tpu_torch.ops import compare, launch
from tracy_tpu_torch.ops import shade as k2
from tracy_tpu_torch.ops import texfetch as k3
from tracy_tpu_torch.ops.launch import SMEM_DEFAULT, table_route

H100_OPTIN = 232_448  # cudaDevAttrMaxSharedMemoryPerBlockOptin of an H100


@pytest.mark.parametrize("nbytes,route", [
    (0, "shared"),
    (1, "shared"),
    (SMEM_DEFAULT - 1, "shared"),
    (SMEM_DEFAULT, "shared"),
    (SMEM_DEFAULT + 1, "global"),  # staging above 48 KB ran slower (PERF.md)
    (96 * 1024, "global"),
    (H100_OPTIN, "global"),
    (10 ** 9, "global"),
])
def test_table_route_boundaries(nbytes, route):
    assert table_route(nbytes) == route


def test_main_path_tables_stay_shared():
    """The main paths' few materials (grid64x28: 2; its textured twin: 4
    materials over 7 textures) keep the staged route on every kernel."""
    assert table_route(4 * k2.MTAB_COLS * 2) == "shared"
    assert table_route(k3.table_bytes(4, 7)) == "shared"
    assert table_route(4 * k2.MTAB_TEX_COLS * 4 + k3.table_bytes(4, 7)) == "shared"


@pytest.mark.parametrize("materials,textures,k2_route,k3_route,k4_route", [
    (2, 0, "shared", "shared", "shared"),  # the main path's tables
    (1228, 0, "shared", "shared", "global"),  # K2's last staged count
    (1229, 0, "global", "shared", "global"),
    (2000, 0, "global", "shared", "global"),
    (8000, 0, "global", "global", "global"),
    (299, 1495, "shared", "shared", "shared"),  # K4's last staged count at five maps
    (300, 1500, "shared", "shared", "global"),
    (400, 2000, "shared", "shared", "global"),
    (491, 2455, "shared", "shared", "global"),  # K3's last staged count at five maps
    (492, 2460, "shared", "global", "global"),
    (520, 2600, "shared", "global", "global"),
    (3000, 15000, "global", "global", "global"),
])
def test_each_kernels_bytes_pick_its_route(materials, textures, k2_route, k3_route, k4_route):
    """Staged while the tables fit the 48 KB a block gets by default: K2
    40 bytes a material, K3 20 a material and 16 a texture, K4 64 + 20 a
    material and 16 a texture."""
    k2_bytes = 4 * k2.MTAB_COLS * materials
    k3_bytes = k3.table_bytes(materials, textures)
    assert k3_bytes == 16 * textures + 20 * materials
    k4_bytes = 4 * k2.MTAB_TEX_COLS * materials + k3_bytes
    got = [table_route(b) for b in (k2_bytes, k3_bytes, k4_bytes)]
    assert got == [k2_route, k3_route, k4_route]


def test_pick_route_refuses_a_named_route_that_cannot_hold_the_tables():
    assert launch.pick_route("shade", 1000) == ("shared", 1000)
    assert launch.pick_route("shade", SMEM_DEFAULT) == ("shared", SMEM_DEFAULT)
    assert launch.pick_route("shade", 80_000) == ("global", 0)
    assert launch.pick_route("shade", 320_000) == ("global", 0)
    assert launch.pick_route("shade", 1000, "global") == ("global", 0)
    with pytest.raises(ValueError, match="do not fit the 'shared' route"):
        launch.pick_route("shade", 80_000, "shared")
    with pytest.raises(ValueError, match="unknown table route"):
        launch.pick_route("shade", 1000, "optin")


def test_launch_count_keeps_routes():
    c = launch.LaunchCount()
    c.launched("shared")
    c.launched("global")
    c.launched("global")
    assert (c.kernel, c.routes) == (3, {"shared": 1, "global": 2})
    c.reset()
    assert (c.kernel, c.plain, c.routes) == (0, 0, {})


def _many_materials(m, textures, seed):
    """A material table of m rows and tex_index rows over `textures`
    one-texel-by-two textures, as SceneBuilder would lay them out."""
    rng = np.random.default_rng(seed)
    mtab = torch.as_tensor(rng.uniform(0.0, 1.0, (m, k2.MTAB_TEX_COLS)).astype(np.float32))
    mtab[:, 5] = 1.5  # ior
    mtab[:, 9] = 0.0  # opaque
    tex_index = torch.as_tensor(rng.integers(-1, textures, (m, 5)).astype(np.int32))
    mtab[:, k2.HAS_COL:k2.HAS_COL + 5] = (tex_index >= 0).float()
    tex_table = torch.as_tensor(np.stack([2 * np.arange(textures), np.full(textures, 2),
                                          np.ones(textures), np.zeros(textures)], 1)
                                .astype(np.int32))
    tex_data = torch.as_tensor(rng.uniform(0.0, 1.0, (2 * textures, 4)).astype(np.float32))
    return mtab, tex_data, tex_table, tex_index


def test_plain_versions_take_tables_the_old_limit_refused():
    """On CPU tensors K2, K3 and K4 run their plain versions at any table
    size: 8,000 untextured materials (320,000 bytes on the card) and 3,000
    textured ones over 15,000 textures."""
    for c in (k2.COUNT, k2.COUNT_TEX, k3.COUNT):
        c.reset()
    lanes = compare.textured_lanes(8000, 512, seed=1, device="cpu")
    mtab = _many_materials(8000, 1, seed=4)[0][:, :k2.MTAB_COLS].contiguous()
    st = k2.shade(*compare.state_args(lanes, compare.SHADE_ARGS), mtab, 3, 1, seed=7,
                  russian_roulette=True)
    assert all(bool(torch.isfinite(x.float()).all()) for x in st)

    mtab_t, tex_data, tex_table, tex_index = _many_materials(3000, 15000, seed=2)
    tl = compare.textured_lanes(3000, 512, seed=3, device="cpu")
    rows = k3.fetch_texels(*(tl[k] for k in compare.TEXFETCH_ARGS), tex_data, tex_table,
                           tex_index)
    assert rows.shape == (512, 12) and bool((rows != 0).any())
    st = k2.shade_textured(*compare.textured_args(tl), mtab_t, tex_data, tex_table, tex_index,
                           3, 1, seed=7, russian_roulette=True)
    assert all(bool(torch.isfinite(x.float()).all()) for x in st)
    assert (k2.COUNT.plain, k3.COUNT.plain, k2.COUNT_TEX.plain) == (1, 1, 1)
    assert k2.COUNT.kernel == k3.COUNT.kernel == k2.COUNT_TEX.kernel == 0
