"""Textures, the textured parser, the port's own RenderConfig and its default
device, against tracy_tpu on the same inputs.

Contract: the host side (image decoding, atlas packing, the parser, OBJ
loading, tangents) is a numpy copy of the JAX package's, so every array of
the port's build() must EQUAL tracy_tpu's. Files a scene names but the
parser cannot load are replaced as in the JAX package, and each
substitution is listed in `builder.fallbacks`.
"""

import os

import numpy as np
import pytest
import torch

from tracy_tpu.scene import scene as jscene_mod
from tracy_tpu.scene import scn_parser as jscn
from tracy_tpu_torch.scene import scene as tscene_mod
from tracy_tpu_torch.scene import scn_parser as tscn
from tracy_tpu_torch.scene import from_jax_arrays
from test_torch_scene import assert_scenes_equal

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def textured_builders():
    """tests/test_pallas_texfetch.py's fixture in both packages, from one
    seed: a fully textured material (5 slots, 20x24, not a power of two), a
    basecolor-only one (8x8), an untextured one, and a 16x32 equirect sky
    over a constant sky colour. Returns (tracy_tpu builder, port builder)."""
    out = []
    for mod in (jscene_mod, tscene_mod):
        rng = np.random.default_rng(42)
        b = mod.SceneBuilder(32, 24, "texfix")
        sky = rng.uniform(0.0, 3.0, (16, 32, 4)).astype(np.float32)
        b.set_sky_color((0.1, 0.2, 0.3))
        b.set_sky_texture(b.add_texture(sky))
        m1 = b.add_material((0.5, 0.4, 0.3), roughness=0.7, metalness=0.2)
        for slot in (mod.TEX_BASECOLOR, mod.TEX_NORMAL, mod.TEX_ROUGHNESS,
                     mod.TEX_METALNESS, mod.TEX_EMISSIVE):
            img = rng.uniform(0.0, 1.0, (20, 24, 4)).astype(np.float32)
            b.set_material_texture(m1, slot, b.add_texture(img))
        m2 = b.add_material((0.2, 0.8, 0.2), roughness=0.3)
        b.set_material_texture(m2, mod.TEX_BASECOLOR, b.add_texture(
            rng.uniform(0.0, 1.0, (8, 8, 4)).astype(np.float32)))
        m3 = b.add_material((0.9, 0.1, 0.1), roughness=1.0)
        b.add_sphere((0.0, 0.0, -3.0), 1.0, m1, steps=8)
        b.add_box((-2.5, -1.0, -4.0), (-1.0, 0.5, -2.5), m2)
        b.add_triangle((1.0, -1.0, -2.0), (2.5, -1.0, -2.0), (1.5, 1.0, -2.5), m3)
        b.set_camera((0, 0, 2), (0, 0, -3), (0, 1, 0), 60.0)
        out.append(b)
    return tuple(out)


def _write_hdr(path, rgb):
    """A flat (not run-length coded) Radiance file of float RGB [h, w, 3],
    w < 8 so the decoder takes the flat branch."""
    h, w, _ = rgb.shape
    m = np.max(rgb, axis=-1)
    e = np.where(m > 0, np.floor(np.log2(np.maximum(m, 1e-30))) + 1, 0)
    mant = np.where(m[..., None] > 0, rgb / np.exp2(e)[..., None] * 256.0, 0)
    rgbe = np.concatenate([np.clip(mant, 0, 255), np.where(m > 0, e + 128, 0)[..., None]],
                          axis=-1).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def _write_textured_scn(tmp_path):
    """A TEX / SKY <file> / TRI scene whose files sit beside it."""
    from PIL import Image

    rng = np.random.default_rng(5)
    Image.fromarray(rng.integers(0, 256, (6, 10, 3), dtype=np.uint8)).save(tmp_path / "bc.png")
    _write_hdr(tmp_path / "rough.hdr", rng.uniform(0.0, 1.0, (4, 4, 3)).astype(np.float32))
    _write_hdr(tmp_path / "sky.hdr", rng.uniform(0.0, 4.0, (4, 6, 3)).astype(np.float32))
    (tmp_path / "mesh.obj").write_text(
        "o quad\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nvn 0 0 1\n"
        "f 1/1/1 2/2/1 3/3/1 4/4/1\n"
        "o tri\nv 2 0 0\nv 3 0 0\nv 2 1 -0.5\nvt 0.2 0.1\nvt 0.9 0.3\nvt 0.4 0.8\n"
        "f 5/5 6/6 7/7\n")
    scn = tmp_path / "tex.scn"
    scn.write_text(
        "SCN Tex\nOUT 32 24\nCAM (0, 0.5, 3) (0.5, 0.5, 0) (0, 1, 0) 50\n"
        "MTL Painted (0.5, 0.5, 0.5) 0.8 0.1\n"
        "MTL Plain (0.2, 0.3, 0.4) 0.5 0\n"
        "TEX Painted B bc.png SRGB\n"
        "TEX Painted R rough.hdr\n"
        "SKY sky.hdr\n"
        "OBJ S (0, 0, -1) 0.5 Plain\n"
        "TRI mesh.obj Painted (0.1, 0, 0) (0, 30, 0) 1.5\n")
    return str(scn)


def test_textured_scn_builds_equal(tmp_path):
    path = _write_textured_scn(tmp_path)
    jb, tb = jscn.load_scene(path), tscn.load_scene(path)
    assert tb.fallbacks == []
    ts = tb.build(device="cpu")
    assert ts.tex_table.shape[0] == 3 and ts.num_triangles > 3
    assert_scenes_equal(ts, jb.build())


def test_missing_files_are_listed_as_fallbacks(tmp_path):
    scn = tmp_path / "x.scn"
    scn.write_text("MTL Grey (0.5, 0.5, 0.5) 1 0\nTEX Grey B nowhere.png\n"
                   "SKY nowhere.hdr\nTRI nowhere.obj Grey\n")
    tb, jb = tscn.load_scene(str(scn)), jscn.load_scene(str(scn))
    assert tb.fallbacks == ["texture nowhere.png", "texture nowhere.hdr", "mesh nowhere.obj"]
    assert_scenes_equal(tb.build(device="cpu"), jb.build())


def test_from_jax_arrays_round_trips_a_textured_scene():
    jb, tb = textured_builders()
    js = jb.build()
    got = from_jax_arrays(js, device="cpu")
    assert_scenes_equal(got, js)
    assert_scenes_equal(tb.build(device="cpu"), js)


def test_render_config_defaults_match():
    import dataclasses

    from tracy_tpu.config import RenderConfig as JConfig
    from tracy_tpu_torch import config as tconfig
    from tracy_tpu_torch.config import RenderConfig

    ours, theirs = RenderConfig(), JConfig()
    names = [f.name for f in dataclasses.fields(RenderConfig)]
    assert len(names) == 19  # 18 until ray_chunk joined
    for name in names:
        assert getattr(ours, name) == getattr(theirs, name), name
    from tracy_tpu import config as jconfig
    for const in ("AOVS", "TONEMAPS", "ACCELS", "RNGS"):
        assert getattr(tconfig, const) == getattr(jconfig, const), const


def test_bvh_width_is_validated_and_bound():
    """pallas_bvh_width defaults to tracy_tpu's 4, takes 2 and 8, as
    tracy_tpu does, refuses anything else, and the Renderer builds its
    tables at that width."""
    from tracy_tpu_torch.config import RenderConfig
    from tracy_tpu_torch.render.renderer import Renderer

    assert RenderConfig().pallas_bvh_width == 4
    for bad in (3, 16):
        with pytest.raises(ValueError, match="2, 4 or 8"):
            RenderConfig(pallas_bvh_width=bad)
    scene = tscn.load_scene(os.path.join(REPO, "tests", "goldens", "scn",
                                         "cornell.scn")).build(device="cpu")
    for width in (2, 4, 8):
        r = Renderer(RenderConfig(width=32, height=32, pallas_bvh_width=width))
        r.prepare(scene)
        assert r.tables.width == width and (r.tables.wide is None) == (width == 2)
        if width > 2:
            assert r.tables.wide.shape[1] == 8 * width


def test_default_device_is_the_card():
    """build(), Camera.setup() and from_jax_arrays() put tensors on cuda:0
    unless asked for the CPU, and raise where there is no card."""
    from tracy_tpu_torch.core.camera import Camera

    jb, tb = textured_builders()
    js = jb.build()
    calls = (tb.build,
             lambda: Camera.setup((0, 0, 1), (0, 0, 0), (0, 1, 0), 60.0, 4 / 3),
             lambda: from_jax_arrays(js))
    for call in calls:
        if torch.cuda.is_available():
            got = call()
            dev = got.device if hasattr(got, "device") else got.eye.device
            assert dev == torch.device("cuda", 0)
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
