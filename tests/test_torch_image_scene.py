"""The image-texture fixture scene (tests/goldens/textured/, made by
tools/make_texture_fixtures.py: helmet.scn's five map slots as a
2048x2048 4:2:0 JPEG, a 4:4:4 JPEG, a progressive grey JPEG, a palette
PNG and a 16-bit PNG) through the port on the CPU.

* In a fresh interpreter, loading it imports no PIL module (and no jax),
  substitutes no file, and its maps equal the sizes the generator wrote.
* Its textured render at 64x48, 4 frames of 1 spp, against tracy_tpu's
  (XLA, accel 'bvh') on the CPU, by the linear block means of
  tests/test_ref_parity.py: |mean| <= 0.01, p95 <= 0.02, max <= 0.05. Both
  draw the same counter-hash numbers, so the renders agree far inside it
  (chip_smoke.py's 256x192 gate on an H100: mean 4e-5, p95 4.1e-4).
"""

import os
import subprocess
import sys

import numpy as np
import torch

from tracy_tpu.config import RenderConfig as JConfig
from tracy_tpu.render import film as jfilm
from tracy_tpu.render.renderer import Renderer as JRenderer
from tracy_tpu.render.renderer import init_state as jinit
from tracy_tpu.scene.scn_parser import load_scene as jload
from tracy_tpu_torch import RenderConfig
from tracy_tpu_torch.render.renderer import Renderer, init_state
from tracy_tpu_torch.scene import load_scene
from tracy_tpu_torch.utils import parity

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCN = os.path.join(REPO, "tests", "goldens", "textured", "textured.scn")
MAPS = [(2048, 2048), (1024, 1024), (512, 512), (512, 512), (256, 256)]


def loads_without_pil(scn, maps):
    """Load scn in a fresh interpreter: no fallback, the maps' sizes, no
    PIL (and no jax) module imported."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from tracy_tpu_torch.scene import load_scene\n"
        f"b = load_scene({scn!r})\n"
        "assert b.fallbacks == [], b.fallbacks\n"
        "print([tuple(p.shape[:2]) for p in b.atlas.pixels])\n"
        "print(sorted(k for k in sys.modules if k == 'PIL' or k.startswith('PIL.')))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    sizes, pil = out.stdout.strip().splitlines()[-2:]
    assert sizes == str(maps)
    assert pil == "[]"


def test_fixture_scene_loads_without_pil():
    loads_without_pil(SCN, MAPS)


def render_matches_tracy_tpu(scn):
    """The port's textured render of scn at 64x48, 4 frames, against
    tracy_tpu's on the CPU by the block-mean contract."""
    w, h, frames = 64, 48, 4
    b = load_scene(scn)
    assert b.fallbacks == []
    b.width, b.height = w, h
    cfg = RenderConfig(width=w, height=h, spp=1)
    r = Renderer(cfg)
    st, _ = r.step_many(b.build(device="cpu"), init_state(cfg, "cpu"), frames)
    ours = parity.srgb_to_linear(np.clip(r.display(st) * 255.99, 0.0, 255.0) / 255.99)

    jb = jload(scn)
    jb.width, jb.height = w, h
    jcfg = JConfig(width=w, height=h, spp=1, accel="bvh", use_pallas=False)
    jst = JRenderer(jcfg).render_progressive(jb.build(), frames, state=jinit(jcfg),
                                             steps_per_dispatch=frames)
    ref = np.clip(np.asarray(jfilm.tonemap(jst.accum, jcfg)) * 255.99, 0.0, 255.0)
    ref = parity.srgb_to_linear(ref / 255.99)
    dmean, p95, dmax = parity.compare(ref, ours)
    assert dmean <= 0.01 and p95 <= 0.02 and dmax <= 0.05, (dmean, p95, dmax)
    assert float(ours.std()) > 0.05  # the maps show: not a flat grey


def test_fixture_render_matches_tracy_tpu():
    render_matches_tracy_tpu(SCN)
