"""tracy_tpu_torch must load and render where jax does not exist (the GPU
machine has none). A fresh interpreter with `sys.modules['jax'] = None`
(so any `import jax` raises) imports every module of the port, renders
furnace.scn at 32x24 for one frame and the textured spheres.scn (HDR sky)
at 16x12 for one frame on CPU, and reports which tracy_tpu modules got
loaded: none may be, since the port keeps its own copies of what it needs
(config, utils.native, utils.log).
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import json, os, pkgutil, sys, importlib
sys.modules["jax"] = None
sys.path.insert(0, REPO)
import numpy as np
import torch
torch.set_num_threads(2)
import tracy_tpu_torch
for m in pkgutil.walk_packages(tracy_tpu_torch.__path__, "tracy_tpu_torch."):
    importlib.import_module(m.name)
from tracy_tpu_torch import RenderConfig
from tracy_tpu_torch.render.renderer import Renderer, init_state
from tracy_tpu_torch.scene import load_scene
b = load_scene(os.path.join(REPO, "tests", "goldens", "scn", "furnace.scn"))
b.width, b.height = 32, 24
scene = b.build(device="cpu")
cfg = RenderConfig(width=32, height=24, spp=1)
r = Renderer(cfg)
st, rays = r.step(scene, init_state(cfg, "cpu"))
img = r.display(st)
sb = load_scene(os.path.join(REPO, "tests", "goldens", "scn", "spheres.scn"))
sb.width, sb.height = 16, 12
scfg = RenderConfig(width=16, height=12, spp=1)
sst, _ = Renderer(scfg).step(sb.build(device="cpu"), init_state(scfg, "cpu"))
print(json.dumps({
    "shape": list(img.shape), "finite": bool(np.isfinite(img).all()),
    "corner": float(st.accum[0, 0, 0]), "rays": rays,
    "spheres_finite": bool(np.isfinite(sst.accum.numpy()).all()),
    "spheres_fallbacks": sb.fallbacks,
    "tracy_tpu": sorted(k for k in sys.modules if k.startswith("tracy_tpu.")
                        or k == "tracy_tpu"),
}))
""".replace("REPO", repr(REPO))


def test_port_imports_and_renders_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                         text=True, env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["shape"] == [24, 32, 3] and res["finite"]
    assert res["corner"] == 1.0  # the white sky, seen directly
    assert res["rays"] >= 32 * 24
    assert res["spheres_finite"] and res["spheres_fallbacks"] == []
    assert res["tracy_tpu"] == [], res["tracy_tpu"]
