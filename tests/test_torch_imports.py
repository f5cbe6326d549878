"""tracy_tpu_torch must load and render where jax does not exist (the GPU
machine has none). A fresh interpreter with `sys.modules['jax'] = None`
(so any `import jax` raises) imports every module of the port, renders
furnace.scn at 32x24 for one frame and the textured spheres.scn (HDR sky)
at 16x12 for one frame on CPU, takes one training step on furnace.scn
through tracy_tpu_torch.diff (a depth AOV too), renders furnace.scn
over a 2x1 mesh of CPU cells (tracy_tpu_torch.parallel) under a
profiler trace (utils/profiling.py), and reports which
tracy_tpu modules got loaded: none may be, since the port keeps its own
copies of what it needs (config, utils.native, utils.log).
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
from tracy_tpu_torch import diff
tcfg = RenderConfig(width=32, height=24, spp=1, max_bounces=3, tonemap="none")
step, params, opt = diff.make_train_step(
    scene, tcfg, intersect_fn=diff.make_training_intersector(scene, tcfg, False))
params, opt, loss = step(params, opt, torch.zeros((24, 32, 3)), 0)
dcfg = tcfg.replace(aov="depth")
dst, _ = Renderer(dcfg).step(scene, init_state(dcfg, "cpu"))
from tracy_tpu_torch.parallel import make_render_mesh, make_sharded_render_step, replicate_scene
from tracy_tpu_torch.utils.profiling import trace
mesh = make_render_mesh(2, 1, devices=["cpu", "cpu"])
with trace(TRACE_DIR):
    mst, mrays = make_sharded_render_step(cfg, mesh)(replicate_scene(scene, mesh),
                                                     init_state(cfg, "cpu"))
print(json.dumps({
    "loss": float(loss), "albedo_moved": bool((params.albedo != scene.materials.albedo).any()),
    "depth_max": float(dst.accum.max()),
    "shape": list(img.shape), "finite": bool(np.isfinite(img).all()),
    "corner": float(st.accum[0, 0, 0]), "rays": rays,
    "spheres_finite": bool(np.isfinite(sst.accum.numpy()).all()),
    "mesh_equal": bool(torch.equal(mst.accum, st.accum)) and int(mrays) == rays,
    "trace": os.path.getsize(os.path.join(TRACE_DIR, "trace.json")) > 0,
    "spheres_fallbacks": sb.fallbacks,
    "tracy_tpu": sorted(k for k in sys.modules if k.startswith("tracy_tpu.")
                        or k == "tracy_tpu"),
}))
""".replace("REPO", repr(REPO))


def test_port_imports_and_renders_without_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    script = SCRIPT.replace("TRACE_DIR", repr(str(tmp_path / "trace")))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["shape"] == [24, 32, 3] and res["finite"]
    assert res["corner"] == 1.0  # the white sky, seen directly
    assert res["rays"] >= 32 * 24
    assert res["spheres_finite"] and res["spheres_fallbacks"] == []
    assert res["loss"] > 0 and res["albedo_moved"] and res["depth_max"] > 0
    assert res["mesh_equal"] and res["trace"]
    assert res["tracy_tpu"] == [], res["tracy_tpu"]
