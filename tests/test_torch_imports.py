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

The port covers tracy_tpu's public names: every public function and class
of each tracy_tpu module is defined (or imported) by the port's module of
the same path, or listed below as ported elsewhere or not ported, with its
reason (ROADMAP.md, "Not ported"); the versions are equal.
"""

import ast
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


# tracy_tpu's public names that the port holds in another module.
PORTED_ELSEWHERE = {
    "accel/native.py": {"build_bvh_native": "accel/bvh_build.py"},
    "ops/pallas_packet.py": {"PallasSceneTables": "accel/tables.py::BVHTables",
                             "build_tables": "accel/tables.py",
                             "make_pallas_intersector": "ops/intersect.py::intersect",
                             "nondiff_intersector": "ops/intersect.py",
                             "pallas_intersect": "ops/intersect.py::intersect (K1)",
                             "pallas_trace_bounce": "ops/bounce.py::trace_bounce (K5)"},
    "ops/pallas_shade.py": {"build_material_table": "ops/shade.py",
                            "build_material_table_tex": "ops/shade.py",
                            "shade_packets": "ops/shade.py::shade (K2)",
                            "shade_packets_textured": "ops/shade.py::shade_textured (K4)",
                            "shade_planes": "csrc/shade_lane.cuh::shade_hit"},
    "ops/pallas_texfetch.py": {"fetch_texels": "ops/texfetch.py (K3)"},
}
# ROADMAP.md's "Not ported": TPU mechanics the port has no use for.
NOT_PORTED = {
    "accel/bvh.py": {"BVHArrays", "build_scene_bvh", "device_bvh", "intersect_bvh",
                     "make_bvh_intersector"},  # the XLA binary walk: 'bvh' is K1
    "accel/packet.py": {"PackedBVH", "PacketAttrs", "build_packet_bvh", "intersect_packet",
                        "make_packet_intersector", "pack_bvh", "prepare_packet_tri_data",
                        "prepare_packet_tri_data_host"},  # the XLA packet tier: K1
    "accel/bvh_build.py": {"pad_leaves"},  # leaves sized for 128-slot chunks
    "accel/reorder.py": {"pair_merge_backward", "pair_merge_forward",
                         "pair_merge_intersector"},  # the butterfly's packet merge
    "ops/pallas_texfetch.py": {"TexturePages", "build_texture_pages",
                               "lane_page_indices"},  # texel pages
    "utils/profiling.py": {"packet_hbm_bound", "packet_speed_of_light"},  # v5e rooflines
}


def _public_names(path, defs_only):
    out = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif not defs_only and isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif not defs_only and isinstance(node, ast.ImportFrom):
            out |= {a.asname or a.name for a in node.names}
    return {n for n in out if not n.startswith("_")}


def test_public_names_are_ported_or_listed():
    ref_root = os.path.join(REPO, "tracy_tpu")
    missing = []
    for root, _, files in os.walk(ref_root):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, f), ref_root)
            port = os.path.join(REPO, "tracy_tpu_torch", rel)
            have = _public_names(port, False) if os.path.exists(port) else set()
            listed = set(PORTED_ELSEWHERE.get(rel, {})) | NOT_PORTED.get(rel, set())
            missing += [f"{rel}::{n}" for n in sorted(_public_names(os.path.join(root, f), True)
                                                       - have - listed)]
    assert missing == [], missing
    for rel, names in PORTED_ELSEWHERE.items():
        for name, where in names.items():
            port = os.path.join(REPO, "tracy_tpu_torch", where.split("::")[0].split(" ")[0])
            assert os.path.exists(port), (rel, name, where)


def test_version_matches_tracy_tpu():
    import tracy_tpu
    import tracy_tpu_torch

    assert tracy_tpu_torch.__version__ == tracy_tpu.__version__

