"""Two processes on the CPU, joined over gloo (parallel/distributed.py).

The test runs this file twice as a script, ranks 0 and 1, which join the
process group through initialize_multihost, build a 2x1 mesh of one CPU
cell each and
  * check that their host_rows are disjoint and cover the image,
  * render 2 progressive frames (the frame summed over the ranks),
  * take one sharded SGD(1.0) step (gradients summed over the ranks),
and rank 0 writes the accumulator, the rays and the gradients. The test
holds them against one process: the render bit for bit, the gradients
within rtol 1e-4, atol 1e-6 (their summation order), as
tests/test_multiprocess.py holds tracy_tpu's. Process groups live only in
the two subprocesses, never in a pytest worker.

Run by hand: python tests/test_torch_multiprocess.py RANK 2 PORT OUT.npz
in two shells (RANK 0 and 1).
"""

import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 16, 8


def setup():
    import torch

    from tracy_tpu_torch import RenderConfig
    from tracy_tpu_torch.scene import load_scene

    b = load_scene(os.path.join(REPO, "tests", "goldens", "scn", "furnace.scn"))
    b.width, b.height = W, H
    cfg = RenderConfig(width=W, height=H, spp=1, max_bounces=2, tonemap="none", accel="none",
                       russian_roulette=False)
    return b.build(device="cpu"), cfg, torch.full((H, W, 3), 0.25)


def sgd(ps):
    import torch

    return torch.optim.SGD(ps, lr=1.0)


def worker(rank: int, nproc: int, port: str, out: str) -> int:
    import torch
    import torch.distributed as dist

    from tracy_tpu_torch.parallel import (
        make_render_mesh, make_sharded_render_step, make_sharded_train_step, replicate_scene)
    from tracy_tpu_torch.parallel.distributed import all_sum, host_rows, initialize_multihost
    from tracy_tpu_torch.render.renderer import init_state

    torch.set_num_threads(1)
    assert initialize_multihost(f"localhost:{port}", nproc, rank, backend="gloo")
    try:
        scene, cfg, target = setup()
        mesh = make_render_mesh(2, 1, devices=["cpu"])
        lo, hi = host_rows(H, mesh)
        span = torch.zeros(H, dtype=torch.int64)
        span[lo:hi] = 1
        all_sum(span)  # every row owned exactly once
        assert hi > lo and bool((span == 1).all()), span

        step = make_sharded_render_step(cfg, mesh)
        sc = replicate_scene(scene, mesh)
        st, rays = init_state(cfg, "cpu"), 0
        for _ in range(2):
            st, r = step(sc, st)
            rays += int(r)

        tstep, params, opt = make_sharded_train_step(scene, cfg, mesh, optimizer=sgd)
        tstep(params, opt, target, 0)
        grads = {f"g_{n}": p.grad.numpy() for n, p in zip(params._fields, params)
                 if p.grad is not None}
        if rank == 0:
            np.savez(out, accum=st.accum.numpy(), rays=rays, rows=np.asarray([lo, hi]), **grads)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_match_one(tmp_path):
    from tracy_tpu_torch.diff import make_train_step
    from tracy_tpu_torch.render.renderer import Renderer, init_state

    out = str(tmp_path / "mp.npz")
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-u", os.path.abspath(__file__), str(r), "2",
                               port, out], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        # The one-process reference, while the ranks run.
        scene, cfg, target = setup()
        st, rays = Renderer(cfg).step_many(scene, init_state(cfg, "cpu"), 2)
        step, params, opt = make_train_step(scene, cfg, optimizer=sgd)
        step(params, opt, target, 0)
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
    with np.load(out) as got:
        assert list(got["rows"]) == [0, H // 2]
        np.testing.assert_array_equal(got["accum"], st.accum.numpy())
        assert int(got["rays"]) == rays
        names = [n for n, p in zip(params._fields, params) if p.grad is not None]
        assert sorted(names) == sorted(k[2:] for k in got.files if k.startswith("g_"))
        for n in names:
            np.testing.assert_allclose(got[f"g_{n}"], getattr(params, n).grad.numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=n)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]))
