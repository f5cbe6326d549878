"""Rendering and training over a ('data', 'sample') mesh of devices.

Port of tracy_tpu/parallel/mesh.py on torch. A mesh is a grid of cells,
each a torch.device:

  * 'data'   - the image rows are split over it, a band of H / n_data
               rows a cell;
  * 'sample' - the samples per pixel are split over it, spp / n_sample a
               cell, and the cells' radiance is averaged.

The RNG streams are keyed by the global pixel and sample ids, so a split
over 'data' renders the single-device frame bit for bit, and one over
'sample' the same values up to float32 summation order.

The scene is replicated: one copy, one set of BVH tables and one material
table for each distinct device (bind_stages), whatever the number of
cells on it. A device may hold several cells, which then run one after
the other; so the CPU tests and a single card run any mesh shape. Under a
process group (parallel/distributed.py) the mesh spans all ranks: each
rank owns a contiguous run of cells, renders them on its own devices,
and the frame, the ray count and the gradients are summed over the ranks
(all_sum), so every rank holds the whole accumulator and the same
parameters. Each cell runs the single-device stages on its band: on the
card K1 and K2 (or K4 on a textured scene) with compaction and bounce 0
peeled where cfg asks for them.

torch's collectives carry no gradient (JAX's pmean inside shard_map
does, and tracy_tpu's train step relies on it). The train step renders
every cell's band with autograd, forms the sample-averaged frame and the
loss without it, and backpropagates each band with its share of the
loss's gradient, 2 (r - t) / (N n_sample); the parameter gradients are
then summed over the ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from tracy_tpu_torch.config import RenderConfig
from tracy_tpu_torch.diff.gradients import TrainableParams, make_trainable, render_radiance
from tracy_tpu_torch.parallel.distributed import all_sum, rank_device, world
from tracy_tpu_torch.render import film
from tracy_tpu_torch.render.renderer import RenderState, bind_stages, sample_radiance_rows
from tracy_tpu_torch.scene.scene import SceneArrays
from tracy_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class RenderMesh:
    """A ('data', 'sample') grid of cells. Cell c = di * n_sample + si
    belongs to rank owners[c]; devices[c] is its device on that rank
    (None for the cells of other ranks)."""

    shape: Dict[str, int]
    devices: Tuple[Optional[torch.device], ...]
    owners: Tuple[int, ...]
    rank: int

    def cells(self) -> List[Tuple[int, int, torch.device]]:
        """(di, si, device) of this rank's cells, in cell order."""
        ns = self.shape["sample"]
        return [(c // ns, c % ns, d) for c, (d, r) in enumerate(zip(self.devices, self.owners))
                if r == self.rank]

    def local_devices(self) -> List[torch.device]:
        """This rank's distinct devices, in cell order."""
        return list(dict.fromkeys(d for _, _, d in self.cells()))

    @property
    def home(self) -> torch.device:
        """Where the accumulator, the parameters and the target live: the
        device of this rank's first cell."""
        return self.local_devices()[0]


def make_render_mesh(n_data: Optional[int] = None, n_sample: int = 1,
                     devices=None) -> RenderMesh:
    """A ('data', 'sample') mesh of n_data x n_sample cells.

    devices: this rank's cells' devices, in cell order; one device may be
    named for several cells. None: every visible card, one cell each, or,
    under a process group, this rank's card (rank_device); it raises
    without a card. Under a process group every rank gives the same count,
    and rank r owns cells r * k .. r * k + k - 1. n_data None: the cells
    over n_sample.
    """
    rank, nproc = world()
    if devices is None:
        if nproc > 1:
            devices = [rank_device()]
        else:
            resolve_device("cuda")  # raises without a card
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    local = [resolve_device(d) for d in devices]
    n = len(local) * nproc
    if n_data is None and n_sample >= 1:
        n_data = n // n_sample
    if n_data is None or n_data < 1 or n_sample < 1:
        raise ValueError(f"mesh {n_data}x{n_sample}: each axis needs at least one cell")
    if n_data * n_sample != n:
        raise ValueError(f"mesh {n_data}x{n_sample} != {n} devices")
    k = len(local)
    return RenderMesh(shape={"data": n_data, "sample": n_sample},
                      devices=tuple(local[c % k] if c // k == rank else None for c in range(n)),
                      owners=tuple(c // k for c in range(n)), rank=rank)


def replicate_scene(scene: SceneArrays, mesh: RenderMesh) -> Dict[torch.device, SceneArrays]:
    """The scene on each of this rank's distinct devices."""
    return {d: scene.to(d) for d in mesh.local_devices()}


def _check_divisible(cfg: RenderConfig, mesh: RenderMesh):
    nd = mesh.shape["data"]
    ns = mesh.shape["sample"]
    if cfg.height % nd != 0:
        raise ValueError(f"height {cfg.height} not divisible by data axis {nd}")
    if cfg.spp % ns != 0:
        raise ValueError(f"spp {cfg.spp} not divisible by sample axis {ns}")
    return nd, ns


def _copies(scene, mesh: RenderMesh) -> Dict[torch.device, SceneArrays]:
    return scene if isinstance(scene, dict) else replicate_scene(scene, mesh)


def _band(cfg: RenderConfig, mesh: RenderMesh, di: int, si: int) -> dict:
    """sample_radiance_rows' band arguments of cell (di, si)."""
    rows_per = cfg.height // mesh.shape["data"]
    spp_per = cfg.spp // mesh.shape["sample"]
    return dict(row_offset=di * rows_per, num_rows=rows_per, spp_offset=si * spp_per,
                spp_count=spp_per, total_spp=cfg.spp)


def _one_device(mesh: RenderMesh, what: str):
    if len(mesh.local_devices()) > 1:
        raise ValueError(f"{what} runs on every cell, but this rank's cells lie on "
                         f"{len(mesh.local_devices())} devices; give none, or one device")


def _frame(cfg: RenderConfig, mesh: RenderMesh, bands) -> torch.Tensor:
    """The whole frame [H, W, 3] on mesh.home from the bands {(di, si):
    radiance} of this rank's cells: each data index's bands summed in
    sample order, the frames of all ranks summed (a rank writes only its
    rows), divided by n_sample."""
    ns = mesh.shape["sample"]
    rows_per = cfg.height // mesh.shape["data"]
    home = mesh.home
    out = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32, device=home)
    for di in sorted({di for di, _ in bands}):
        parts = [bands[(di, si)].to(home) for si in range(ns) if (di, si) in bands]
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        out[di * rows_per:(di + 1) * rows_per] = acc
    all_sum(out)
    if ns > 1:  # a tensor divisor: see core/camera.py::pixel_samples_rows
        out = out / torch.full((), ns, dtype=out.dtype, device=home)
    return out


def make_sharded_render_step(cfg: RenderConfig, mesh: RenderMesh, intersect_fn=None,
                             shade_fn=None, first_intersect_fn=None, **paths):
    """step(scene, state) -> (state', rays): one progressive frame over the
    mesh, equal to the single-device frame (bit for bit along 'data').

    scene: replicate_scene's copies (or one SceneArrays, replicated at each
    call). state: its accumulator [H, W, 3] on mesh.home. Each cell renders
    its band (sample_radiance_rows), the bands are averaged over 'sample'
    in sample order, the rays summed over every cell and rank, and the
    frame accumulated with film.accumulate. With no stage given, each
    device gets cfg's single-device stages (render/renderer.py::
    bind_stages: the intersector cfg.accel names, compaction, the shade or
    fused bounce stage), built once for it; tracy_tpu's sharded step runs
    its brute-force intersector instead. Stages given (intersect_fn,
    shade_fn, first_intersect_fn, sample_radiance_rows' **paths) run on
    every cell, whose devices must then be one.
    """
    _check_divisible(cfg, mesh)
    given = {k: v for k, v in dict(shade_fn=shade_fn, first_intersect_fn=first_intersect_fn,
                                   **paths).items() if v is not None}
    custom = intersect_fn is not None or bool(given)
    if custom:
        _one_device(mesh, "a stage function")
    bound = {}

    def stages(sc: SceneArrays):
        if sc.device not in bound:
            if custom:
                bound[sc.device] = (intersect_fn, given)
            else:
                st = bind_stages(sc, cfg)
                bound[sc.device] = (st.intersect, st.kwargs())
        return bound[sc.device]

    def step(scene, state: RenderState):
        copies = _copies(scene, mesh)
        home = mesh.home
        if state.accum.device != home:
            raise ValueError(f"the accumulator lies on {state.accum.device}, the mesh's "
                             f"home is {home}")
        bands = {}
        rays = torch.zeros((), dtype=torch.int64, device=home)
        for di, si, dev in mesh.cells():
            isect, kw = stages(copies[dev])
            bands[(di, si)], r = sample_radiance_rows(copies[dev], cfg, state.frame, isect,
                                                      **kw, **_band(cfg, mesh, di, si))
            rays = rays + r.to(home)
        radiance = _frame(cfg, mesh, bands)
        all_sum(rays)
        accum = (film.accumulate(state.accum, radiance, state.frame) if cfg.accumulate
                 else radiance)
        return RenderState(accum=accum, frame=state.frame + 1), rays

    return step


def make_sharded_train_step(scene, cfg: RenderConfig, mesh: RenderMesh, optimizer=None,
                            intersect_fn=None,
                            trainable_mask: Optional[TrainableParams] = None):
    """Returns (step_fn, params, opt_state), as diff/gradients.py::
    make_train_step does, for a step over the mesh.

    step_fn(params, opt_state, target, frame) -> (params, opt_state,
    loss): every cell renders its band differentiably (render_radiance:
    K1 under intersect_fn, None for the brute-force intersector, and
    shade_diff); the loss is the mean squared error over the whole image
    of the sample-averaged radiance against target [H, W, 3] on
    mesh.home; the parameter gradients are summed over all cells and
    ranks, masked by trainable_mask and handed to the optimizer (default
    Adam at lr 1e-2), in place on params, which live on mesh.home. An
    intersect_fn runs on every cell, whose devices must then be one; each
    rank gives its own.
    """
    nd, ns = _check_divisible(cfg, mesh)
    if intersect_fn is not None:
        _one_device(mesh, "intersect_fn")
    copies = _copies(scene, mesh)
    home = mesh.home
    tr = make_trainable(copies[home], optimizer, trainable_mask)
    rows_per = cfg.height // nd

    def step(params: TrainableParams, opt_state, target, frame: int):
        opt_state.zero_grad(set_to_none=True)
        bands = {}
        for di, si, dev in mesh.cells():
            on_dev = TrainableParams(*(p.to(dev) for p in params))
            bands[(di, si)], _ = render_radiance(on_dev, copies[dev], cfg, frame, intersect_fn,
                                                 **_band(cfg, mesh, di, si))
        with torch.no_grad():
            residual = _frame(cfg, mesh, {k: v.detach() for k, v in bands.items()}) - target
            loss = torch.mean(residual ** 2)
            # d loss / d band = 2 (r - t) / (N n_sample) on the band's rows.
            scale = torch.full((), 2.0 / (residual.numel() * ns), device=home)
            grads = [(residual[di * rows_per:(di + 1) * rows_per] * scale).to(b.device)
                     for (di, _), b in bands.items()]
        torch.autograd.backward(list(bands.values()), grads)
        for p in params:
            if p.grad is not None:
                all_sum(p.grad)
        tr.update(params, opt_state)
        return params, opt_state, loss

    return step, tr.params, tr.opt_state
