"""Multi-process execution on torch.distributed.

Port of tracy_tpu/parallel/distributed.py. Every process runs the same
program: `initialize_multihost` joins the process group, the ('data',
'sample') mesh of parallel/mesh.py then spans every rank's cells, each
rank renders its own cells, and the frame, the ray counters and the
gradients are summed over the ranks with `all_sum`, so every rank ends a
step with the same accumulator and the same parameters.

    from tracy_tpu_torch.parallel.distributed import host_rows, initialize_multihost
    initialize_multihost("localhost:29500", 2, rank, backend="gloo")  # or under torchrun
    mesh = make_render_mesh(2, 1, devices=["cpu"])   # this rank's cells
    step = make_sharded_render_step(cfg, mesh)       # the same on every rank

The backend is NCCL when every rank has a card of its own, gloo on the
CPU; gloo also lets several ranks share one card (NCCL refuses that).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from tracy_tpu_torch.utils.device import resolve_device

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> bool:
    """Join the process group; True when more than one process joined.

    coordinator_address "host:port" (rank 0 listens there) with
    num_processes and process_id; or, with none of them, torchrun's
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT). Without
    either it returns False and starts nothing: one process. A failure to
    join raises; it never falls back to one process. backend: "nccl" when
    a card is visible, else "gloo" (None picks so). NCCL needs a card for
    each rank on this host (LOCAL_WORLD_SIZE, set by torchrun, counts
    them; without it every rank is taken to be on this host), and is
    refused otherwise with a message that names gloo.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None and not all(k in os.environ for k in TORCHRUN_ENV):
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and process_id")
        world = num_processes
        kw = dict(init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                  rank=process_id)
    else:
        world = int(os.environ["WORLD_SIZE"])
        kw = {}
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        cards = torch.cuda.device_count()
        if local > cards:
            raise RuntimeError(
                f"NCCL needs one card a rank: {local} ranks on this host, {cards} card(s); "
                "pass backend='gloo' to let ranks share a card")
    dist.init_process_group(backend, **kw)
    if backend == "nccl":
        torch.cuda.set_device(rank_device())
    return dist.get_world_size() > 1


def world() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_device() -> torch.device:
    """This rank's card: cuda:LOCAL_RANK (torchrun), else cuda:rank, modulo
    the visible cards. Raises without a card."""
    rank, _ = world()
    dev = resolve_device("cuda")
    return torch.device(dev.type, int(os.environ.get("LOCAL_RANK", rank))
                        % torch.cuda.device_count())


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum `x` over the ranks, in place, and return it; a no-op for one
    process. Under gloo a card's tensor goes through the host."""
    _, n = world()
    if n == 1:
        return x
    if x.device.type == "cuda" and dist.get_backend() == "gloo":
        host = x.cpu()
        dist.all_reduce(host)
        return x.copy_(host)
    dist.all_reduce(x)
    return x


def host_rows(height: int, mesh) -> Tuple[int, int]:
    """The [start, end) image rows this rank renders: those of the data
    indices whose cells it owns ((0, 0) when it owns none)."""
    nd = mesh.shape["data"]
    rows_per = height // nd
    mine = sorted({di for di, _, _ in mesh.cells()})
    if not mine:
        return (0, 0)
    return (mine[0] * rows_per, (mine[-1] + 1) * rows_per)
