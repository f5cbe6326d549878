"""What every kernel wrapper shares: launch counts, argument checks and
the route of the tables K2, K3 and K4 read."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

# The routes of a kernel's material and texture tables: staged in the
# 48 KB of shared memory a block gets by default, or read from global
# memory through the read-only cache beyond that. Both do the same
# arithmetic. A third route, staged above 48 KB after the kernel opts in to
# more shared memory, ran 2.5-4.2 x slower than 'global' at 52-85 KB of
# tables on an H100 (every block stages the whole table, and two such
# blocks fill an SM; PERF.md section 6), so there is none.
ROUTES = ("shared", "global")
SMEM_DEFAULT = 48 * 1024


def table_route(nbytes: int) -> str:
    """The route for tables of `nbytes`. The main paths' tables (a few
    materials) stay on "shared"."""
    return "shared" if nbytes <= SMEM_DEFAULT else "global"


def pick_route(kernel: str, nbytes: int, route: Optional[str] = None) -> Tuple[str, int]:
    """(route, the dynamic shared memory to launch `kernel` with) for
    tables of `nbytes`: nbytes on "shared", 0 on "global". route None takes
    table_route's; a route the caller names (to time the routes against
    each other) must hold the tables."""
    if route is None:
        route = table_route(nbytes)
    if route not in ROUTES:
        raise ValueError(f"{kernel}: unknown table route {route!r}; pick one of {ROUTES}")
    if route == "shared" and nbytes > SMEM_DEFAULT:
        raise ValueError(f"{kernel}: {nbytes} bytes of tables do not fit the 'shared' "
                         f"route's {SMEM_DEFAULT}")
    return route, nbytes if route == "shared" else 0


@dataclasses.dataclass
class LaunchCount:
    """How often a wrapper launched its kernel, and how often it ran the
    plain PyTorch version instead (only ever for CPU tensors). K2, K3 and
    K4 also count their launches by table route (`routes`)."""

    kernel: int = 0
    plain: int = 0
    routes: Dict[str, int] = dataclasses.field(default_factory=dict)

    def reset(self):
        self.kernel = 0
        self.plain = 0
        self.routes = {}

    def launched(self, route: Optional[str] = None):
        self.kernel += 1
        if route is not None:
            self.routes[route] = self.routes.get(route, 0) + 1


def check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: Sequence[int],
          device: torch.device):
    """Raise unless x is a contiguous `dtype` tensor of `shape` on `device`."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def raise_on_error(kernel: str, code: int):
    if code != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError_t {code}")
