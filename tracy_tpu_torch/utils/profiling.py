"""Profiler traces of the port.

Port of tracy_tpu/utils/profiling.py's `trace` (an xprof trace there) on
torch.profiler: the enclosed block's host operations and, where a card
is used, its kernels, written as a Chrome trace (open it in
ui.perfetto.dev or chrome://tracing). tracy_tpu's two rooflines,
packet_speed_of_light and packet_hbm_bound, are the TPU's VPU and HBM
bounds; the port's kernels take theirs from ops/compare.py.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

from tracy_tpu_torch.utils.log import log


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block into `log_dir`/trace.json; yields the
    torch.profiler.profile object (key_averages() and the rest)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    log(f"torch.profiler trace ({time.perf_counter() - t0:.2f}s) -> {path}")
