"""Checkpoint and resume for progressive renders and inverse-rendering runs.

Port of tracy_tpu/utils/checkpoint.py. The render state (the accumulated
radiance and the frame counter) is an npz file with tracy_tpu's keys,
`accum` and `frame`, so a checkpoint written by either package loads in
the other; the counter-based RNG is keyed by the frame index, so a resumed
render continues the same sample stream and ends bit for bit where an
uninterrupted one does. The training state holds the parameters, Adam's
moments and step counts and the step: without the moments a resumed Adam
run would part from the uninterrupted one.

Checkpoints do not depend on the mesh: the accumulator is the whole
image and the RNG streams are keyed by global pixel and sample ids
(parallel/mesh.py), so a state saved under one mesh shape, or by one
device, or by tracy_tpu under its mesh, resumes under any other shape and
continues as the uninterrupted run does (bit for bit when the sample axis
keeps its size). The training state resumes under another shape too.

Files are written through an open handle, so the name is exactly `path`
(np.savez given a name adds `.npz` to one without it).
"""

from __future__ import annotations

import numpy as np
import torch

from tracy_tpu_torch.render.renderer import RenderState
from tracy_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


def _savez(path: str, **arrays):
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def save_render_state(path: str, state: RenderState):
    _savez(path, accum=state.accum.detach().cpu().numpy(),
           frame=np.asarray(int(state.frame), np.int32))


def load_render_state(path: str, device=DEFAULT_DEVICE, mesh=None) -> RenderState:
    """The render state in `path` (written by either package, under any
    mesh), its accumulator on `device` (the card by default), or with
    `mesh` (parallel/mesh.py) where that mesh's sharded step keeps it, on
    the mesh's home device."""
    dev = mesh.home if mesh is not None else resolve_device(device)
    with np.load(path) as data:
        accum = torch.tensor(np.asarray(data["accum"], np.float32), device=dev)
        return RenderState(accum=accum, frame=int(data["frame"]))


def save_params(path: str, params):
    """Save a TrainableParams (or any NamedTuple of tensors) as npz."""
    _savez(path, **{k: v.detach().cpu().numpy() for k, v in params._asdict().items()})


def load_params(path: str, cls, device=DEFAULT_DEVICE):
    """A `cls` NamedTuple of the tensors in `path`, on `device`."""
    dev = resolve_device(device)
    with np.load(path) as data:
        return cls(**{k: torch.tensor(data[k], device=dev) for k in data.files})


def save_train_state(path: str, params, optimizer, step: int):
    """Parameters, the optimizer's per-parameter state (Adam: step count,
    first and second moments, keyed by the parameter's place in the
    optimizer) and the training step."""
    blobs = {f"p_{k}": v.detach().cpu().numpy() for k, v in params._asdict().items()}
    for i, st in optimizer.state_dict()["state"].items():
        for key, v in st.items():
            blobs[f"o_{i}_{key}"] = torch.as_tensor(v).detach().cpu().numpy()
    blobs["step"] = np.asarray(step, np.int64)
    _savez(path, **blobs)


def load_train_state(path: str, params, optimizer):
    """Restore a training state into the live `params` (copied in place, so
    the optimizer's references stay valid) and `optimizer` (an optimizer of
    the same kind over them, as make_train_step returns it). Returns
    (params, optimizer, step)."""
    with np.load(path) as data:
        with torch.no_grad():
            for k, v in params._asdict().items():
                v.copy_(torch.as_tensor(data[f"p_{k}"]))
        sd = optimizer.state_dict()
        state = {}
        for name in data.files:
            if name.startswith("o_"):
                i, key = name[2:].split("_", 1)
                state.setdefault(int(i), {})[key] = torch.tensor(data[name])
        sd["state"] = state
        optimizer.load_state_dict(sd)
        return params, optimizer, int(data["step"])
