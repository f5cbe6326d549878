"""Checkpoint and resume for progressive renders and inverse-rendering runs.

Port of tracy_tpu/utils/checkpoint.py. The render state (the accumulated
radiance and the frame counter) is an npz file with tracy_tpu's keys,
`accum` and `frame`, so a checkpoint written by either package loads in
the other; the counter-based RNG is keyed by the frame index, so a resumed
render continues the same sample stream and ends bit for bit where an
uninterrupted one does. The training state holds the parameters, Adam's
step count and moments and the step, in tracy_tpu's layout (optax.adam's
flattened state: `o_leaf0` the count, then the first moments and the
second moments of every TrainableParams field in field order), so a run
saved by either package resumes in the other: without the moments a
resumed Adam run would part from the uninterrupted one. `save_pytree` and
`load_pytree` write any tree of tensors as tracy_tpu's `leaf{i}` keys.

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
import torch.utils._pytree as pytree

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


def _jax_order(tree):
    """`tree` with every dict's keys sorted, the order in which
    jax.tree_util flattens a dict (torch.utils._pytree keeps insertion
    order); NamedTuples, tuples and lists keep theirs."""
    if isinstance(tree, dict):
        return {k: _jax_order(tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_jax_order(x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_jax_order(x) for x in tree)
    return tree


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_pytree(path: str, tree):
    """Save any tree of tensors (NamedTuples, tuples, lists, dicts) as npz,
    leaf i as `leaf{i}` in jax.tree_util's order, as tracy_tpu's
    save_pytree: a file either package writes loads in the other. The
    structure is not saved: load with `like`, a tree of the same shape."""
    leaves, _ = pytree.tree_flatten(_jax_order(tree))
    _savez(path, **{f"leaf{i}": _numpy(v) for i, v in enumerate(leaves)})


def load_pytree(path: str, like):
    """The tree in `path` (save_pytree's, either package's), in the
    structure of `like`, each leaf a tensor with the dtype and device of
    like's leaf (the CPU for a leaf that is not a tensor)."""
    like_leaves, spec = pytree.tree_flatten(_jax_order(like))
    with np.load(path) as data:
        if len(data.files) != len(like_leaves):
            raise ValueError(f"checkpoint has {len(data.files)} leaves, structure expects "
                             f"{len(like_leaves)}")
        leaves = []
        for i, ref in enumerate(like_leaves):
            if isinstance(ref, torch.Tensor):
                leaves.append(torch.as_tensor(data[f"leaf{i}"]).to(ref.device, ref.dtype))
            else:
                leaves.append(torch.as_tensor(np.asarray(data[f"leaf{i}"],
                                                         np.asarray(ref).dtype)))
    return pytree.tree_unflatten(leaves, spec)


# Adam's per-tensor state in torch.optim.Adam, and the keys it needs.
ADAM_KEYS = {"step", "exp_avg", "exp_avg_sq"}


def _trained(params, optimizer):
    """For each field of params, its index among the optimizer's tensors,
    or None where the optimizer does not train it."""
    order = [p for g in optimizer.param_groups for p in g["params"]]
    return [next((j for j, p in enumerate(order) if p is v), None) for v in params]


def save_train_state(path: str, params, optimizer, step: int):
    """Parameters (`p_<field>`), Adam's state in optax.adam's layout and
    the training step, as tracy_tpu's save_train_state writes them:
    `o_leaf0` the step count (int32), `o_leaf1`..`o_leafF` the first
    moments and `o_leaf(F+1)`..`o_leaf(2F)` the second moments of the F
    fields of `params` in field order, zeros for a field the optimizer does
    not train. optimizer: a torch.optim.Adam over fields of params (as
    make_train_step builds it); a state that holds other keys raises."""
    blobs = {f"p_{k}": v.detach().cpu().numpy() for k, v in params._asdict().items()}
    state = optimizer.state_dict()["state"]
    count = 0
    mu, nu = [], []
    for v, j in zip(params, _trained(params, optimizer)):
        st = state.get(j, {}) if j is not None else {}
        if set(st) - ADAM_KEYS:
            raise ValueError(f"save_train_state writes Adam's state; the optimizer holds "
                             f"{sorted(st)}")
        zero = np.zeros(tuple(v.shape), np.float32)
        mu.append(_numpy(st["exp_avg"]) if st else zero)
        nu.append(_numpy(st["exp_avg_sq"]) if st else zero)
        count = max(count, int(st["step"]) if st else 0)
    blobs["o_leaf0"] = np.asarray(count, np.int32)
    for i, v in enumerate(mu + nu):
        blobs[f"o_leaf{i + 1}"] = v
    blobs["step"] = np.asarray(step, np.int64)
    _savez(path, **blobs)


def load_train_state(path: str, params, optimizer):
    """Restore a training state (save_train_state's, either package's) into
    the live `params` (copied in place, so the optimizer's references stay
    valid) and `optimizer` (a torch.optim.Adam over fields of params, as
    make_train_step returns it): each trained field's Adam step count and
    moments. Returns (params, optimizer, step)."""
    nf = len(params)
    with np.load(path) as data:
        with torch.no_grad():
            for k, v in params._asdict().items():
                v.copy_(torch.as_tensor(data[f"p_{k}"]))
        count = int(data["o_leaf0"])
        sd = optimizer.state_dict()
        state = {}
        if count > 0:
            for i, (v, j) in enumerate(zip(params, _trained(params, optimizer))):
                if j is None:
                    continue
                state[j] = {"step": torch.tensor(float(count), dtype=torch.float32),
                            "exp_avg": torch.as_tensor(data[f"o_leaf{i + 1}"]).to(v.dtype),
                            "exp_avg_sq": torch.as_tensor(
                                data[f"o_leaf{i + 1 + nf}"]).to(v.dtype)}
        sd["state"] = state
        optimizer.load_state_dict(sd)
        return params, optimizer, int(data["step"])
