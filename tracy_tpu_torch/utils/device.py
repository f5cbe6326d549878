"""Where the port's tensors live: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """A torch.device for `device`; a bare "cuda" means cuda:0.

    Raises when a CUDA device is asked for and none is present: the port
    never falls back to the CPU on its own. Pass device="cpu" for that.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r}: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    return dev
