"""oatx_torch — the PyTorch / CUDA port of oatx for one NVIDIA H100.

The JAX package `oatx` is the reference; this package imports torch, numpy and
the standard library only, never jax and nothing of `oatx`. Module names
mirror oatx's (ops/, models/, data/, config/, serve/, cli/) so each
counterpart is easy to find.

Every entry point runs on CUDA unless the caller passes device="cpu"; on the
CPU each hand-written kernel is replaced by its plain PyTorch version, which
is what the tests hold against oatx.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    Without a card and without an explicit device this raises — the port never
    drops to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "oatx_torch runs on a CUDA device and none is available; pass "
                "device='cpu' to run the plain PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is None:  # 'cuda' names the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
