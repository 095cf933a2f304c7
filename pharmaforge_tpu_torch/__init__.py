"""PyTorch/CUDA port of `pharmaforge_tpu` for NVIDIA Hopper (H100).

A second package beside the JAX one: it mirrors the JAX package's module
names (`models/gvp.py` <-> `pharmaforge_tpu/models/gvp.py`, ...) and
stores weights in the reference PyTorch state-dict layout. It imports
`torch` and numpy only -- never `jax`, `flax` or `pharmaforge_tpu`.

Entry points run on CUDA. `device="cpu"` runs them on the CPU; with no
device given and no CUDA available they raise instead of quietly running
on the CPU.

The chain is compared against the JAX package in float32, so TF32 is off
for both matmuls and cuDNN.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is requested (explicitly or by default) and
    none is available."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           f"available")
    return device
