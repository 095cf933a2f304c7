"""Timing fence for asynchronous device work.

Port of `pharmaforge_tpu/utils/timing.py`. PyTorch returns from a CUDA
call before the card has run it, so a host clock read without a fence
measures the enqueue. `fence` returns only after the work behind its
tensors has run: it synchronizes every CUDA device they live on.
"""

from __future__ import annotations

from typing import Any, List

import torch


def _leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _leaves(item)]
    return []


def fence(tree: Any) -> float:
    """Wait for every device computation that the tensors of `tree` (a
    tensor, or dicts, lists and tuples of them) depend on, then return a
    digest: the sum of each non-empty tensor's first element, as on the
    JAX side (useful only to keep the values alive or check that they
    are finite)."""
    leaves = [x for x in _leaves(tree) if x.numel()]
    for device in {x.device for x in leaves if x.device.type == "cuda"}:
        torch.cuda.synchronize(device)
    return float(sum(float(x.reshape(-1)[0]) for x in leaves))
