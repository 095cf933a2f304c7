"""Pairwise distance hinge loss.

Port of `pharmaforge_tpu/losses/dist_hinge_loss.py` (the reference's
`DistanceHingeLoss`, losses/dist_hinge_loss.py): penalizes point pairs
closer than a threshold. Dormant in the reference and in the JAX package
(the flags exist, nothing calls it); kept for the same capability
surface, as a pure function on tensors that stays on its inputs' device.
"""

from __future__ import annotations

from typing import Optional

import torch


def distance_hinge_loss(pos_a: torch.Tensor, pos_b: Optional[torch.Tensor],
                        distance_threshold: float) -> torch.Tensor:
    """sum over pairs of max(threshold - d_ij, 0).

    With `pos_b=None` the loss runs over the strict upper triangle of the
    self-distance matrix (each unordered pair counted once).
    """
    other = pos_a if pos_b is None else pos_b
    d = torch.linalg.norm(pos_a[:, None, :] - other[None, :, :] + 1e-12,
                          dim=-1)
    hinge = torch.clamp(distance_threshold - d, min=0.0)
    if pos_b is None:
        hinge = torch.triu(hinge, diagonal=1)
    return hinge.sum()
