"""Masked geometric primitives for dense point-cloud batches.

Port of `pharmaforge_tpu/ops/geometry.py`: the norm, RBF embedding and
masked centre-of-mass helpers on fixed-shape tensors with boolean validity
masks.
"""

from __future__ import annotations

import torch

# the edge RBF embedding (reference dynamics_gvp.py): RBF_DIM centres over
# [0, RBF_DMAX]
RBF_DMAX = 15.0
RBF_DIM = 16


def norm_no_nan(x: torch.Tensor, dim: int = -1, keepdim: bool = False,
                eps: float = 1e-8, sqrt: bool = True) -> torch.Tensor:
    """L2 norm along `dim` with the SQUARED norm clamped to at least `eps`
    (so the smallest norm is sqrt(eps) = 1e-4), as the reference
    `_norm_no_nan`. Keeps coincident points finite."""
    out = torch.clamp(torch.sum(x * x, dim=dim, keepdim=keepdim), min=eps)
    return torch.sqrt(out) if sqrt else out


def rbf(d: torch.Tensor, d_min: float = 0.0, d_max: float = 20.0,
        d_count: int = 16) -> torch.Tensor:
    """Gaussian radial basis of distances on a new trailing axis:
    `d_count` centres linspace(d_min, d_max), width (d_max-d_min)/d_count."""
    d_mu = torch.linspace(d_min, d_max, d_count, dtype=d.dtype,
                          device=d.device)
    d_sigma = (d_max - d_min) / d_count
    return torch.exp(-(((d[..., None] - d_mu) / d_sigma) ** 2))


def pair_geometry(x_dst: torch.Tensor, x_src_pairs: torch.Tensor):
    """x_dst [B,Nd,3] against per-dst src coords [B,Nd,M,3] -> (unit
    direction src - dst [B,Nd,M,3], RBF [B,Nd,M,RBF_DIM]). The distance
    carries +1e-8 (edges.py:148)."""
    x_diff = x_src_pairs - x_dst[:, :, None, :]
    dij = norm_no_nan(x_diff, keepdim=True) + 1e-8
    return x_diff / dij, rbf(dij[..., 0], d_max=RBF_DMAX, d_count=RBF_DIM)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int,
                keepdim: bool = False) -> torch.Tensor:
    """Mean of `x` over `dim` counting only entries where `mask` is set;
    an empty set gives 0."""
    mask = mask.to(x.dtype)
    total = torch.sum(x * mask, dim=dim, keepdim=keepdim)
    count = torch.sum(mask, dim=dim, keepdim=keepdim)
    return total / torch.clamp(count, min=1.0)


def masked_com(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-sample centre of mass: x [B, N, 3], mask [B, N] -> [B, 3]."""
    return masked_mean(x, mask[..., None], dim=-2)


def remove_masked_com(pharm_x, pharm_mask, prot_x, com_source_x=None,
                      com_source_mask=None):
    """Subtract the masked COM of `com_source_x` (default: the pharm
    coordinates) from both point sets. Returns (pharm_x', prot_x', com)."""
    if com_source_x is None:
        com_source_x, com_source_mask = pharm_x, pharm_mask
    com = masked_com(com_source_x, com_source_mask)
    return pharm_x - com[:, None, :], prot_x - com[:, None, :], com
