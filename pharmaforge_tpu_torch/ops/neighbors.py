"""Static-shape neighbor construction.

Port of `pharmaforge_tpu/ops/neighbors.py`: dense boolean adjacency for
the tiny pharm sets and fixed-width nearest-neighbor lists for the
prot-prot edges, in place of torch_cluster's ragged `radius`/`knn`.

Semantics kept from the JAX package:
* radius tests use a strict `<`;
* every k-nearest selection breaks ties toward the LOWER source index, as
  `lax.top_k` does. `torch.topk` promises no tie order, so selection is a
  stable ascending sort;
* invalid pairs hold the finite sentinel `_BIG`, so when fewer than k
  sources are valid the remaining slots walk the invalid ones in index
  order and are masked by `value < _BIG`.
Gathers are indexed loads; the JAX package's one-hot matmul gathers exist
only for the TPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_BIG = 1e30


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., N, 3], b [..., M, 3] -> [..., N, M], summed component-wise
    in x, y, z order."""
    diff = a[..., :, None, :] - b[..., None, :, :]
    sq = diff * diff
    return sq[..., 0] + sq[..., 1] + sq[..., 2]


def smallest_k(d2: torch.Tensor, k: int):
    """(values, indices) of the k smallest entries along the last axis,
    ascending, ties to the lower index (`lax.top_k(-d2, k)` negated)."""
    k = min(k, d2.shape[-1])
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def _eye(n: int, device) -> torch.Tensor:
    return torch.eye(n, dtype=torch.bool, device=device)


def radius_mask(dst_x, dst_mask, src_x, src_mask, r: float,
                exclude_self: bool = False) -> torch.Tensor:
    """mask[b, i, j]: valid src j lies strictly within r of valid dst i."""
    d2 = pairwise_sqdist(dst_x, src_x)
    valid = dst_mask[..., :, None] & src_mask[..., None, :]
    adj = (d2 < r * r) & valid
    if exclude_self:
        adj = adj & ~_eye(adj.shape[-1], adj.device)
    return adj


def knn_mask(dst_x, dst_mask, src_x, src_mask, k: int,
             exclude_self: bool = False) -> torch.Tensor:
    """Dense adjacency of the k nearest valid sources of every dst
    (fewer when fewer are valid)."""
    d2 = pairwise_sqdist(dst_x, src_x)
    valid = dst_mask[..., :, None] & src_mask[..., None, :]
    if exclude_self:
        valid = valid & ~_eye(d2.shape[-1], d2.device)
    d2 = torch.where(valid, d2, _BIG)
    topk, idx = smallest_k(d2, k)
    sel = torch.zeros_like(valid).scatter(-1, idx, topk < _BIG)
    return sel & valid


class NeighborList(NamedTuple):
    """Fixed-width neighbor list: for each dst node, up to K srcs."""

    idx: torch.Tensor   # [B, N, K] int64 indices into the src axis
    mask: torch.Tensor  # [B, N, K] bool validity


def radius_neighbor_list(x, mask, r: float, k_max: int,
                         exclude_self: bool = True) -> NeighborList:
    """Nearest `k_max` neighbors within radius r, sorted by distance, with
    a validity mask (invalid beyond r, past the true degree, or padded)."""
    d2 = pairwise_sqdist(x, x)
    valid = mask[..., :, None] & mask[..., None, :]
    if exclude_self:
        valid = valid & ~_eye(d2.shape[-1], d2.device)
    valid = valid & (d2 < r * r)
    d2 = torch.where(valid, d2, _BIG)
    vals, idx = smallest_k(d2, k_max)
    return NeighborList(idx=idx, mask=vals < _BIG)


def gather_neighbor_coords(x: torch.Tensor, idx: torch.Tensor
                           ) -> torch.Tensor:
    """x [B, N, D], idx [B, Nd, K] -> x rows at idx, [B, Nd, K, D]."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[rows, idx]


def build_pp_neighbors(prot_x, prot_mask, cutoff_pp: float,
                       k_max: int) -> NeighborList:
    """Static prot-prot neighbor list (translation invariant: built once
    per sampling chain)."""
    if cutoff_pp <= 0:
        b, p = prot_mask.shape
        k = min(k_max, p)
        return NeighborList(
            idx=torch.zeros((b, p, k), dtype=torch.long,
                            device=prot_mask.device),
            mask=torch.zeros((b, p, k), dtype=torch.bool,
                             device=prot_mask.device))
    return radius_neighbor_list(prot_x, prot_mask, cutoff_pp, k_max)
