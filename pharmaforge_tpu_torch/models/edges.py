"""Per-edge-type adjacency + geometry for the dense hetero convolution.

Port of `pharmaforge_tpu/models/edges.py`. Two layouts share one
descriptor:

* gathered (`idx` set): each destination sees M gathered sources -- the
  prot-prot radius list and, in knn mode, prot->pharm (each pharm centre
  takes its pf_k nearest prot atoms through the `knn_select` kernel);
* full (`idx` None): an all-pairs mask over a tiny source set (ff, and
  pf/fp in radius mode).

Edge geometry (unit direction, RBF) is computed once per denoiser call;
the prot-prot edge once per sampling chain (translation invariant).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from pharmaforge_tpu_torch.ops.geometry import norm_no_nan, rbf
from pharmaforge_tpu_torch.ops.knn_select import knn_select
from pharmaforge_tpu_torch.ops.neighbors import (
    NeighborList,
    build_pp_neighbors,
    gather_neighbor_coords,
    knn_mask,
    radius_mask,
)

RBF_DMAX = 15.0
RBF_DIM = 16
_BIG = 1e30


class EdgeData(NamedTuple):
    """One edge type's adjacency + geometry.

    mask:  [B, Nd, M] validity
    idx:   [B, Nd, M] gather indices into the src axis, or None when M
           spans the whole source set
    x_dir: [B, Nd, M, 3] unit displacement src - dst
    d_rbf: [B, Nd, M, RBF_DIM]
    """

    mask: torch.Tensor
    idx: Optional[torch.Tensor]
    x_dir: torch.Tensor
    d_rbf: torch.Tensor


class GroupedEdgeData:
    """pp edges at pocket-GROUP level for batched sampling: every `copies`
    consecutive batch rows carry one pocket, so the pp adjacency and
    geometry are identical within a group and are kept once ([G, ...],
    B = G * copies)."""

    def __init__(self, mask, idx, x_dir, d_rbf, copies: int):
        self.mask = mask
        self.idx = idx
        self.x_dir = x_dir
        self.d_rbf = d_rbf
        self.copies = copies

    def as_edge_data(self) -> EdgeData:
        """The group-level tensors as a plain EdgeData."""
        return EdgeData(mask=self.mask, idx=self.idx, x_dir=self.x_dir,
                        d_rbf=self.d_rbf)

    def expand(self) -> EdgeData:
        """Per-copy rows ([B, ...])."""
        def rep(a):
            return torch.repeat_interleave(a, self.copies, dim=0)
        return EdgeData(mask=rep(self.mask), idx=rep(self.idx),
                        x_dir=rep(self.x_dir), d_rbf=rep(self.d_rbf))


class ReverseEdgeData(NamedTuple):
    """fp edges on the pf layout: the source pharm IS the layout row, the
    destination prot is `idx`; geometry is pf's with x_dir negated.

    mask/idx: [B, F, K]; x_dir [B, F, K, 3]; d_rbf [B, F, K, RBF_DIM];
    n_dst: size of the prot axis the messages scatter into.
    """

    mask: torch.Tensor
    idx: torch.Tensor
    x_dir: torch.Tensor
    d_rbf: torch.Tensor
    n_dst: int


def _pair_geometry(x_dst, x_src_pairs):
    """x_dst [B,Nd,3] against per-dst src coords [B,Nd,M,3] -> (unit
    direction, RBF). The distance carries +1e-8 (edges.py:148)."""
    x_diff = x_src_pairs - x_dst[:, :, None, :]
    dij = norm_no_nan(x_diff, keepdim=True) + 1e-8
    return x_diff / dij, rbf(dij[..., 0], d_max=RBF_DMAX, d_count=RBF_DIM)


def full_edge_data(x_dst, x_src, mask) -> EdgeData:
    pairs = x_src[:, None].expand(x_src.shape[0], x_dst.shape[1],
                                  *x_src.shape[1:])
    x_dir, d_rbf = _pair_geometry(x_dst, pairs)
    return EdgeData(mask=mask, idx=None, x_dir=x_dir, d_rbf=d_rbf)


def gathered_edge_data(x_dst, x_src, nbrs: NeighborList) -> EdgeData:
    x_dir, d_rbf = _pair_geometry(x_dst,
                                  gather_neighbor_coords(x_src, nbrs.idx))
    return EdgeData(mask=nbrs.mask, idx=nbrs.idx, x_dir=x_dir, d_rbf=d_rbf)


def build_pp_edge(prot_x, prot_mask, cutoff: float, k_max: int
                  ) -> "tuple[NeighborList, EdgeData]":
    """Prot-prot neighbor list + edge geometry (once per chain)."""
    nbrs = build_pp_neighbors(prot_x, prot_mask, cutoff, k_max)
    return nbrs, gathered_edge_data(prot_x, prot_x, nbrs)


def build_edge_bundle(pharm_x, pharm_mask, prot_x, prot_mask, cutoffs,
                      ff_k: int, pf_k: int, pp_edge) -> Dict[str, object]:
    """All four edge types for one denoiser call (reference
    dynamics_gvp.py:187-227). `pp_edge` is the chain's prot-prot edge
    (EdgeData, or GroupedEdgeData at pocket-group level), built once per
    chain by `build_pp_edge`."""
    bundle: Dict[str, object] = {}

    # ff: pharm->pharm, radius or knn, self excluded
    if ff_k and ff_k > 0:
        m = knn_mask(pharm_x, pharm_mask, pharm_x, pharm_mask, ff_k,
                     exclude_self=True)
    else:
        m = radius_mask(pharm_x, pharm_mask, pharm_x, pharm_mask,
                        cutoffs["ff"], exclude_self=True)
    bundle["ff"] = full_edge_data(pharm_x, pharm_x, m)

    if pf_k and pf_k > 0:
        # pf: each pharm centre's pf_k nearest prot atoms (the kernel);
        # fp: the same pairs reversed, on the narrow [B, F, K] layout
        idx, dist, x_g = knn_select(pharm_x, pharm_mask, prot_x, prot_mask,
                                    pf_k)
        idx = idx.long()
        mask = dist < _BIG
        x_dir, d_rbf = _pair_geometry(pharm_x, x_g)
        bundle["pf"] = EdgeData(mask=mask, idx=idx, x_dir=x_dir, d_rbf=d_rbf)
        bundle["fp"] = ReverseEdgeData(mask=mask, idx=idx, x_dir=-x_dir,
                                       d_rbf=d_rbf, n_dst=prot_x.shape[1])
    else:
        pf_mask = radius_mask(pharm_x, pharm_mask, prot_x, prot_mask,
                              cutoffs["pf"])
        bundle["pf"] = full_edge_data(pharm_x, prot_x, pf_mask)
        bundle["fp"] = full_edge_data(prot_x, pharm_x,
                                      pf_mask.transpose(1, 2))

    bundle["pp"] = pp_edge
    return bundle
