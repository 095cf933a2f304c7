"""Per-edge-type adjacency + geometry for the dense hetero convolution.

Port of `pharmaforge_tpu/models/edges.py`. Two layouts share one
descriptor:

* gathered (`idx` set): each destination sees M gathered sources -- the
  prot-prot radius list and, in knn mode, prot->pharm (each pharm centre
  takes its pf_k nearest prot atoms; the `knn_pf_edges` kernel returns
  the selection and its geometry in one launch);
* full (`idx` None): an all-pairs mask over a tiny source set (ff, and
  pf/fp in radius mode).

Edge geometry (unit direction, RBF) is computed once per denoiser call;
the prot-prot edge once per sampling chain (translation invariant), and
with it the pp edge's transpose (`build_pp_out_edges`), which the
pocket-copy correction of the middle conv reads.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from pharmaforge_tpu_torch.ops.geometry import pair_geometry
from pharmaforge_tpu_torch.ops.knn_select import knn_pf_edges
from pharmaforge_tpu_torch.ops.neighbors import (
    NeighborList,
    build_pp_neighbors,
    gather_neighbor_coords,
    knn_mask,
    radius_mask,
)
from pharmaforge_tpu_torch.utils import trace

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


class PreGatheredEdgeData(NamedTuple):
    """pf edges whose source prot table is already in pf-slot order: the
    compact prot tail's conv updated only the F*K atoms the pf lists
    reference, as a [B, F*K, ...] table whose row (f, k) is pharm f's k-th
    neighbour, so the next conv's pf "gather" is a reshape. mask, x_dir
    and d_rbf are the pf edge's ([B, F, K, ...])."""

    mask: torch.Tensor
    x_dir: torch.Tensor
    d_rbf: torch.Tensor


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


def full_edge_data(x_dst, x_src, mask) -> EdgeData:
    pairs = x_src[:, None].expand(x_src.shape[0], x_dst.shape[1],
                                  *x_src.shape[1:])
    x_dir, d_rbf = pair_geometry(x_dst, pairs)
    return EdgeData(mask=mask, idx=None, x_dir=x_dir, d_rbf=d_rbf)


def gathered_edge_data(x_dst, x_src, nbrs: NeighborList) -> EdgeData:
    x_dir, d_rbf = pair_geometry(x_dst,
                                 gather_neighbor_coords(x_src, nbrs.idx))
    return EdgeData(mask=nbrs.mask, idx=nbrs.idx, x_dir=x_dir, d_rbf=d_rbf)


def build_pp_edge(prot_x, prot_mask, cutoff: float, k_max: int
                  ) -> "tuple[NeighborList, EdgeData]":
    """Prot-prot neighbor list + edge geometry (once per chain)."""
    nbrs = build_pp_neighbors(prot_x, prot_mask, cutoff, k_max)
    return nbrs, gathered_edge_data(prot_x, prot_x, nbrs)


def max_pp_out_degree(ed) -> int:
    """The largest number of valid (destination, slot) positions of a
    gathered pp edge (idx/mask [G, P, K]) that reference one source atom.
    Returns a Python int (one host sync)."""
    g, p, k = ed.idx.shape
    rows = torch.arange(g, device=ed.idx.device)[:, None, None] * p
    flat = (rows + ed.idx.long())[ed.mask.bool()]
    if flat.numel() == 0:
        return 0
    return int(torch.bincount(flat, minlength=g * p).max())


def build_pp_out_edges(ed, k_out: int) -> "tuple[torch.Tensor, torch.Tensor]":
    """Transpose of a gathered pp edge: for every source atom, the flat edge
    ids (dst * K + slot) that reference it, in ascending order.

    ed.idx/mask [G, P, K] -> (out_eid [G, P, k_out] int64,
    out_mask [G, P, k_out] bool), the JAX package's tables bit for bit.
    The JAX version silently drops the edges of a source past its first
    `k_out`; this one raises ValueError when `k_out` is below the maximum
    out-degree (one host sync, once per chain)."""
    degree = max_pp_out_degree(ed)
    if k_out < degree:
        raise ValueError(
            f"pp_k_out={k_out} is below the pp edge's maximum out-degree "
            f"{degree}: the pocket-copy correction would drop edges")
    g, p, k = ed.idx.shape
    e = p * k
    dev = ed.idx.device
    flat_idx = ed.idx.reshape(g, e).long()
    valid = ed.mask.reshape(g, e).bool()
    # a stable sort by source keeps each source's edge ids ascending;
    # invalid edges sort last, into a dump source p
    key = torch.where(valid, flat_idx, torch.full_like(flat_idx, p))
    sorted_key, eid = torch.sort(key, dim=1, stable=True)
    # rank of each edge within its source's run
    first = torch.searchsorted(sorted_key, sorted_key, side="left")
    pos = torch.arange(e, device=dev)[None] - first
    real = sorted_key < p
    out_eid = torch.zeros((g, p, k_out), dtype=torch.int64, device=dev)
    out_mask = torch.zeros((g, p, k_out), dtype=torch.bool, device=dev)
    gi = torch.arange(g, device=dev)[:, None].expand(g, e)
    at = (gi[real], sorted_key[real], pos[real])
    out_eid[at] = eid[real]
    out_mask[at] = True
    return out_eid, out_mask


def count_radius_pairs(pf_mask: torch.Tensor) -> None:
    """The radius pf edge's counters (`utils/trace.py`): its rows B*F*P,
    from the shape; and its valid pairs, which brings the mask's sum to
    the host, so only while tracing and outside a CUDA graph capture: an
    untraced or replayed step never syncs for it."""
    trace.count("edges.pf_radius_rows", pf_mask.numel())
    if trace.tracing() and not (pf_mask.is_cuda and
                                torch.cuda.is_current_stream_capturing()):
        trace.count("edges.pf_radius_pairs", int(pf_mask.sum()))


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
        # pf: each pharm centre's pf_k nearest prot atoms and their
        # geometry (one kernel launch); fp: the same pairs reversed, on the
        # narrow [B, F, K] layout
        idx, mask, x_dir, x_dir_fp, d_rbf = knn_pf_edges(
            pharm_x, pharm_mask, prot_x, prot_mask, pf_k)
        bundle["pf"] = EdgeData(mask=mask, idx=idx, x_dir=x_dir, d_rbf=d_rbf)
        bundle["fp"] = ReverseEdgeData(mask=mask, idx=idx, x_dir=x_dir_fp,
                                       d_rbf=d_rbf, n_dst=prot_x.shape[1])
    else:
        # pf: every (pharm centre, prot atom) pair within r_pf, dense
        # [B, F, P]; fp: the same pairs reversed, [B, P, F]
        with trace.span("edges.radius"):
            pf_mask = radius_mask(pharm_x, pharm_mask, prot_x, prot_mask,
                                  cutoffs["pf"])
            count_radius_pairs(pf_mask)
            bundle["pf"] = full_edge_data(pharm_x, prot_x, pf_mask)
            bundle["fp"] = full_edge_data(prot_x, pharm_x,
                                          pf_mask.transpose(1, 2))

    bundle["pp"] = pp_edge
    return bundle
