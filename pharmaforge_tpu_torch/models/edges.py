"""Per-edge-type adjacency + geometry for the dense hetero convolution.

Port of `pharmaforge_tpu/models/edges.py`. Two layouts share one
descriptor:

* gathered (`idx` set): each destination sees M gathered sources -- the
  prot-prot radius list and, in knn mode, prot->pharm (each pharm centre
  takes its pf_k nearest prot atoms; the `knn_pf_edges` kernel returns
  the selection and its geometry in one launch);
* full (`idx` None): an all-pairs mask over a tiny source set (ff, and
  pf/fp in radius mode outside a sampling chain).

In radius mode a sampling chain runs pf in the gathered layout and fp on
it reversed, with M slots a centre (`radius_slots`): each centre's valid
atoms within r_pf, in ascending atom order. M comes from
`radius_slot_count`, once per chain: the pocket's atoms keep their
relative places through the chain, so no point of space ever has more of
them within r_pf than a bound computed from the pocket alone.

Edge geometry (unit direction, RBF) is computed once per denoiser call;
the prot-prot edge once per sampling chain (translation invariant), and
with it the pp edge's transpose (`build_pp_out_edges`), which the
pocket-copy correction of the middle conv reads.
"""

from __future__ import annotations

import math
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


# `radius_slot_bound`: the side of its first cells (A), how many times it
# halves them, the most cells a halving takes, and the cells times atoms
# of one chunk of distances
SLOT_GRID = 0.5
SLOT_HALVINGS = 3
SLOT_HOT_CELLS = 1 << 12
_SLOT_CHUNK = 1 << 22
# a chain's radius slot count is a multiple of this
SLOT_ROUND = 32


def _capturing(t: torch.Tensor) -> bool:
    """True while `t`'s device stream is being captured into a CUDA graph,
    where nothing may bring a value to the host."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def _cell_counts(centres, half: float, x, valid, reach2: float):
    """The valid atoms (x [P, 3], valid [P]) whose distance to each cube
    (centres [N, 3], half side `half`) is below sqrt(reach2): [N]."""
    out = []
    step = max(1, _SLOT_CHUNK // (3 * x.shape[0]))
    for s in range(0, centres.shape[0], step):
        gap = torch.clamp((centres[s:s + step, None] - x).abs() - half,
                          min=0.0)
        gap = gap * gap
        near = (gap[..., 0] + gap[..., 1] + gap[..., 2]) < reach2
        out.append((near & valid).sum(-1))
    return torch.cat(out)


def _grid_counts(lo, sizes, h: float, x, valid, reach2: float):
    """`_cell_counts` over the grid of cubes of side h centred at lo + h*k
    (k < sizes per axis): the cube distance is summed by axis, a chunk of
    planes at a time. Returns the counts [nx, ny, nz]."""
    half = h / 2.0
    d2 = []
    for a in range(3):
        c = lo[a] + h * torch.arange(sizes[a], device=x.device,
                                     dtype=torch.float32)
        gap = torch.clamp((c[:, None] - x[:, a]).abs() - half, min=0.0)
        d2.append(torch.where(valid, gap * gap, math.inf))
    ny, nz = sizes[1], sizes[2]
    step = max(1, _SLOT_CHUNK // (ny * nz * x.shape[0]))
    out = []
    for s in range(0, sizes[0], step):
        dxy = d2[0][s:s + step, None, None] + d2[1][None, :, None]
        out.append(((dxy + d2[2][None, None]) < reach2).sum(-1))
    return torch.cat(out)


def radius_slot_bound(prot_x, prot_mask, r: float) -> torch.Tensor:
    """For each pocket (prot_x [B, P, 3], prot_mask [B, P]), an upper bound
    on the number of its valid atoms strictly within `r` of any one point
    of space: [B] int64 on prot_x's device.

    A point with an atom within r lies within r of the atoms' bounding
    box, which cubes of side h = `SLOT_GRID` tile with the box widened by
    r. Every point lies in a cube, and an atom within r of the point lies
    within r of its cube, so the atoms within r of a cube (1e-3 A more,
    for the rounding of either distance) bound the count at each of its
    points. The bound is t, the multiple of `SLOT_ROUND` below the largest
    cube count, or more where a cube's count stays above t once halved:
    the cubes above t are halved into 8 up to `SLOT_HALVINGS` times (while
    they are at most `SLOT_HOT_CELLS`), each child counted anew, so a
    pocket whose largest count sits just above a multiple of 32 can still
    take the slots below it. Host syncs: the grids' corners and sizes,
    then two a pocket and one a halving."""
    b = prot_mask.shape[0]
    h = SLOT_GRID
    reach2 = (r + 1e-3) ** 2
    x = prot_x.float()
    m = prot_mask.bool()
    lo = torch.where(m[..., None], x, math.inf).amin(1) - r
    hi = torch.where(m[..., None], x, -math.inf).amax(1) + r
    n = torch.where(m.any(1, keepdim=True),
                    torch.ceil((hi - lo) / h) + 1, 0.0)
    sizes = n.long().tolist()
    lo_host = lo.tolist()
    # a cube's 8 children: its centre +- a quarter side on each axis
    signs = torch.tensor([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                          for sz in (-1, 1)], dtype=torch.float32,
                         device=x.device)
    bounds = []
    for i in range(b):
        if not sizes[i][0]:
            bounds.append(0)
            continue
        counts = _grid_counts(lo_host[i], sizes[i], h, x[i], m[i], reach2)
        most = int(counts.max())
        t = SLOT_ROUND * ((most - 1) // SLOT_ROUND)
        hot = torch.nonzero(counts > t)
        centres = lo[i] + h * hot.to(torch.float32)
        counts = counts[counts > t]
        half = h / 2.0
        for _ in range(SLOT_HALVINGS):
            if not 0 < centres.shape[0] <= SLOT_HOT_CELLS:
                break
            half /= 2.0
            centres = (centres[:, None] + half * signs).reshape(-1, 3)
            counts = _cell_counts(centres, half, x[i], m[i], reach2)
            keep = counts > t
            centres, counts = centres[keep], counts[keep]
        bounds.append(max(t, int(counts.max()) if counts.numel() else t))
    return torch.tensor(bounds, dtype=torch.int64, device=x.device)


def radius_slot_count(prot_x, prot_mask, r: float) -> int:
    """The slot count M of a chain's radius pf edge over these pockets: the
    largest `radius_slot_bound`, rounded up to a multiple of `SLOT_ROUND`
    (at least one), at most the P prot slots. A Python int; two host
    syncs, once per chain."""
    p = prot_mask.shape[1]
    bound = int(radius_slot_bound(prot_x, prot_mask, r).max()) \
        if prot_mask.shape[0] else 0
    return min(p, max(1, math.ceil(bound / SLOT_ROUND)) * SLOT_ROUND)


def radius_slots(mask: torch.Tensor, m: int) -> NeighborList:
    """The valid sources of each row of a dense mask [B, Nd, P] in `m`
    slots, in ascending source order: a cumsum over P places each, then
    a scatter. idx [B, Nd, m] int64 (0 in a free slot), mask [B, Nd, m].

    A row with more than m valid sources keeps its first m. Outside a CUDA
    graph capture that raises ValueError instead (one host sync); a
    captured step syncs for nothing and relies on m being a bound
    (`radius_slot_count`)."""
    pos = torch.cumsum(mask, dim=-1)
    count = pos[..., -1]
    if not _capturing(mask) and count.numel():
        most = int(count.max())
        if most > m:
            raise ValueError(
                f"a pf row holds {most} pairs within r_pf, above its "
                f"{m} radius slots")
    slot = torch.where(mask, pos - 1, m).clamp_(max=m)
    src = torch.arange(mask.shape[-1], device=mask.device).expand_as(slot)
    idx = torch.zeros(mask.shape[:-1] + (m + 1,), dtype=torch.int64,
                      device=mask.device).scatter_(-1, slot, src)
    valid = torch.arange(m, device=mask.device) < count[..., None]
    return NeighborList(idx=idx[..., :m], mask=valid)


def count_radius_pairs(pf_mask: torch.Tensor) -> None:
    """The radius pf edge's counters (`utils/trace.py`): the rows its
    chains run, from the mask's shape (B*F*M in slots, B*F*P dense); and
    its valid pairs, which brings the mask's sum to the host, so only
    while tracing and outside a CUDA graph capture: an untraced or
    replayed step never syncs for it."""
    trace.count("edges.pf_radius_rows", pf_mask.numel())
    if trace.tracing() and not _capturing(pf_mask):
        trace.count("edges.pf_radius_pairs", int(pf_mask.sum()))


def build_edge_bundle(pharm_x, pharm_mask, prot_x, prot_mask, cutoffs,
                      ff_k: int, pf_k: int, pp_edge,
                      pf_slots: Optional[int] = None) -> Dict[str, object]:
    """All four edge types for one denoiser call (reference
    dynamics_gvp.py:187-227). `pp_edge` is the chain's prot-prot edge
    (EdgeData, or GroupedEdgeData at pocket-group level), built once per
    chain by `build_pp_edge`. `pf_slots` (radius pf only) is the chain's
    slot count M (`radius_slot_count`): pf then takes the gathered layout
    [B, F, M] and fp its reverse; None keeps the dense [B, F, P] and
    [B, P, F] layouts."""
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
        # pf: every (pharm centre, prot atom) pair within r_pf; fp: the
        # same pairs reversed
        with trace.span("edges.radius"):
            pf_mask = radius_mask(pharm_x, pharm_mask, prot_x, prot_mask,
                                  cutoffs["pf"])
            if pf_slots is None:
                # dense: [B, F, P] and [B, P, F]
                count_radius_pairs(pf_mask)
                bundle["pf"] = full_edge_data(pharm_x, prot_x, pf_mask)
                bundle["fp"] = full_edge_data(prot_x, pharm_x,
                                              pf_mask.transpose(1, 2))
            else:
                # each centre's atoms in M slots, as kNN lists them
                pf = gathered_edge_data(pharm_x, prot_x,
                                        radius_slots(pf_mask, pf_slots))
                count_radius_pairs(pf.mask)
                bundle["pf"] = pf
                bundle["fp"] = ReverseEdgeData(
                    mask=pf.mask, idx=pf.idx, x_dir=-pf.x_dir,
                    d_rbf=pf.d_rbf, n_dst=prot_x.shape[1])

    bundle["pp"] = pp_edge
    return bundle
