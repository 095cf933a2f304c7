"""Dense mask-batched heterogeneous GVP graph convolution.

Port of `pharmaforge_tpu/models/conv.py` (`EdgeMessageChain` :157-360,
`_aggregate` :450, `_scatter_aggregate` :363, `GVPMultiEdgeConv` :572).
Each edge type runs the reference message function -- the GVP chain on
(src scalars ++ RBF(d), unit direction ++ src vectors) -- over a
static-shape edge tensor, then reduces under the edge mask. This is the
plain concatenation form; the JAX package's hoisted per-node form is the
same math reassociated.

The prot-prot chain of the middle convs (nonzero source vectors, per-copy
prot state) takes the fused branch when `fused_pp` is set: node tables
`h_src @ W1_h` and `v_src @ Wh[1:]`, then one `ops/pp_message` call (the
K2 kernel on the card) for the gather, the chain and the masked K-sum,
with the edge descriptors kept at pocket-group level.

`compute_dtype` ("float32" or "bfloat16") is the dtype of the
edge-message chains of all four edge types; aggregation, the residual
stream, layer norms and node updates stay fp32 (JAX conv.py:583-586).

Sampling runs the JAX package's reorderings of the same math
(`GVPMultiEdgeConv.forward`): the compact prot tail (`prot_dst_idx`), the
group-level prot state of the first conv (`prot_feats_group_size`,
`pf_src_group_size`), the pocket-copy correction (`emit_clean_prot`
on the first conv, `pp_correction` on the second), and the step tables
(`step_tables`, then `pp_precomputed` and `pf_table` on the first
conv).

Where the JAX package scatters and gathers with one-hot matmuls (a TPU
workaround), the port uses indexed loads, `scatter_add_` and
`index_add_`.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from pharmaforge_tpu_torch.models.edges import (
    EdgeData,
    GroupedEdgeData,
    PreGatheredEdgeData,
    ReverseEdgeData,
)
from pharmaforge_tpu_torch.models.gvp import (
    GVPChain,
    GVPDropout,
    GVPLayerNorm,
    gvp_specs,
)
from pharmaforge_tpu_torch.ops.geometry import norm_no_nan
from pharmaforge_tpu_torch.ops.pp_message import (
    COMPUTE_DTYPES,
    fused_message_agg,
)
from pharmaforge_tpu_torch.utils import trace

# canonical edge types (src_ntype, name, dst_ntype), reference
# dynamics_gvp.py:46-54; aggregation adds them in this order
ETYPES = (
    ("pharm", "ff", "pharm"),
    ("prot", "pf", "pharm"),
    ("pharm", "fp", "prot"),
    ("prot", "pp", "prot"),
)
NTYPES = ("pharm", "prot")


def norm_mode(message_norm) -> Tuple[bool, Dict[str, float]]:
    """Resolve `message_norm` (reference gvp.py:369-389) to
    (mean aggregation?, {ntype: divisor}); a divisor of 0 requests the
    dynamic average-degree normalization."""
    mn = message_norm
    if isinstance(mn, tuple):  # hashable stand-in for a per-ntype dict
        mn = dict(mn)
    if isinstance(mn, str):
        if mn != "mean":
            raise ValueError(
                f"message_norm must be 'mean' or a number, got {mn!r}")
        return True, {nt: 1.0 for nt in NTYPES}
    if isinstance(mn, dict):
        vals = {nt: float(mn[nt]) for nt in NTYPES}
    elif isinstance(mn, (int, float)):
        vals = {nt: float(mn) for nt in NTYPES}
    else:
        raise ValueError(f"invalid message_norm: {mn!r}")
    if any(v < 0 for v in vals.values()):
        raise ValueError(f"message_norm values must be >= 0, got {mn}")
    return False, vals


def message_norm_is_dynamic(message_norm) -> bool:
    """True where `message_norm` asks for the dynamic average-degree
    normalization (a value of 0), which couples every atom's update to the
    per-copy pharm sizes."""
    return any(v == 0.0 for v in norm_mode(message_norm)[1].values())


def message_specs(n: int, vector_size: int, scalar_size: int,
                  rbf_dim: int) -> list:
    """The message chain: GVP 0 takes (src scalars ++ RBF, unit direction
    ++ src vectors); the rest are square."""
    specs = gvp_specs(n, vector_size, scalar_size)
    specs[0] = dict(specs[0], dim_vectors_in=vector_size + 1,
                    dim_feats_in=scalar_size + rbf_dim)
    return specs


def source_table(chain: GVPChain, h_src, dtype: torch.dtype):
    """The first message GVP's source-scalar product per node,
    h_src @ W1_h in `dtype` (JAX conv.py:251-266, `return_table` with zero
    source vectors): the half of the chain that does not depend on the
    edge, which the step tables compute once for every step of a chain."""
    w1_h = chain[0].to_feats_out[0].weight[:, :h_src.shape[-1]]
    return h_src.to(dtype) @ w1_h.T.to(dtype)


def _chain_from_table(chain: GVPChain, pre_g, edge, n_vectors: int,
                      dtype: torch.dtype):
    """The message chain on edges whose first GVP takes its source-scalar
    product from a gathered `source_table` (pre_g [B,Nd,M,S]) and whose
    source vectors are zero. GVP 0's scalars are act(pre + rbf @ W1_d +
    sh @ W1_sh + b), each product in `dtype`, added in the JAX package's
    order (conv.py:321-329), so a bf16 table rounds where JAX rounds it."""
    g0 = chain[0]
    s, r = pre_g.shape[-1], edge.d_rbf.shape[-1]
    x_dir = edge.x_dir.to(dtype)[..., None, :]
    vec_in = torch.cat([x_dir, x_dir.new_zeros(
        x_dir.shape[:-2] + (n_vectors, 3))], dim=-2)
    vh = torch.einsum("...vc,vh->...hc", vec_in, g0.Wh.to(dtype))
    vu = torch.einsum("...hc,hu->...uc", vh, g0.Wu.to(dtype))
    sh = norm_no_nan(vh.float()).to(dtype)
    lin, act = g0.to_feats_out
    w = lin.weight.to(dtype)
    feats = act(pre_g + edge.d_rbf.to(dtype) @ w[:, s:s + r].T
                + sh @ w[:, s + r:].T + lin.bias.to(dtype))
    gates = g0.scalar_to_vector_gates
    gating = nn.functional.linear(feats, gates.weight.to(dtype),
                                  gates.bias.to(dtype))
    data = (feats, g0.vectors_activation(gating)[..., None] * vu)
    for layer in list(chain)[1:]:
        data = layer(data)
    return data


def edge_messages(chain: GVPChain, h_src, v_src, edge,
                  src_vectors_zero: bool = False,
                  dtype: torch.dtype = torch.float32,
                  src_group_size: int = 1, table=None):
    """Per-edge messages (scalars [B,Nd,M,S], vectors [B,Nd,M,V,3]) in
    `dtype`.

    The source rows are gathered at `edge.idx` (gathered layout), are
    already in slot order (PreGatheredEdgeData: a reshape), are the layout
    row itself (ReverseEdgeData) or span the whole source set (full
    layout). `src_group_size` = C > 1: the source rows are per pocket
    group ([B/C, ...]) and batch row b gathers from group b // C. With
    `src_vectors_zero` (the first conv, whose vector channels start at
    zero) the source vectors are not gathered. `table` (a
    `source_table` of the source rows, with `src_vectors_zero`) is
    gathered in place of `h_src`, which is then not read."""
    if table is not None:
        if not src_vectors_zero:
            raise ValueError("a source table needs zero source vectors")
        h_src = table
    if isinstance(edge, PreGatheredEdgeData):
        b, f, k = edge.mask.shape
        h_g = h_src.reshape(b, f, k, -1)
        v_g = None if src_vectors_zero else \
            v_src.reshape(b, f, k, *v_src.shape[-2:])
    elif isinstance(edge, ReverseEdgeData):
        k = edge.mask.shape[2]
        h_g = h_src[:, :, None].expand(-1, -1, k, -1)
        v_g = None if src_vectors_zero else \
            v_src[:, :, None].expand(-1, -1, k, -1, -1)
    elif edge.idx is not None:
        rows = torch.arange(edge.idx.shape[0], device=h_src.device)[
            :, None, None] // src_group_size
        h_g = h_src[rows, edge.idx]
        v_g = None if src_vectors_zero else v_src[rows, edge.idx]
    else:
        nd = edge.mask.shape[1]
        h_g = h_src[:, None].expand(-1, nd, -1, -1)
        v_g = None if src_vectors_zero else \
            v_src[:, None].expand(-1, nd, -1, -1, -1)
    if table is not None:
        return _chain_from_table(chain, h_g, edge, v_src.shape[-2], dtype)
    if v_g is None:
        v_g = h_g.new_zeros(h_g.shape[:-1] + v_src.shape[-2:])
    sca_in = torch.cat([h_g, edge.d_rbf], dim=-1).to(dtype)
    vec_in = torch.cat([edge.x_dir[..., None, :], v_g], dim=-2).to(dtype)
    return chain((sca_in, vec_in))


def _normalize(s_sum, v_sum, count, mean: bool):
    """The mean over the counted slots (0 over an empty set), or the sums
    as they are."""
    if not mean:
        return s_sum, v_sum
    denom = torch.clamp(count, min=1.0)
    return s_sum / denom[..., None], v_sum / denom[..., None, None]


def _aggregate(s_msg, v_msg, mask, mean: bool):
    """Masked reduction over the neighbor axis: (s [B,Nd,S], v [B,Nd,V,3],
    count [B,Nd]). The mean over an empty set is 0."""
    m = mask.to(s_msg.dtype)
    s_sum = torch.sum(s_msg * m[..., None], dim=2)
    v_sum = torch.sum(v_msg * m[..., None, None], dim=2)
    count = torch.sum(m, dim=2)
    return (*_normalize(s_sum, v_sum, count, mean), count)


def _scatter_aggregate(s_msg, v_msg, ed: ReverseEdgeData, mean: bool):
    """Scatter reverse-layout messages ([B,F,K,...], destination prot per
    slot) into the prot axis: (s [B,P,S], v [B,P,V,3], count [B,P]).
    Masked slots carry a zero payload."""
    b, f, k = ed.mask.shape
    m = ed.mask.to(s_msg.dtype).reshape(b, f * k)
    s = s_msg.reshape(b, f * k, -1) * m[..., None]
    n_v = v_msg.shape[-2]
    v = v_msg.reshape(b, f * k, n_v * 3) * m[..., None]
    payload = torch.cat([s, v, m[..., None]], dim=-1)
    idx = ed.idx.reshape(b, f * k, 1).expand(-1, -1, payload.shape[-1])
    agg = payload.new_zeros(b, ed.n_dst, payload.shape[-1])
    agg.scatter_add_(1, idx, payload)
    s_dim = s.shape[-1]
    s_sum = agg[..., :s_dim]
    v_sum = agg[..., s_dim:-1].reshape(b, ed.n_dst, n_v, 3)
    count = agg[..., -1]
    return (*_normalize(s_sum, v_sum, count, mean), count)


def gather_at(table, idx, group: int = 1):
    """Rows of `table` ([B/group, P, ...]) at per-row indices idx [B, E]:
    batch row b reads group b // group. Returns [B, E, ...]."""
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None] // group
    return table[rows, idx]


def _compact_scatter_aggregate(s_msg, v_msg, ed: ReverseEdgeData,
                               mean: bool):
    """fp aggregation onto the compact prot axis (pf-slot order; JAX
    conv.py:394): slot e = (f, k) gets the aggregate of the atom it lists,
    as the full-width scatter computes it. Returns (s [B,F*K,S],
    v [B,F*K,V,3], the global fp edge count [B])."""
    s_sum, v_sum, count = _scatter_aggregate(s_msg, v_msg, ed, mean=False)
    b, f, k = ed.mask.shape
    slots = ed.idx.reshape(b, f * k)
    s_sum, v_sum, count = (gather_at(a, slots)
                           for a in (s_sum, v_sum, count))
    s_sum, v_sum = _normalize(s_sum, v_sum, count, mean)
    return s_sum, v_sum, ed.mask.reshape(b, f * k).to(s_sum.dtype).sum(1)


def _compact_prot(s_agg, v_agg, cnt, prot_dst_idx, prot_mask, group: int):
    """Per-atom prot aggregates ([B/group, P, ...]) onto the compact slot
    axis [B, F*K, ...] (JAX conv.py:791), with the global edge count [B]
    that the dynamic norm reads."""
    pm = prot_mask.to(cnt.dtype)[::group]
    total = torch.sum(cnt * pm, dim=1)
    if group > 1:
        total = torch.repeat_interleave(total, group, dim=0)
    return (gather_at(s_agg, prot_dst_idx, group),
            gather_at(v_agg, prot_dst_idx, group), total)


def dirty_out_edges(ed: EdgeData, copies: int, corr: dict):
    """The per-copy pass of the pocket-copy correction as one K2 layout
    (JAX conv.py:896-923): every pp out-edge of a dirty atom is one
    destination row with K=1, whose single source is the atom's row among
    the dirty rows [B, m] (`corr`'s slots; keys as in
    `GVPMultiEdgeConv._fused_pp_corrected`).

    ed: the group-level pp edge [G, P, K]. Returns (the edge [B, m*K_out,
    1] with its geometry taken at the flat edge ids, those ids
    g*P*K + eid [B, m*K_out], the live-row mask [B, m*K_out] (valid first
    slot and valid out-edge), the out-edge ids eid [B, m*K_out])."""
    g, nd, k = ed.mask.shape
    e = nd * k
    b, m, k_out = corr["out_eid"].shape
    eid = corr["out_eid"].reshape(b, m * k_out)
    live = (corr["slot_mask"][..., None]
            & corr["out_mask"]).reshape(b, m * k_out)
    rows = torch.arange(b, device=eid.device)[:, None]
    flat = (rows // copies) * e + eid
    x_dir = ed.x_dir.reshape(g * e, 3)[flat]
    d_rbf = ed.d_rbf.reshape(g * e, -1)[flat]
    src = torch.arange(m, device=eid.device).repeat_interleave(k_out)
    return (EdgeData(live[..., None], src.expand(b, -1)[..., None],
                     x_dir[:, :, None], d_rbf[:, :, None]),
            flat, live, eid)


class GVPMultiEdgeConv(nn.Module):
    """One hetero GVP convolution over the four canonical edge types.

    `update_ntypes` lists the destination node types this conv updates.
    The last conv only feeds the pharm noise head, so it is built with
    ("pharm",): its prot-side message and update modules -- the dead prot
    tail -- do not exist.

    `fused_pp`: False runs every edge type on the plain path; True, "auto"
    or "interpret" (the JAX package's values) run the prot-prot chain
    through `ops.pp_message.fused_message_agg` wherever the JAX package
    does (a gathered pp edge, nonzero source vectors, no pocket-group
    dedup: the middle convs). `compute_dtype` is the edge-message chains'
    dtype."""

    def __init__(self, scalar_size: int = 128, vector_size: int = 16,
                 n_message_gvps: int = 1, n_update_gvps: int = 1,
                 rbf_dim: int = 16, message_norm=10, dropout: float = 0.0,
                 update_ntypes: Tuple[str, ...] = NTYPES,
                 compute_dtype: str = "float32", fused_pp=False):
        super().__init__()
        self.scalar_size, self.vector_size = scalar_size, vector_size
        self.rbf_dim = rbf_dim
        self.compute_dtype = compute_dtype
        self.dtype = COMPUTE_DTYPES[compute_dtype]
        self.fused_pp = bool(fused_pp)
        self.update_ntypes = tuple(update_ntypes)
        self.use_mean, self.norm_values = norm_mode(message_norm)
        self.edge_message_fns = nn.ModuleDict({
            "_".join(et): GVPChain(message_specs(
                n_message_gvps, vector_size, scalar_size, rbf_dim))
            for et in ETYPES if et[2] in self.update_ntypes})
        self.node_update_fns = nn.ModuleDict({
            nt: GVPChain(gvp_specs(n_update_gvps, vector_size, scalar_size))
            for nt in self.update_ntypes})
        self.message_layer_norms = nn.ModuleDict({
            nt: GVPLayerNorm(scalar_size) for nt in self.update_ntypes})
        self.update_layer_norms = nn.ModuleDict({
            nt: GVPLayerNorm(scalar_size) for nt in self.update_ntypes})
        self.dropout = GVPDropout(dropout)

    def _k2(self, chain: GVPChain, h_src, v_src, ed, copies: int = 1):
        """One `fused_message_agg` call (K2 on the card): the node tables
        in the compute dtype (JAX conv.py:252-255), the edge `ed` at
        pocket-group level when `copies` > 1. Returns the raw masked
        K-sums (s [B,Nd,S], v [B,Nd,V,3], fp32)."""
        dt, s = self.dtype, self.scalar_size
        g0 = chain[0]
        w1_h = g0.to_feats_out[0].weight[:, :s].T.to(dt)
        pre_s = h_src.to(dt) @ w1_h                          # [B,P,S]
        vh = torch.einsum("bpvc,vh->bpch", v_src.to(dt),
                          g0.Wh[1:].to(dt))                  # [B,P,3,H0]
        return fused_message_agg(
            pre_s, vh.unbind(2), ed, chain, scalar_size=s,
            vector_size=self.vector_size, rbf_dim=self.rbf_dim,
            compute_dtype=self.compute_dtype, copies=copies)

    def _fused_pp(self, chain: GVPChain, h_src, v_src, ed, copies: int):
        """(s_agg, v_agg, count) of the pp edge through one K2 call, then
        the plain path's normalization with counts from the full-width
        mask repeated over the copies (JAX conv.py:1014-1021)."""
        s_agg, v_agg = self._k2(chain, h_src, v_src, ed, copies)
        cnt = torch.sum(ed.mask.to(torch.float32), dim=2)
        if copies > 1:
            cnt = torch.repeat_interleave(cnt, copies, dim=0)
        return (*_normalize(s_agg, v_agg, cnt, self.use_mean), cnt)

    def _fused_pp_compact(self, chain: GVPChain, h_src, v_src, ed,
                          copies: int, prot_dst_idx, prot_mask):
        """The compact conv's pp aggregate: the edge's destination rows
        taken at the F*K compact slots before one K2 call at Nd = F*K,
        copies=1 (JAX conv.py:958-1020). Per-slot counts for the mean; the
        global count [B] (dynamic norm) from the full-width mask."""
        take = functools.partial(gather_at, idx=prot_dst_idx, group=copies)
        ed_k = EdgeData(*(take(a) for a in ed))
        s_agg, v_agg = self._k2(chain, h_src, v_src, ed_k)
        cnt_full = torch.sum(ed.mask.to(torch.float32), dim=2)
        if copies > 1:
            cnt_full = torch.repeat_interleave(cnt_full, copies, dim=0)
        total = torch.sum(cnt_full * prot_mask.to(torch.float32), dim=1)
        cnt_slots = torch.sum(ed_k.mask.to(torch.float32), dim=2)
        return (*_normalize(s_agg, v_agg, cnt_slots, self.use_mean), total)

    def _fused_pp_corrected(self, chain: GVPChain, h_src, v_src, ed,
                            copies: int, corr: dict):
        """The pp aggregate of the conv after the first, as a clean pass at
        pocket-group level plus a per-copy correction over the out-edges of
        the atoms whose state differs from the clean state (JAX
        conv.py:862-957).

        `corr`: clean_h [G,P,S] / clean_v [G,P,V,3] (the first conv's
        fp-free prot state), slots [B,m] (the dirty atoms: the pf lists),
        slot_mask [B,m] (valid, first occurrence), out_eid / out_mask
        [B,m,K_out] (each dirty atom's pp out-edges as flat ids dst*K+k).
        Edges from atoms outside the pf lists carry the clean message, so
        (actual - clean) over the dirty atoms' out-edges, added to the
        clean aggregate, is the per-copy aggregate up to the order of
        sums. Two K2 calls at K=1, where the masked K-sum is the edge's own
        message: the clean edges [G, Nd*K, 1], and the dirty out-edges
        [B, m*K_out, 1] on the dirty atoms' rows [B, m, ...]."""
        # counted as the kernels' wrappers count their launches: a pass
        # inside a CUDA graph capture counts once, where it is captured
        trace.count("conv.corrections")
        g, nd, k = ed.mask.shape
        e, r, nv = nd * k, self.rbf_dim, self.vector_size
        s_e, v_e = self._k2(chain, corr["clean_h"], corr["clean_v"],
                            EdgeData(ed.mask.reshape(g, e, 1),
                                     ed.idx.reshape(g, e, 1),
                                     ed.x_dir.reshape(g, e, 1, 3),
                                     ed.d_rbf.reshape(g, e, 1, r)))
        clean = torch.cat([s_e, v_e.reshape(g, e, nv * 3)], dim=-1)
        slots = corr["slots"]
        rows = torch.arange(slots.shape[0], device=slots.device)[:, None]
        ed_d, flat, live, eid = dirty_out_edges(ed, copies, corr)
        b, n_d = live.shape
        s_a, v_a = self._k2(chain, h_src[rows, slots], v_src[rows, slots],
                            ed_d)
        actual = torch.cat([s_a, v_a.reshape(b, n_d, nv * 3)], dim=-1)
        delta = actual - clean.reshape(g * e, -1)[flat] \
            * live[..., None].to(actual.dtype)
        # the clean aggregate (a reshape-sum of the clean edges) per copy,
        # the differences added at their destinations
        agg = torch.repeat_interleave(clean.reshape(g, nd, k, -1).sum(2),
                                      copies, dim=0)
        dst = rows * nd + torch.div(eid, k, rounding_mode="floor")
        agg = agg.reshape(b * nd, -1).index_add_(
            0, dst.reshape(-1), delta.reshape(b * n_d, -1))
        agg = agg.reshape(b, nd, -1)
        s_agg = agg[..., :self.scalar_size]
        v_agg = agg[..., self.scalar_size:].reshape(b, nd, nv, 3)
        cnt = torch.repeat_interleave(
            torch.sum(ed.mask.to(torch.float32), dim=2), copies, dim=0)
        return (*_normalize(s_agg, v_agg, cnt, self.use_mean), cnt)

    def step_tables(self, prot_scalars, pp_edge, pf: bool):
        """The (timestep, pocket)-only work of a first conv (zero source
        vectors) for prot scalars [R, P, S] (JAX
        dynamics.py:precompute_sampling_tables): the pp aggregate
        (s [R,P,S], v [R,P,V,3], count [R,P]) over `pp_edge` [R, P, K]
        before the message norm, None where this conv has no pp chain;
        and, where `pf`, the pf chain's `source_table` [R, P, S] in the
        compute dtype, else None. The same code as the per-step path."""
        pp = None
        chain = self.edge_message_fns["prot_pp_prot"] \
            if "prot_pp_prot" in self.edge_message_fns else None
        if chain is not None:
            zeros = prot_scalars.new_zeros(1, 1, self.vector_size, 3)
            s_msg, v_msg = edge_messages(chain, prot_scalars, zeros, pp_edge,
                                         True, self.dtype)
            pp = _aggregate(s_msg.float(), v_msg.float(), pp_edge.mask,
                            self.use_mean)
        table = source_table(self.edge_message_fns["prot_pf_pharm"],
                             prot_scalars, self.dtype) if pf else None
        return pp, table

    def _update(self, nt: str, h, v, s_msg, v_msg, mask, generator):
        """Residual update of node type `nt` from its normalized
        aggregates; padded slots stay exactly zero."""
        s_msg, v_msg = self.dropout(s_msg, v_msg, generator)
        h, v = self.message_layer_norms[nt](h + s_msg, v + v_msg)
        s_res, v_res = self.node_update_fns[nt]((h, v))
        s_res, v_res = self.dropout(s_res, v_res, generator)
        h, v = self.update_layer_norms[nt](h + s_res, v + v_res)
        return h * mask[..., None], v * mask[..., None, None]

    def forward(self, node_feats: Dict[str, tuple],
                node_masks: Dict[str, torch.Tensor], bundle: Dict[str, object],
                src_vectors_zero: bool = False,
                pp_src_group_size: int = 1,
                generator: Optional[torch.Generator] = None,
                prot_dst_idx: Optional[torch.Tensor] = None,
                pf_src_group_size: int = 1,
                prot_feats_group_size: int = 1,
                emit_clean_prot: bool = False,
                pp_correction: Optional[dict] = None,
                pp_precomputed: Optional[tuple] = None,
                pf_table: Optional[torch.Tensor] = None):
        """node_feats[nt] = (scalars [B,N,S], coords [B,N,3],
        vectors [B,N,V,3]); `bundle` from `edges.build_edge_bundle`.
        `generator` draws the dropout masks in train mode.

        `src_vectors_zero`: the source vector channels are all zero (the
        first conv). `pp_src_group_size` = C > 1: every C consecutive
        batch rows hold an identical pocket whose prot state is still
        copy-independent (the first conv), so the pp messages are computed
        once per pocket group and broadcast to the C copies.

        `prot_dst_idx` [B, F*K] (the compact prot tail, JAX conv.py:641):
        this conv is the last to update prot state and the next reads it
        only through its pf lists, so the prot update runs on those F*K
        slots alone and the returned prot state is [B, F*K, ...] in
        pf-slot order (a `PreGatheredEdgeData` pf edge reads it).
        `prot_feats_group_size` = C: the prot scalars and vectors arrive at
        pocket-group level [B/C, P, ...] (the deduplicated encoder; only
        with `prot_dst_idx`); the compact coordinates then come back as
        zeros, which nothing reads (later convs take geometry from the
        bundle). `pf_src_group_size` = C: the pf source rows are
        group-level.

        `emit_clean_prot` (the first conv of the pocket-copy correction,
        eval mode, grouped pp edge, constant norm) also returns the clean
        prot state: the same update at pocket-group level without the fp
        messages, equal to each copy's state at every atom outside the pf
        lists. The return is then (out, (clean_h [G,P,S],
        clean_v [G,P,V,3])). `pp_correction` (the next conv) takes the
        pp aggregate from `_fused_pp_corrected`; its keys are documented
        there. It engages on the fused path with a grouped pp edge, as in
        the JAX package.

        The step tables of a sampling chain (the first conv, JAX
        conv.py:641-690): `pp_precomputed` = (s, v, count) of
        `step_tables`, at pocket-group level when `pp_src_group_size` > 1,
        replaces the pp chain and its aggregation; `pf_table` (a
        `source_table`, group-level when `pf_src_group_size` > 1) is
        gathered in place of the pf source scalars."""
        if emit_clean_prot and self.training:
            raise ValueError("emit_clean_prot requires eval mode "
                             "(deterministic)")
        agg: Dict[str, tuple] = {}
        counts: Dict[str, torch.Tensor] = {}
        clean_pp = None
        for etype in ETYPES:
            src_nt, ename, dst_nt = etype
            if dst_nt not in self.update_ntypes:
                continue
            h_src, _, v_src = node_feats[src_nt]
            ed = bundle[ename]
            group = pp_src_group_size if ename == "pp" else 1
            b_full = node_masks[dst_nt].shape[0]
            compact = prot_dst_idx is not None and dst_nt == "prot"
            pp_pre = ename == "pp" and pp_precomputed is not None
            # the JAX package's gate (conv.py:850-852)
            fused = (self.fused_pp and ename == "pp" and ed.idx is not None
                     and not src_vectors_zero and group == 1)
            copies = 1
            if isinstance(ed, GroupedEdgeData):
                if group > 1:
                    if ed.copies != group:
                        raise ValueError(
                            f"grouped pp edge copies {ed.copies} != "
                            f"pp_src_group_size {group}")
                    ed = ed.as_edge_data()
                elif fused:
                    copies, ed = ed.copies, ed.as_edge_data()
                else:
                    ed = ed.expand()
            if group > 1 and not pp_pre:
                if not src_vectors_zero:
                    raise ValueError(
                        "pp_src_group_size > 1 requires src_vectors_zero: "
                        "after the first conv the prot state is per-copy")
                if b_full % group:
                    raise ValueError(f"batch {b_full} not divisible by "
                                     f"pocket group size {group}")
                g = b_full // group

                def first(a):
                    return a.reshape((g, group) + a.shape[1:])[:, 0]

                if h_src.shape[0] != g:
                    h_src, v_src = first(h_src), first(v_src)
                if ed.mask.shape[0] != g:
                    ed = EdgeData(*(first(a) for a in ed))

            chain = self.edge_message_fns["_".join(etype)]
            if pp_pre:
                res = pp_precomputed
                if compact:
                    res = _compact_prot(*res, prot_dst_idx,
                                        node_masks["prot"], group)
            elif fused and compact:
                res = self._fused_pp_compact(chain, h_src, v_src, ed,
                                             copies, prot_dst_idx,
                                             node_masks["prot"])
            elif fused and pp_correction is not None and copies > 1:
                res = self._fused_pp_corrected(chain, h_src, v_src, ed,
                                               copies, pp_correction)
            elif fused:
                res = self._fused_pp(chain, h_src, v_src, ed, copies)
            else:
                s_msg, v_msg = edge_messages(
                    chain, h_src, v_src, ed, src_vectors_zero, self.dtype,
                    src_group_size=pf_src_group_size if ename == "pf"
                    else 1, table=pf_table if ename == "pf" else None)
                s_msg, v_msg = s_msg.float(), v_msg.float()
                if isinstance(ed, ReverseEdgeData):
                    agg_fn = (_compact_scatter_aggregate if compact
                              else _scatter_aggregate)
                    res = agg_fn(s_msg, v_msg, ed, self.use_mean)
                else:
                    res = _aggregate(s_msg, v_msg, ed.mask, self.use_mean)
                    if compact:
                        res = _compact_prot(*res, prot_dst_idx,
                                            node_masks["prot"], group)
            if emit_clean_prot and ename == "pp":
                if compact or group <= 1:
                    raise ValueError(
                        "emit_clean_prot requires a grouped, non-compact "
                        "pp edge (the correction dataflow's first conv)")
                # the group-level pp aggregate before the per-copy
                # broadcast: the fp-free share of the prot aggregate
                clean_pp = res
            if group > 1 and not compact:
                res = (torch.repeat_interleave(a, group, dim=0) for a in res)
            self._add(agg, counts, dst_nt, *res)

        out: Dict[str, tuple] = {}
        clean = None
        for nt in NTYPES:
            if nt not in self.update_ntypes:
                out[nt] = node_feats[nt]
                continue
            h, x, v = node_feats[nt]
            full_mask = node_masks[nt].to(torch.float32)
            mask = full_mask
            compact = prot_dst_idx is not None and nt == "prot"
            if compact:
                # the residual stream's rows at the compact slots
                gsz = prot_feats_group_size
                h = gather_at(h, prot_dst_idx, gsz)
                v = gather_at(v, prot_dst_idx, gsz)
                mask = gather_at(full_mask, prot_dst_idx)
                x = (gather_at(x, prot_dst_idx) if gsz == 1 else
                     x.new_zeros(prot_dst_idx.shape + (3,)))
            s_msg, v_msg = agg[nt]
            nv = self.norm_values[nt]
            if nv == 0.0:
                # dynamic per-graph normalization: average in-degree + 1
                # (reference gvp.py:504-507); the compact tail carries the
                # global count
                n_edges = counts[nt] if compact else \
                    torch.sum(counts[nt] * mask, dim=1)
                n_nodes = torch.clamp(torch.sum(full_mask, dim=1), min=1.0)
                norm = (n_edges / n_nodes + 1.0)[:, None, None]
                s_msg = s_msg / norm
                v_msg = v_msg / norm[..., None]
            else:
                s_msg = s_msg / nv
                v_msg = v_msg / nv
            h, v = self._update(nt, h, v, s_msg, v_msg, mask, generator)
            out[nt] = (h, x, v)
            if emit_clean_prot and nt == "prot":
                if clean_pp is None:
                    raise ValueError(
                        "emit_clean_prot: no grouped pp aggregate")
                if nv == 0.0:
                    raise ValueError(
                        "emit_clean_prot requires a non-dynamic "
                        "message_norm (the dynamic norm is per-copy)")
                # the same update on the group-level fp-free aggregate
                hg, _, vg = node_feats["prot"]
                c = pp_src_group_size
                if hg.shape[0] != full_mask.shape[0] // c:
                    hg, vg = hg[::c], vg[::c]
                cs, cv, _ = clean_pp
                clean = self._update(nt, hg, vg, cs / nv, cv / nv,
                                     full_mask[::c], generator)
        if emit_clean_prot:
            return out, clean
        return out

    @staticmethod
    def _add(agg, counts, nt, s_agg, v_agg, cnt) -> None:
        """Sum one edge type's aggregates into destination type `nt`."""
        if nt in agg:
            agg[nt] = (agg[nt][0] + s_agg, agg[nt][1] + v_agg)
            counts[nt] = counts[nt] + cnt
        else:
            agg[nt] = (s_agg, v_agg)
            counts[nt] = cnt
