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

Where the JAX package scatters and gathers with one-hot matmuls (a TPU
workaround), the port uses indexed loads and `scatter_add_`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from pharmaforge_tpu_torch.models.edges import (
    EdgeData,
    GroupedEdgeData,
    ReverseEdgeData,
)
from pharmaforge_tpu_torch.models.gvp import (
    GVPChain,
    GVPDropout,
    GVPLayerNorm,
    gvp_specs,
)
from pharmaforge_tpu_torch.ops.pp_message import (
    COMPUTE_DTYPES,
    fused_message_agg,
)

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


def message_specs(n: int, vector_size: int, scalar_size: int,
                  rbf_dim: int) -> list:
    """The message chain: GVP 0 takes (src scalars ++ RBF, unit direction
    ++ src vectors); the rest are square."""
    specs = gvp_specs(n, vector_size, scalar_size)
    specs[0] = dict(specs[0], dim_vectors_in=vector_size + 1,
                    dim_feats_in=scalar_size + rbf_dim)
    return specs


def edge_messages(chain: GVPChain, h_src, v_src, edge,
                  src_vectors_zero: bool = False,
                  dtype: torch.dtype = torch.float32):
    """Per-edge messages (scalars [B,Nd,M,S], vectors [B,Nd,M,V,3]) in
    `dtype`.

    The source rows are gathered at `edge.idx` (gathered layout), are the
    layout row itself (ReverseEdgeData) or span the whole source set (full
    layout). With `src_vectors_zero` (the first conv, whose vector
    channels start at zero) the source vectors are not gathered."""
    if isinstance(edge, ReverseEdgeData):
        k = edge.mask.shape[2]
        h_g = h_src[:, :, None].expand(-1, -1, k, -1)
        v_g = None if src_vectors_zero else \
            v_src[:, :, None].expand(-1, -1, k, -1, -1)
    elif edge.idx is not None:
        rows = torch.arange(h_src.shape[0], device=h_src.device)[:, None,
                                                                  None]
        h_g = h_src[rows, edge.idx]
        v_g = None if src_vectors_zero else v_src[rows, edge.idx]
    else:
        nd = edge.mask.shape[1]
        h_g = h_src[:, None].expand(-1, nd, -1, -1)
        v_g = None if src_vectors_zero else \
            v_src[:, None].expand(-1, nd, -1, -1, -1)
    if v_g is None:
        v_g = h_g.new_zeros(h_g.shape[:-1] + v_src.shape[-2:])
    sca_in = torch.cat([h_g, edge.d_rbf], dim=-1).to(dtype)
    vec_in = torch.cat([edge.x_dir[..., None, :], v_g], dim=-2).to(dtype)
    return chain((sca_in, vec_in))


def _aggregate(s_msg, v_msg, mask, mean: bool):
    """Masked reduction over the neighbor axis: (s [B,Nd,S], v [B,Nd,V,3],
    count [B,Nd]). The mean over an empty set is 0."""
    m = mask.to(s_msg.dtype)
    s_sum = torch.sum(s_msg * m[..., None], dim=2)
    v_sum = torch.sum(v_msg * m[..., None, None], dim=2)
    count = torch.sum(m, dim=2)
    if mean:
        denom = torch.clamp(count, min=1.0)
        s_sum = s_sum / denom[..., None]
        v_sum = v_sum / denom[..., None, None]
    return s_sum, v_sum, count


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
    if mean:
        denom = torch.clamp(count, min=1.0)
        s_sum = s_sum / denom[..., None]
        v_sum = v_sum / denom[..., None, None]
    return s_sum, v_sum, count


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

    def _fused_pp(self, chain: GVPChain, h_src, v_src, ed):
        """(s_agg, v_agg, count) of the pp edge through the fused message
        chain: the node tables in the compute dtype (JAX
        conv.py:252-255), one `fused_message_agg` call on the (possibly
        pocket-group-level) edge, then the plain path's normalization
        with counts from the full-width mask repeated over the copies
        (:1014-1021)."""
        dt, s = self.dtype, self.scalar_size
        copies = getattr(ed, "copies", 1)
        g0 = chain[0]
        w1_h = g0.to_feats_out[0].weight[:, :s].T.to(dt)
        pre_s = h_src.to(dt) @ w1_h                          # [B,P,S]
        vh = torch.einsum("bpvc,vh->bpch", v_src.to(dt),
                          g0.Wh[1:].to(dt))                  # [B,P,3,H0]
        s_agg, v_agg = fused_message_agg(
            pre_s, vh.unbind(2), ed, chain, scalar_size=s,
            vector_size=self.vector_size, rbf_dim=self.rbf_dim,
            compute_dtype=self.compute_dtype, copies=copies)
        cnt = torch.sum(ed.mask.to(torch.float32), dim=2)
        if copies > 1:
            cnt = torch.repeat_interleave(cnt, copies, dim=0)
        if self.use_mean:
            denom = torch.clamp(cnt, min=1.0)
            s_agg = s_agg / denom[..., None]
            v_agg = v_agg / denom[..., None, None]
        return s_agg, v_agg, cnt

    def forward(self, node_feats: Dict[str, tuple],
                node_masks: Dict[str, torch.Tensor], bundle: Dict[str, object],
                src_vectors_zero: bool = False,
                pp_src_group_size: int = 1) -> Dict[str, tuple]:
        """node_feats[nt] = (scalars [B,N,S], coords [B,N,3],
        vectors [B,N,V,3]); `bundle` from `edges.build_edge_bundle`.

        `src_vectors_zero`: the source vector channels are all zero (the
        first conv). `pp_src_group_size` = C > 1: every C consecutive
        batch rows hold an identical pocket whose prot state is still
        copy-independent (the first conv), so the pp messages are computed
        once per pocket group and broadcast to the C copies."""
        agg: Dict[str, tuple] = {}
        counts: Dict[str, torch.Tensor] = {}
        for etype in ETYPES:
            src_nt, ename, dst_nt = etype
            if dst_nt not in self.update_ntypes:
                continue
            h_src, _, v_src = node_feats[src_nt]
            ed = bundle[ename]
            group = pp_src_group_size if ename == "pp" else 1
            b_full = node_masks[dst_nt].shape[0]
            # the JAX package's gate (conv.py:850-852)
            fused = (self.fused_pp and ename == "pp" and ed.idx is not None
                     and not src_vectors_zero and group == 1)
            if isinstance(ed, GroupedEdgeData):
                if group > 1:
                    if ed.copies != group:
                        raise ValueError(
                            f"grouped pp edge copies {ed.copies} != "
                            f"pp_src_group_size {group}")
                    ed = ed.as_edge_data()
                elif not fused:
                    ed = ed.expand()
            if group > 1:
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
            if fused:
                self._add(agg, counts, dst_nt,
                          *self._fused_pp(chain, h_src, v_src, ed))
                continue
            s_msg, v_msg = edge_messages(chain, h_src, v_src, ed,
                                         src_vectors_zero, self.dtype)
            s_msg, v_msg = s_msg.float(), v_msg.float()
            if isinstance(ed, ReverseEdgeData):
                s_agg, v_agg, cnt = _scatter_aggregate(s_msg, v_msg, ed,
                                                       self.use_mean)
            else:
                s_agg, v_agg, cnt = _aggregate(s_msg, v_msg, ed.mask,
                                               self.use_mean)
            if group > 1:
                s_agg, v_agg, cnt = (torch.repeat_interleave(a, group, dim=0)
                                     for a in (s_agg, v_agg, cnt))
            self._add(agg, counts, dst_nt, s_agg, v_agg, cnt)

        out: Dict[str, tuple] = {}
        for nt in NTYPES:
            if nt not in self.update_ntypes:
                out[nt] = node_feats[nt]
                continue
            h, x, v = node_feats[nt]
            mask = node_masks[nt].to(h.dtype)
            s_msg, v_msg = agg[nt]
            nv = self.norm_values[nt]
            if nv == 0.0:
                # dynamic per-graph normalization: average in-degree + 1
                # (reference gvp.py:504-507)
                n_edges = torch.sum(counts[nt] * mask, dim=1)
                n_nodes = torch.clamp(torch.sum(mask, dim=1), min=1.0)
                norm = (n_edges / n_nodes + 1.0)[:, None, None]
                s_msg = s_msg / norm
                v_msg = v_msg / norm[..., None]
            else:
                s_msg = s_msg / nv
                v_msg = v_msg / nv
            s_msg, v_msg = self.dropout(s_msg, v_msg)
            h, v = self.message_layer_norms[nt](h + s_msg, v + v_msg)
            s_res, v_res = self.node_update_fns[nt]((h, v))
            s_res, v_res = self.dropout(s_res, v_res)
            h, v = self.update_layer_norms[nt](h + s_res, v + v_res)
            # padded slots stay exactly zero
            out[nt] = (h * mask[..., None], x, v * mask[..., None, None])
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
