"""The noise-prediction network (denoiser) over dense masked point clouds.

Port of `pharmaforge_tpu/models/dynamics.py` (`ScalarEncoder`,
`NoisePredictionBlock` :126, `PharmRecDynamics` :177). The module tree
follows the reference (`pharm_encoder.{0,2}`, `prot_encoder.{0,2}`,
`noise_predictor.conv_layers.{i}`, `noise_predictor.noise_predictor`), so
reference state dicts load into it as they are.

In eval mode the forward runs the JAX package's sampling dataflow: the
compact prot tail (the last prot update on the pf-listed atoms only), the
prot encoder once per pocket group when the first conv is the compact one,
and, given the pp out-edges (`pp_out`), the pocket-copy correction of the
second conv. Train mode keeps the full-width path, as in JAX. A sampling
chain may also hoist the first conv's (timestep, pocket)-only work out
of its loop into step tables (`precompute_sampling_tables`, JAX :52-123)
and hand the denoiser one step's slice (`step_tables`). The forward
makes no host sync and reads no per-step Python value, so a sampling
chain captures it in a CUDA graph (`diffusion.ChainGraphs`).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from pharmaforge_tpu_torch.models.conv import (
    GVPMultiEdgeConv,
    message_norm_is_dynamic,
)
from pharmaforge_tpu_torch.models.edges import (
    EdgeData,
    PreGatheredEdgeData,
    build_edge_bundle,
)
from pharmaforge_tpu_torch.models.gvp import GVPChain


class SamplingTables(NamedTuple):
    """The first conv's work that depends only on (timestep, pocket), for
    every step of a reverse chain (JAX dynamics.py:52-61); leading axis T
    in loop order, then the pocket groups G:

    enc       the prot encoder's masked output           [T, G, P, S]
    pp_s/v    the first conv's pp aggregate before the message norm
              [T, G, P, S] / [T, G, P, V, 3] fp32, and
    pp_cnt    its per-atom edge counts [T, G, P]; None where that conv has
              no pp chain (n_convs=1 with the pruned prot tail)
    pf_table  the pf chain's per-node source table in the compute dtype
              [T, G, P, S]; None without knn pf (pf_k 0)
    """

    enc: torch.Tensor
    pp_s: Optional[torch.Tensor]
    pp_v: Optional[torch.Tensor]
    pp_cnt: Optional[torch.Tensor]
    pf_table: Optional[torch.Tensor]

    def step(self, i) -> tuple:
        """Step i's slice of every table (None stays None). `i` is an int
        (views) or a [1] int64 tensor on the tables' device, read on the
        device, so that a captured chain step reads the step it replays."""
        if torch.is_tensor(i):
            return tuple(None if a is None else a.index_select(0, i)[0]
                         for a in self)
        return tuple(None if a is None else a[i] for a in self)


@torch.no_grad()
def precompute_sampling_tables(dynamics: "PharmRecDynamics", prot_h_g,
                               prot_mask_g, pp_edge_g, t_values,
                               chunk_steps: Optional[int] = None
                               ) -> SamplingTables:
    """`SamplingTables` of a reverse chain (JAX dynamics.py:64-123).

    prot_h_g [G, P, rec_nf], prot_mask_g [G, P] and `pp_edge_g` (EdgeData
    [G, P, K]) are at pocket-group level; t_values [T] are the chain's
    timesteps in loop order. The T axis folds into the batch axis, so the
    per-step code runs over T-fold larger operands. `chunk_steps` builds
    that many steps at a time (the rows are independent, so the tables
    are the same), bounding the memory of the pp chain's edge activations;
    None builds all T at once."""
    t_count = t_values.shape[0]
    g, p = prot_mask_g.shape
    conv0 = dynamics.noise_predictor.conv_layers[0]
    pf = bool(dynamics.pf_k and dynamics.pf_k > 0)
    chunk = t_count if not chunk_steps else min(chunk_steps, t_count)
    pm = prot_mask_g.to(torch.float32)[..., None]
    outs = None
    for t0 in range(0, t_count, chunk):
        tv = t_values[t0:t0 + chunk]
        n = tv.shape[0]

        def tile(a):
            return a.unsqueeze(0).expand(n, *a.shape).reshape(
                n * g, *a.shape[1:])

        enc = dynamics.prot_encoder(torch.cat(
            [tile(prot_h_g), tv[:, None, None, None].expand(n, g, p, 1)
             .reshape(n * g, p, 1)], dim=-1)) * tile(pm)
        pp, table = conv0.step_tables(
            enc, EdgeData(*(tile(a) for a in pp_edge_g)), pf)
        parts = (enc, *(pp or (None,) * 3), table)
        if outs is None:
            outs = [None if a is None else a.new_empty((t_count, g)
                                                       + a.shape[1:])
                    for a in parts]
        for out, part in zip(outs, parts):
            if out is not None:
                out[t0:t0 + n] = part.reshape((n, g) + part.shape[1:])
    return SamplingTables(*outs)


class ScalarEncoder(nn.Sequential):
    """Linear + SiLU + LayerNorm(eps=1e-5) node-feature encoder
    (reference dynamics_gvp.py:107-117); children 0, 1, 2."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__(nn.Linear(in_dim, hidden), nn.SiLU(),
                         nn.LayerNorm(hidden, eps=1e-5))


class NoisePredictionBlock(nn.Module):
    """GVP chain -> (out_scalar_dim scalars, one 3-vector) per pharm node
    (reference dynamics_gvp.py:10-42): all GVPs but the last keep the
    width with sigmoid gates; the last maps to (intermediate scalars, one
    vector) with identity gating, then a Linear to the outputs."""

    def __init__(self, in_scalar_dim: int, out_scalar_dim: int,
                 vector_size: int, n_gvps: int = 3,
                 intermediate_scalar_dim: int = 64):
        super().__init__()
        specs = []
        for i in range(n_gvps):
            last = i == n_gvps - 1
            specs.append(dict(
                dim_vectors_in=vector_size,
                dim_vectors_out=1 if last else vector_size,
                dim_feats_in=in_scalar_dim,
                dim_feats_out=(intermediate_scalar_dim if last
                               else in_scalar_dim),
                vectors_activation="identity" if last else "sigmoid"))
        self.gvps = GVPChain(specs)
        self.to_scalar_output = nn.Linear(intermediate_scalar_dim,
                                          out_scalar_dim)

    def forward(self, scalars, vectors):
        scalars, vectors = self.gvps((scalars, vectors))
        return self.to_scalar_output(scalars), vectors[..., 0, :]


class PharmRecGVP(nn.Module):
    """Container matching the reference module path
    `noise_predictor.{conv_layers, noise_predictor}`."""

    def __init__(self, conv_layers, noise_predictor):
        super().__init__()
        self.conv_layers = nn.ModuleList(conv_layers)
        self.noise_predictor = noise_predictor


class PharmRecDynamics(nn.Module):
    """eps_theta(z_t, t | pocket): predicts (feature noise, coordinate
    noise), masked to the valid pharm slots."""

    def __init__(self, n_pharm_scalars: int = 6, n_prot_scalars: int = 11,
                 vector_size: int = 16, n_convs: int = 4,
                 n_hidden_scalars: int = 128, message_norm=1,
                 graph_cutoffs=(("pp", 3.5), ("pf", 8.0), ("fp", 8.0),
                                ("ff", 9.0)),
                 n_message_gvps: int = 3, n_update_gvps: int = 2,
                 n_noise_gvps: int = 3, dropout: float = 0.0,
                 ff_k: int = 0, pf_k: int = 0,
                 prune_dead_prot_tail: bool = True,
                 compact_prot_tail: bool = True,
                 dedup_prot_encoder: bool = True,
                 compute_dtype: str = "float32", fused_pp=False):
        """`compute_dtype` and `fused_pp` go to every conv (the
        edge-message chains' dtype; the fused prot-prot branch of the
        middle convs). `compact_prot_tail` and `dedup_prot_encoder` are
        the JAX package's switches of the same names."""
        super().__init__()
        self.vector_size = vector_size
        self.cutoffs = dict(graph_cutoffs)
        self.ff_k = ff_k
        self.pf_k = pf_k
        self.n_convs = n_convs
        self.message_norm = message_norm
        self.prune_dead_prot_tail = prune_dead_prot_tail
        self.compact_prot_tail = compact_prot_tail
        self.dedup_prot_encoder = dedup_prot_encoder
        s = n_hidden_scalars
        self.pharm_encoder = ScalarEncoder(n_pharm_scalars + 1, s)
        self.prot_encoder = ScalarEncoder(n_prot_scalars + 1, s)
        convs = []
        for i in range(n_convs):
            last = i == n_convs - 1
            convs.append(GVPMultiEdgeConv(
                scalar_size=s, vector_size=vector_size,
                n_message_gvps=n_message_gvps, n_update_gvps=n_update_gvps,
                message_norm=message_norm, dropout=dropout,
                update_ntypes=("pharm",) if last and prune_dead_prot_tail
                else ("pharm", "prot"),
                compute_dtype=compute_dtype, fused_pp=fused_pp))
        self.noise_predictor = PharmRecGVP(convs, NoisePredictionBlock(
            in_scalar_dim=s, out_scalar_dim=n_pharm_scalars,
            vector_size=vector_size, n_gvps=n_noise_gvps))

    def forward(self, pharm_h_t, pharm_x_t, pharm_mask, prot_h, prot_x,
                prot_mask, t, pp_edge, pocket_group_size: int = 1,
                generator: Optional[torch.Generator] = None, pp_out=None,
                step_tables: Optional[tuple] = None,
                pf_slots: Optional[int] = None):
        """pharm_h_t [B,F,nf], pharm_x_t [B,F,3], pharm_mask [B,F] bool,
        prot_h [B,P,rec_nf], prot_x [B,P,3], prot_mask [B,P] bool, t [B] in
        [0, 1]. `pp_edge` is the static prot-prot edge (EdgeData, or
        GroupedEdgeData at pocket-group level; `edges.build_pp_edge`).

        `pocket_group_size` = C > 1 declares that every C consecutive rows
        share one pocket and one t; the first conv then computes the
        prot-prot messages once per group. `generator` draws the dropout
        masks in train mode; eval mode is the JAX `deterministic=True`.
        `pp_out` = (out_eid, out_mask) of `edges.build_pp_out_edges` on the
        group-level pp edge turns the pocket-copy correction on where the
        JAX package engages it (dynamics.py:361-365).

        `step_tables` is one step's slice of `SamplingTables` (`step(i)`:
        enc, pp_s, pp_v, pp_cnt, pf_table at pocket-group level, G = B /
        C): the prot encoder and the first conv's pp chain do not run, and
        its pf chain gathers the table (JAX dynamics.py:271-291). Eval
        mode only. When the first conv is the compact one, the prot
        scalars stay at group level; otherwise they are repeated per
        copy.

        `pf_slots` (radius pf, pf_k 0) is a sampling chain's slot count M
        (`edges.radius_slot_count`): the pf and fp edges then run on
        [B, F, M] slots in place of the dense [B, F, P] layout."""
        b, f = pharm_mask.shape
        p = prot_mask.shape[1]
        c = pocket_group_size
        # the compact prot tail: the conv before the last is the last
        # writer of prot state, which the last conv reads only through its
        # pf lists (JAX dynamics.py:257-260)
        compact_at = self.n_convs - 2 if (
            self.compact_prot_tail and self.prune_dead_prot_tail
            and self.n_convs >= 2 and self.pf_k and self.pf_k > 0
            and not self.training) else None
        pmask = pharm_mask.to(pharm_x_t.dtype)[..., None]
        pharm_scalars = self.pharm_encoder(torch.cat(
            [pharm_h_t, t[:, None, None].expand(b, f, 1)], dim=-1)) * pmask
        pp_pre = pf_table = None
        if step_tables is not None:
            if self.training:
                raise ValueError("step_tables require eval mode")
            enc_g, pp_s, pp_v, pp_cnt, pf_table = step_tables
            if enc_g.shape[0] * c != b:
                raise ValueError(
                    f"step_tables group axis {enc_g.shape[0]} x "
                    f"pocket_group_size {c} != batch {b}")
            if pp_s is not None:
                pp_pre = (pp_s, pp_v, pp_cnt)
            # a compact first conv reads every prot input group-folded,
            # so the [B, P, S] broadcast never happens
            prot_group = c if compact_at == 0 and pf_table is not None \
                else 1
            prot_scalars = enc_g if prot_group > 1 or c == 1 else \
                torch.repeat_interleave(enc_g, c, dim=0)
        else:
            # every consumer of the first conv's prot state reads it
            # group-folded when that conv is the compact one, so the
            # encoder runs once per pocket group (JAX dynamics.py:299-312)
            prot_group = c if (self.dedup_prot_encoder and c > 1
                               and compact_at == 0) else 1
            ph, pm, tp = prot_h[::prot_group], prot_mask[::prot_group], \
                t[::prot_group]
            prot_scalars = self.prot_encoder(torch.cat(
                [ph, tp[:, None, None].expand(-1, p, 1)], dim=-1)) \
                * pm.to(prot_x.dtype)[..., None]
        pf_group = c if pf_table is not None else prot_group
        # vector channels start at zero (dynamics_gvp.py:156-173)
        v_pharm = pharm_scalars.new_zeros(b, f, self.vector_size, 3)
        v_prot = prot_scalars.new_zeros(prot_scalars.shape[0], p,
                                        self.vector_size, 3)
        node_feats: Dict[str, tuple] = {
            "pharm": (pharm_scalars, pharm_x_t, v_pharm),
            "prot": (prot_scalars, prot_x, v_prot),
        }
        node_masks = {"pharm": pharm_mask, "prot": prot_mask}
        bundle = build_edge_bundle(pharm_x_t, pharm_mask, prot_x, prot_mask,
                                   self.cutoffs, ff_k=self.ff_k,
                                   pf_k=self.pf_k, pp_edge=pp_edge,
                                   pf_slots=pf_slots)
        corr = None
        if (pp_out is not None and c > 1 and compact_at is not None
                and compact_at >= 2
                and not message_norm_is_dynamic(self.message_norm)):
            corr = dirty_slots(bundle["pf"], pp_out, c)
        clean = None
        for i, conv in enumerate(self.noise_predictor.conv_layers):
            pf = bundle["pf"]
            prot_dst_idx = pf.idx.reshape(b, -1) if i == compact_at else None
            res = conv(
                node_feats, node_masks, bundle, src_vectors_zero=(i == 0),
                # prot state is copy-independent only before the first
                # fp update lands
                pp_src_group_size=c if i == 0 else 1,
                generator=generator, prot_dst_idx=prot_dst_idx,
                pf_src_group_size=pf_group if i == 0 else 1,
                prot_feats_group_size=prot_group if i == 0 else 1,
                emit_clean_prot=corr is not None and i == 0,
                pp_correction=dict(corr, clean_h=clean[0],
                                   clean_v=clean[1])
                if corr is not None and i == 1 else None,
                pp_precomputed=pp_pre if i == 0 else None,
                pf_table=pf_table if i == 0 else None)
            if corr is not None and i == 0:
                node_feats, clean = res
            else:
                node_feats = res
            if prot_dst_idx is not None:
                # prot state is now compact: the last conv reads it through
                # pf only, which becomes a reshape
                bundle = dict(bundle, pf=PreGatheredEdgeData(
                    mask=pf.mask, x_dir=pf.x_dir, d_rbf=pf.d_rbf))
        eps_h, eps_x = self.noise_predictor.noise_predictor(
            node_feats["pharm"][0], node_feats["pharm"][2])
        return eps_h * pmask, eps_x * pmask


def dirty_slots(pf, pp_out, c: int) -> dict:
    """The correction's per-copy inputs (JAX dynamics.py:366-383): the
    pf-listed atoms of each row (slots [B, m]), valid and first in
    their row (slot_mask), and their pp out-edges (out_eid / out_mask
    [B, m, K_out]) from the group-level tables `pp_out`."""
    b = pf.idx.shape[0]
    slots = pf.idx.reshape(b, -1)
    valid = pf.mask.reshape(b, -1)
    m = slots.shape[1]
    # a dirty atom listed twice contributes its corrections once
    earlier = torch.ones(m, m, dtype=torch.bool,
                         device=slots.device).tril(-1)
    dup = torch.any((slots[:, :, None] == slots[:, None, :]) & earlier
                    & valid[:, None, :], dim=2)
    out_eid, out_mask = pp_out
    rows = torch.arange(b, device=slots.device)[:, None] // c
    return dict(slots=slots, slot_mask=valid & ~dup,
                out_eid=out_eid[rows, slots],
                out_mask=out_mask[rows, slots])
