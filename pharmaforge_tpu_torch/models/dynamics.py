"""The noise-prediction network (denoiser) over dense masked point clouds.

Port of `pharmaforge_tpu/models/dynamics.py` (`ScalarEncoder`,
`NoisePredictionBlock` :126, `PharmRecDynamics` :177). The module tree
follows the reference (`pharm_encoder.{0,2}`, `prot_encoder.{0,2}`,
`noise_predictor.conv_layers.{i}`, `noise_predictor.noise_predictor`), so
reference state dicts load into it as they are.

The JAX package's compact prot tail, prot-encoder dedup and step tables
are exact reorderings of this same math; the port computes the
full-width path. The pocket-group dedup of the first conv's prot-prot
messages (`pocket_group_size`) is kept.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from pharmaforge_tpu_torch.models.conv import GVPMultiEdgeConv
from pharmaforge_tpu_torch.models.edges import build_edge_bundle
from pharmaforge_tpu_torch.models.gvp import GVPChain


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
                 compute_dtype: str = "float32", fused_pp=False):
        """`compute_dtype` and `fused_pp` go to every conv (the
        edge-message chains' dtype; the fused prot-prot branch of the
        middle convs)."""
        super().__init__()
        self.vector_size = vector_size
        self.cutoffs = dict(graph_cutoffs)
        self.ff_k = ff_k
        self.pf_k = pf_k
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
                generator: Optional[torch.Generator] = None):
        """pharm_h_t [B,F,nf], pharm_x_t [B,F,3], pharm_mask [B,F] bool,
        prot_h [B,P,rec_nf], prot_x [B,P,3], prot_mask [B,P] bool, t [B] in
        [0, 1]. `pp_edge` is the static prot-prot edge (EdgeData, or
        GroupedEdgeData at pocket-group level; `edges.build_pp_edge`).

        `pocket_group_size` = C > 1 declares that every C consecutive rows
        share one pocket and one t; the first conv then computes the
        prot-prot messages once per group. `generator` draws the dropout
        masks in train mode."""
        b, f = pharm_mask.shape
        p = prot_mask.shape[1]
        pmask = pharm_mask.to(pharm_x_t.dtype)[..., None]
        rmask = prot_mask.to(prot_x.dtype)[..., None]
        pharm_scalars = self.pharm_encoder(torch.cat(
            [pharm_h_t, t[:, None, None].expand(b, f, 1)], dim=-1)) * pmask
        prot_scalars = self.prot_encoder(torch.cat(
            [prot_h, t[:, None, None].expand(b, p, 1)], dim=-1)) * rmask
        # vector channels start at zero (dynamics_gvp.py:156-173)
        v_pharm = pharm_scalars.new_zeros(b, f, self.vector_size, 3)
        v_prot = prot_scalars.new_zeros(b, p, self.vector_size, 3)
        node_feats: Dict[str, tuple] = {
            "pharm": (pharm_scalars, pharm_x_t, v_pharm),
            "prot": (prot_scalars, prot_x, v_prot),
        }
        node_masks = {"pharm": pharm_mask, "prot": prot_mask}
        bundle = build_edge_bundle(pharm_x_t, pharm_mask, prot_x, prot_mask,
                                   self.cutoffs, ff_k=self.ff_k,
                                   pf_k=self.pf_k, pp_edge=pp_edge)
        for i, conv in enumerate(self.noise_predictor.conv_layers):
            node_feats = conv(
                node_feats, node_masks, bundle, src_vectors_zero=(i == 0),
                # prot state is copy-independent only before the first
                # fp update lands
                pp_src_group_size=pocket_group_size if i == 0 else 1,
                generator=generator)
        eps_h, eps_x = self.noise_predictor.noise_predictor(
            node_feats["pharm"][0], node_feats["pharm"][2])
        return eps_h * pmask, eps_x * pmask
