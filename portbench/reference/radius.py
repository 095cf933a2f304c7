"""Plain PyTorch reference of the PharmacoForge denoiser with radius
pocket-pharmacophore edges (`pf_k` 0).

The reference model's radius branch (eflynn8/pharmacophore-diffusion,
`models/dynamics_gvp.py:193-215`): with `pf_k` 0 the prot->pharm edges
(pf) are every (pharm centre, prot atom) pair within r_pf, both valid
(`torch_cluster.radius`, a strict `<` on the squared distance), and the
pharm->prot edges (fp) are the same pairs reversed. `radius` caps the
pairs at 100 per prot atom (`max_num_neighbors`, :211); a prot atom has at
most one pair per centre and there are at most 8 centres, so the cap
cannot bind and is left out.

Everything else is `model.py`'s, imported: the GVPs, the convolution, the
noise head, the pp and ff edges, the weights' names. Both pf and fp take
the convolution's "full" layout (every source slot of a destination, under
the pair mask): pf [B, F, P], each centre over every prot slot; fp
[B, P, F], each prot atom over every centre. It imports nothing of the
program.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from portbench.reference import model as rm


def radius_pairs(pharm_x, pharm_mask, prot_x, prot_mask, cutoff: float):
    """[B, F, P]: valid prot atom p lies strictly within `cutoff` of valid
    pharm centre f."""
    return ((rm.sqdist(pharm_x, prot_x) < cutoff * cutoff)
            & pharm_mask[:, :, None] & prot_mask[:, None, :])


def edge_bundle(pharm_x, pharm_mask, prot_x, prot_mask, pf_cutoff: float,
                ff_cutoff: float, pp):
    """The four edge types of one denoiser call (reference
    dynamics_gvp.py:187-227) with radius pf and fp."""
    f, p = pharm_x.shape[1], prot_x.shape[1]
    eye = torch.eye(f, dtype=torch.bool, device=pharm_x.device)
    ff_mask = ((rm.sqdist(pharm_x, pharm_x) < ff_cutoff * ff_cutoff)
               & pharm_mask[:, :, None] & pharm_mask[:, None, :] & ~eye)
    ff_dir, ff_rbf = rm.pair_geometry(
        pharm_x, pharm_x[:, None].expand(-1, f, -1, -1))
    pf_mask = radius_pairs(pharm_x, pharm_mask, prot_x, prot_mask,
                           pf_cutoff)
    pf_dir, pf_rbf = rm.pair_geometry(
        pharm_x, prot_x[:, None].expand(-1, f, -1, -1))
    fp_dir, fp_rbf = rm.pair_geometry(
        prot_x, pharm_x[:, None].expand(-1, p, -1, -1))
    return {"ff": ("full", ff_mask, None, ff_dir, ff_rbf),
            "pf": ("full", pf_mask, None, pf_dir, pf_rbf),
            "fp": ("full", pf_mask.transpose(1, 2), None, fp_dir, fp_rbf),
            "pp": ("gathered", pp[1], pp[0], pp[2], pp[3])}


class Dynamics(rm.Dynamics):
    """`model.Dynamics` on the radius edges of `edge_bundle` (cfg's
    "pf_cutoff")."""

    def forward(self, h_t, x_t, pharm_mask, prot_h, prot_x, prot_mask, t,
                pp, q=None, drop=None):
        b, f = pharm_mask.shape
        p = prot_mask.shape[1]
        v = self.cfg["vector_size"]
        pm = pharm_mask.to(torch.float32)[..., None]
        rmask = prot_mask.to(torch.float32)[..., None]
        drop = drop or (lambda a, c: (a, c))
        h = self.pharm_encoder(torch.cat(
            [h_t, t[:, None, None].expand(b, f, 1)], -1)) * pm
        hp = self.prot_encoder(torch.cat(
            [prot_h, t[:, None, None].expand(b, p, 1)], -1)) * rmask
        feats = {"pharm": (h, h.new_zeros(b, f, v, 3)),
                 "prot": (hp, hp.new_zeros(b, p, v, 3))}
        masks = {"pharm": pharm_mask, "prot": prot_mask}
        bundle = edge_bundle(x_t, pharm_mask, prot_x, prot_mask,
                             self.cfg["pf_cutoff"], self.cfg["ff_cutoff"],
                             pp)
        for conv in self.noise_predictor.conv_layers:
            feats = conv(feats, masks, bundle, q, drop)
        eps_h, eps_x = self.noise_predictor.noise_predictor(*feats["pharm"])
        return eps_h * pm, eps_x * pm


class Reference(rm.Reference):
    """`model.Reference` with the radius `Dynamics`: the same state dict."""

    def __init__(self, cfg: dict, precision: str = "float32"):
        nn.Module.__init__(self)
        self.dynamics = Dynamics(cfg)
        self.q = rm.rounder(precision)


def build(cfg: dict, weights: Dict[str, torch.Tensor], device,
          precision: str = "float32") -> Reference:
    """A radius reference on `device` holding copies of `weights`; `cfg`
    is `model.py`'s settings plus "pf_cutoff"."""
    with torch.device("meta"):
        model = Reference(cfg, precision)
    model = model.to_empty(device=device)
    model.load_state_dict({k: v.detach().clone() for k, v in weights.items()})
    return model
