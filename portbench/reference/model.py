"""Plain PyTorch reference of the PharmacoForge denoiser.

The reference PharmacoForge model (eflynn8/pharmacophore-diffusion,
`models/dynamics_gvp.py` and `models/gvp.py`) written out once more in
plain torch operations, for the benchmark's check of what the program
computes. It imports nothing of the program. It runs the full-width
dataflow that the reference describes: every pocket copy of every row is
computed on its own, the prot-prot messages of every conv are gathered per
edge, no table, graph or kernel of the program is used.

Parameter names follow the reference's state-dict layout (which the
program keeps), so one set of weights, made by the benchmark from its
seed, loads into both.

Precision. `precision` names the edge-message chains' arithmetic: "float32"
(everything in fp32), or a lower type ("bfloat16", "float8") that every
operand and result of those chains is rounded to while the products
accumulate in fp32, as tensor cores do. Node updates, norms and
aggregation stay fp32 in every mode.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
from torch import nn

RBF_DIM = 16
RBF_DMAX = 15.0
BIG = 1e30
# canonical edge types (source, name, destination), reference
# dynamics_gvp.py:46-54; aggregation adds them in this order
ETYPES = (("pharm", "ff", "pharm"), ("prot", "pf", "pharm"),
          ("pharm", "fp", "prot"), ("prot", "pp", "prot"))
NTYPES = ("pharm", "prot")

ROUNDING = {"float32": None, "bfloat16": torch.bfloat16,
            "float8": torch.float8_e4m3fn}


def rounder(precision: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """x -> x rounded to `precision` and held in fp32 (the identity for
    float32)."""
    dt = ROUNDING[precision]
    if dt is None:
        return lambda x: x
    return lambda x: x.to(dt).to(torch.float32)


def norm_no_nan(x, dim=-1, keepdim=False, eps=1e-8, sqrt=True):
    out = torch.clamp(torch.sum(x * x, dim=dim, keepdim=keepdim), min=eps)
    return torch.sqrt(out) if sqrt else out


def pair_geometry(x_dst, x_src_pairs):
    """Unit direction src - dst and the RBF of the distance (+1e-8)."""
    diff = x_src_pairs - x_dst[:, :, None, :]
    d = norm_no_nan(diff, keepdim=True) + 1e-8
    mu = torch.linspace(0.0, RBF_DMAX, RBF_DIM, dtype=d.dtype,
                        device=d.device)
    sigma = RBF_DMAX / RBF_DIM
    return diff / d, torch.exp(-(((d - mu) / sigma) ** 2))


def sqdist(a, b):
    """[B,N,3] x [B,M,3] -> [B,N,M], summed x, y, z in that order."""
    diff = a[:, :, None, :] - b[:, None, :, :]
    sq = diff * diff
    return sq[..., 0] + sq[..., 1] + sq[..., 2]


def nearest(d2, valid, k):
    """(indices, mask) of the k smallest valid entries of each row, ties
    to the lower index."""
    vals, idx = torch.sort(torch.where(valid, d2, BIG), dim=-1, stable=True)
    k = min(k, d2.shape[-1])
    return idx[..., :k], vals[..., :k] < BIG


def gather_rows(x, idx):
    """x [B,N,...] at idx [B,Nd,K] -> [B,Nd,K,...]."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[rows, idx]


def pp_edges(prot_x, prot_mask, cutoff: float, k_max: int):
    """The prot-prot radius list: (idx, mask, x_dir, rbf) [B,P,K,...]."""
    p = prot_x.shape[1]
    eye = torch.eye(p, dtype=torch.bool, device=prot_x.device)
    d2 = sqdist(prot_x, prot_x)
    valid = (prot_mask[:, :, None] & prot_mask[:, None, :] & ~eye
             & (d2 < cutoff * cutoff))
    idx, mask = nearest(d2, valid, k_max)
    x_dir, rbf = pair_geometry(prot_x, gather_rows(prot_x, idx))
    return idx, mask, x_dir, rbf


def edge_bundle(pharm_x, pharm_mask, prot_x, prot_mask, pf_k: int,
                ff_cutoff: float, pp):
    """The four edge types of one denoiser call (reference
    dynamics_gvp.py:187-227), pf by the pf_k nearest prot atoms."""
    f = pharm_x.shape[1]
    eye = torch.eye(f, dtype=torch.bool, device=pharm_x.device)
    ff_mask = ((sqdist(pharm_x, pharm_x) < ff_cutoff * ff_cutoff)
               & pharm_mask[:, :, None] & pharm_mask[:, None, :] & ~eye)
    pairs = pharm_x[:, None].expand(-1, f, -1, -1)
    ff_dir, ff_rbf = pair_geometry(pharm_x, pairs)
    valid = pharm_mask[:, :, None] & prot_mask[:, None, :]
    idx, mask = nearest(sqdist(pharm_x, prot_x), valid, pf_k)
    pf_dir, pf_rbf = pair_geometry(pharm_x, gather_rows(prot_x, idx))
    return {"ff": ("full", ff_mask, None, ff_dir, ff_rbf),
            "pf": ("gathered", mask, idx, pf_dir, pf_rbf),
            "fp": ("reverse", mask, idx, -pf_dir, pf_rbf),
            "pp": ("gathered", pp[1], pp[0], pp[2], pp[3])}


class GVP(nn.Module):
    """Geometric vector perceptron with vector gating (reference
    gvp.py:43-116)."""

    def __init__(self, vin, vout, fin, fout, vec_act="sigmoid"):
        super().__init__()
        h = max(vin, vout)
        self.Wh = nn.Parameter(torch.empty(vin, h))
        self.Wu = nn.Parameter(torch.empty(h, vout))
        self.to_feats_out = nn.Sequential(nn.Linear(fin + h, fout),
                                          nn.SiLU())
        self.scalar_to_vector_gates = nn.Linear(fout, vout)
        self.vec_act = vec_act

    def forward(self, feats, vectors, q=None):
        q = q or (lambda x: x)
        lin = self.to_feats_out[0]
        gate = self.scalar_to_vector_gates
        vh = q(torch.einsum("...vc,vh->...hc", q(vectors), q(self.Wh)))
        vu = q(torch.einsum("...hc,hu->...uc", vh, q(self.Wu)))
        sh = q(norm_no_nan(vh))
        out = q(nn.functional.linear(q(torch.cat([q(feats), sh], -1)),
                                     q(lin.weight), q(lin.bias)))
        out = q(nn.functional.silu(out))
        g = q(nn.functional.linear(out, q(gate.weight), q(gate.bias)))
        if self.vec_act == "sigmoid":
            g = q(torch.sigmoid(g))
        return out, q(g[..., None] * vu)


class Chain(nn.ModuleList):
    def forward(self, feats, vectors, q=None):
        for layer in self:
            feats, vectors = layer(feats, vectors, q)
        return feats, vectors


class LayerNorm(nn.Module):
    """LayerNorm on scalars, v / (sqrt(mean |v|^2 + eps) + eps) on
    vectors (reference gvp.py:152-166)."""

    def __init__(self, s):
        super().__init__()
        self.feat_norm = nn.LayerNorm(s, eps=1e-5)

    def forward(self, h, v):
        vn = norm_no_nan(v, dim=-1, keepdim=True, sqrt=False)
        vn = torch.sqrt(torch.mean(vn, dim=-2, keepdim=True) + 1e-5) + 1e-5
        return self.feat_norm(h), v / vn


def square_chain(n, v, s):
    return Chain([GVP(v, v, s, s) for _ in range(n)])


class Conv(nn.Module):
    """One heterogeneous GVP convolution over the four edge types, mean
    aggregation, residual updates with dropout (reference
    gvp.py:369-520)."""

    def __init__(self, s, v, n_message, n_update, update_ntypes):
        super().__init__()
        self.update_ntypes = update_ntypes

        def message_chain():
            chain = square_chain(n_message, v, s)
            chain[0] = GVP(v + 1, v, s + RBF_DIM, s)
            return chain

        self.edge_message_fns = nn.ModuleDict({
            "_".join(et): message_chain() for et in ETYPES
            if et[2] in update_ntypes})
        self.node_update_fns = nn.ModuleDict({
            nt: square_chain(n_update, v, s) for nt in update_ntypes})
        self.message_layer_norms = nn.ModuleDict({
            nt: LayerNorm(s) for nt in update_ntypes})
        self.update_layer_norms = nn.ModuleDict({
            nt: LayerNorm(s) for nt in update_ntypes})

    def forward(self, feats, masks, bundle, q, drop):
        agg = {}
        for src, name, dst in ETYPES:
            if dst not in self.update_ntypes:
                continue
            h_src, v_src = feats[src]
            layout, mask, idx, x_dir, rbf = bundle[name]
            if layout == "gathered":
                h_g, v_g = gather_rows(h_src, idx), gather_rows(v_src, idx)
            elif layout == "reverse":
                k = mask.shape[2]
                h_g = h_src[:, :, None].expand(-1, -1, k, -1)
                v_g = v_src[:, :, None].expand(-1, -1, k, -1, -1)
            else:
                nd = mask.shape[1]
                h_g = h_src[:, None].expand(-1, nd, -1, -1)
                v_g = v_src[:, None].expand(-1, nd, -1, -1, -1)
            s_msg, v_msg = self.edge_message_fns[f"{src}_{name}_{dst}"](
                torch.cat([h_g, rbf], -1),
                torch.cat([x_dir[..., None, :], v_g], -2), q)
            m = mask.to(torch.float32)
            if layout == "reverse":
                # scatter each (pharm, slot) message to the prot atom it names
                flat = idx.reshape(idx.shape[0], -1)
                n_dst = feats["prot"][0].shape[1]
                s_sum = _scatter(s_msg * m[..., None], flat, n_dst)
                v_sum = _scatter(v_msg * m[..., None, None], flat, n_dst)
                count = _scatter(m[..., None], flat, n_dst)[..., 0]
            else:
                s_sum = (s_msg * m[..., None]).sum(2)
                v_sum = (v_msg * m[..., None, None]).sum(2)
                count = m.sum(2)
            denom = torch.clamp(count, min=1.0)
            s_mean = s_sum / denom[..., None]
            v_mean = v_sum / denom[..., None, None]
            if dst in agg:
                agg[dst] = (agg[dst][0] + s_mean, agg[dst][1] + v_mean)
            else:
                agg[dst] = (s_mean, v_mean)
        out = dict(feats)
        for nt in NTYPES:
            if nt not in self.update_ntypes:
                continue
            h, v = feats[nt]
            s_msg, v_msg = drop(*agg[nt])
            h, v = self.message_layer_norms[nt](h + s_msg, v + v_msg)
            s_res, v_res = self.node_update_fns[nt](h, v)
            s_res, v_res = drop(s_res, v_res)
            h, v = self.update_layer_norms[nt](h + s_res, v + v_res)
            m = masks[nt].to(torch.float32)
            out[nt] = (h * m[..., None], v * m[..., None, None])
        return out


def _scatter(x, flat_idx, n_dst):
    """Sum [B,F,K,...] rows into [B,n_dst,...] at flat_idx [B,F*K]."""
    b = x.shape[0]
    rows = x.reshape(b, flat_idx.shape[1], -1)
    out = rows.new_zeros(b, n_dst, rows.shape[-1])
    out.scatter_add_(1, flat_idx[..., None].expand(-1, -1, rows.shape[-1]),
                     rows)
    return out.reshape((b, n_dst) + x.shape[3:])


class Encoder(nn.Sequential):
    def __init__(self, n_in, s):
        super().__init__(nn.Linear(n_in, s), nn.SiLU(),
                         nn.LayerNorm(s, eps=1e-5))


class NoiseHead(nn.Module):
    def __init__(self, s, nf, v, n_gvps):
        super().__init__()
        self.gvps = Chain([GVP(v, 1 if i == n_gvps - 1 else v, s,
                               64 if i == n_gvps - 1 else s,
                               "identity" if i == n_gvps - 1 else "sigmoid")
                           for i in range(n_gvps)])
        self.to_scalar_output = nn.Linear(64, nf)

    def forward(self, h, v):
        h, v = self.gvps(h, v)
        return self.to_scalar_output(h), v[..., 0, :]


class Holder(nn.Module):
    def __init__(self, convs, head):
        super().__init__()
        self.conv_layers = nn.ModuleList(convs)
        self.noise_predictor = head


class Dynamics(nn.Module):
    """eps_theta(z_t, t | pocket), masked to the valid pharm slots."""

    def __init__(self, cfg: dict):
        super().__init__()
        s, v = cfg["n_hidden_scalars"], cfg["vector_size"]
        nf, rec = cfg["pharm_nf"], cfg["rec_nf"]
        n = cfg["n_convs"]
        self.cfg = cfg
        self.pharm_encoder = Encoder(nf + 1, s)
        self.prot_encoder = Encoder(rec + 1, s)
        self.noise_predictor = Holder(
            [Conv(s, v, cfg["n_message_gvps"], cfg["n_update_gvps"],
                  ("pharm",) if i == n - 1 else NTYPES) for i in range(n)],
            NoiseHead(s, nf, v, cfg["n_noise_gvps"]))

    def forward(self, h_t, x_t, pharm_mask, prot_h, prot_x, prot_mask, t,
                pp, q=None, drop=None):
        b, f = pharm_mask.shape
        p = prot_mask.shape[1]
        v = self.cfg["vector_size"]
        pm = pharm_mask.to(torch.float32)[..., None]
        rm = prot_mask.to(torch.float32)[..., None]
        drop = drop or (lambda a, c: (a, c))
        h = self.pharm_encoder(torch.cat(
            [h_t, t[:, None, None].expand(b, f, 1)], -1)) * pm
        hp = self.prot_encoder(torch.cat(
            [prot_h, t[:, None, None].expand(b, p, 1)], -1)) * rm
        feats = {"pharm": (h, h.new_zeros(b, f, v, 3)),
                 "prot": (hp, hp.new_zeros(b, p, v, 3))}
        masks = {"pharm": pharm_mask, "prot": prot_mask}
        bundle = edge_bundle(x_t, pharm_mask, prot_x, prot_mask,
                             self.cfg["pf_k"], self.cfg["ff_cutoff"], pp)
        for conv in self.noise_predictor.conv_layers:
            feats = conv(feats, masks, bundle, q, drop)
        eps_h, eps_x = self.noise_predictor.noise_predictor(*feats["pharm"])
        return eps_h * pm, eps_x * pm


class Reference(nn.Module):
    """The denoiser under the `dynamics.` prefix of the reference's state
    dict, with the edge-message rounding of `precision`."""

    def __init__(self, cfg: dict, precision: str = "float32"):
        super().__init__()
        self.dynamics = Dynamics(cfg)
        self.q = rounder(precision)

    def forward(self, *args, drop=None):
        return self.dynamics(*args, q=self.q, drop=drop)


def init_values(model: nn.Module, generator: torch.Generator,
                device) -> Dict[str, torch.Tensor]:
    """Weights for `model`'s state dict from `generator`, in one draw on
    `device`: torch's default init, U(-1/sqrt(fan_in), +1/sqrt(fan_in))
    for Linear weights and biases and for the GVP matrices (fan_in their
    first axis), ones and zeros for LayerNorm."""
    plan = []
    for mod_name, mod in model.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        if isinstance(mod, nn.LayerNorm):
            plan += [(prefix + "weight", tuple(mod.weight.shape), None, 1.0),
                     (prefix + "bias", tuple(mod.bias.shape), None, 0.0)]
        elif isinstance(mod, nn.Linear):
            bound = 1.0 / math.sqrt(mod.in_features)
            plan += [(prefix + "weight", tuple(mod.weight.shape), bound, 0.0),
                     (prefix + "bias", tuple(mod.bias.shape), bound, 0.0)]
        elif isinstance(mod, GVP):
            for w in ("Wh", "Wu"):
                shape = tuple(getattr(mod, w).shape)
                plan.append((prefix + w, shape, 1.0 / math.sqrt(shape[0]),
                             0.0))
    total = sum(math.prod(s) for _, s, b, _ in plan if b is not None)
    draw = torch.rand(total, generator=generator, device=device)
    out, off = {}, 0
    for name, shape, bound, const in plan:
        n = math.prod(shape)
        if bound is None:
            out[name] = torch.full(shape, const, device=device)
        else:
            out[name] = ((draw[off:off + n] * 2.0 - 1.0) * bound).view(shape)
            off += n
    names = set(model.state_dict())
    if set(out) != names:
        raise ValueError(f"init plan and state dict differ: "
                         f"{sorted(set(out) ^ names)}")
    return out


def build(cfg: dict, weights: Dict[str, torch.Tensor], device,
          precision: str = "float32") -> Reference:
    """A reference model on `device` holding copies of `weights`."""
    with torch.device("meta"):
        model = Reference(cfg, precision)
    model = model.to_empty(device=device)
    model.load_state_dict({k: v.detach().clone() for k, v in weights.items()})
    return model


def skeleton(cfg: dict) -> Reference:
    """The reference model on the meta device: its state dict's names and
    shapes, with no storage."""
    with torch.device("meta"):
        return Reference(cfg)


def edge_state(cfg: dict, prot_x, prot_mask):
    """The pp edges of `prot_x` (translation invariant)."""
    return pp_edges(prot_x, prot_mask, cfg["pp_cutoff"], cfg["pp_k_max"])

