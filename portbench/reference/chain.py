"""Plain reverse chain and training loss of the PharmacoForge diffusion.

The reference's `pharmacodiff.py` (the polynomial_2 noise schedule
:618-668, the loss :162-243, `sample_given_receptor` :433-514) in plain
torch, on `model.Reference`. It imports nothing of the program. The
random draws are the inputs the benchmark hands to both sides: the
chain's noise tensors, or a generator seeded alike from which the loss
draws its timesteps, noise and dropout masks in the order the reference
model uses them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch.nn import functional as F

from portbench.reference.model import edge_state


def gamma_table(n_t: int, precision: float, power: float = 2.0
                ) -> np.ndarray:
    """gamma[t] for t in 0..T of the polynomial schedule (float64 numpy,
    returned as float32)."""
    steps = n_t + 1
    x = np.linspace(0, steps, steps)
    alphas2 = (1 - np.power(x / steps, power)) ** 2
    alphas2 = np.concatenate([np.ones(1), alphas2])
    step = np.clip(alphas2[1:] / alphas2[:-1], 0.001, 1.0)
    alphas2 = np.cumprod(step)
    alphas2 = (1 - 2 * precision) * alphas2 + precision
    return (-(np.log(alphas2) - np.log(1 - alphas2))).astype(np.float32)


def step_coefficients(gamma: np.ndarray, n_t: int) -> torch.Tensor:
    """[T, 5] float32 rows in loop order (row i is s = T-1-i):
    (alpha_t|s, var_terms, sigma, c_x, c_pred)."""
    g = torch.from_numpy(gamma)
    s = torch.arange(n_t - 1, -1, -1)
    g_s, g_t = g[s], g[s + 1]
    sigma2_tgs = -torch.expm1(F.softplus(g_s) - F.softplus(g_t))
    log_a2_t, log_a2_s = F.logsigmoid(-g_t), F.logsigmoid(-g_s)
    alpha_tgs = torch.exp(0.5 * (log_a2_t - log_a2_s))
    alpha_s = torch.exp(0.5 * log_a2_s)
    sigma_tgs = torch.sqrt(sigma2_tgs)
    sigma_s = torch.sqrt(torch.sigmoid(g_s))
    sigma_t = torch.sqrt(torch.sigmoid(g_t))
    return torch.stack([alpha_tgs, sigma2_tgs / alpha_tgs / sigma_t,
                        sigma_tgs * sigma_s / sigma_t,
                        alpha_tgs * sigma_s ** 2 / sigma_t ** 2,
                        alpha_s * sigma2_tgs / sigma_t ** 2], dim=1)


def masked_com(x, mask):
    m = mask.to(x.dtype)[..., None]
    return (x * m).sum(-2) / torch.clamp(m.sum(-2), min=1.0)


def chain_noise(generator: torch.Generator, b: int, f: int, nf: int,
                n_t: int) -> Dict[str, torch.Tensor]:
    """A chain's draws from `generator`, in the order the chain takes
    them: the initial latents, then the per-step noise."""
    dev = generator.device
    shapes = {"x_T": (b, f, 3), "h_T": (b, f, nf), "pos": (n_t, b, f, 3),
              "feat": (n_t, b, f, nf)}
    return {k: torch.randn(s, generator=generator, device=dev)
            for k, s in shapes.items()}


@torch.no_grad()
def sample(model, cfg: dict, pharm_mask, prot_x0, prot_h, prot_mask,
           init_com, noise: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The reverse chain (pharmacodiff.py:433-514) over every row on its
    own: final pharm_x in the pocket frame and pharm_h. `noise` holds
    x_T / h_T [B,F,.] and pos / feat [T,B,F,.] in loop order; `init_com`
    [B,3] is the frame the chain starts in."""
    model.eval()
    n_t = cfg["n_timesteps"]
    coef = step_coefficients(gamma_table(n_t, cfg["precision"]), n_t
                             ).to(prot_x0.device)
    fm = pharm_mask.to(torch.float32)[..., None]
    init_prot_com = masked_com(prot_x0, prot_mask)
    prot_x = prot_x0 - init_com[:, None]
    pp = edge_state(cfg, prot_x0, prot_mask)
    x, h = noise["x_T"] * fm, noise["h_T"] * fm
    b = x.shape[0]
    for i in range(n_t):
        a_tgs, var_terms, sigma, c_x, c_pred = coef[i]
        t = torch.full((b,), np.float32(n_t - i) / np.float32(n_t),
                       device=x.device)
        pred_h, pred_x = model(h, x, pharm_mask, prot_h, prot_x, prot_mask,
                               t, pp)
        if cfg["endpoint_param_coord"]:
            mu_x = c_x * x + c_pred * pred_x
        else:
            mu_x = x / a_tgs - var_terms * pred_x
        if cfg["endpoint_param_feat"]:
            mu_h = c_x * h + c_pred * pred_h
        else:
            mu_h = h / a_tgs - var_terms * pred_h
        x = (mu_x + sigma * noise["pos"][i]) * fm
        h = (mu_h + sigma * noise["feat"][i]) * fm
        com = masked_com(x, pharm_mask)
        x = (x - com[:, None]) * fm
        prot_x = prot_x - com[:, None]
    prot_com = masked_com(prot_x, prot_mask)
    x0 = ((x - prot_com[:, None]) * fm + init_prot_com[:, None]) * fm
    return {"pharm_x": x0, "pharm_h": h * cfg["pharm_feat_norm_constant"]}


class Dropout:
    """The reference's GVP dropout (gvp.py:118-149) from `generator`: the
    scalar mask, then one keep flag per 3-vector."""

    def __init__(self, rate: float, generator: torch.Generator):
        self.rate, self.generator = rate, generator

    def __call__(self, feats, vectors):
        keep = 1.0 - self.rate
        g = self.generator
        fm = torch.rand(feats.shape, generator=g, device=feats.device) < keep
        vm = torch.rand(vectors.shape[:-1], generator=g,
                        device=vectors.device) < keep
        return (torch.where(fm, feats / keep, 0.0),
                vectors * vm[..., None] / keep)


def loss(model, cfg: dict, batch: Dict[str, torch.Tensor],
         generator: torch.Generator) -> torch.Tensor:
    """The training loss of one batch (pharmacodiff.py:162-243), train
    mode: timesteps, noise and dropout masks drawn from `generator` in the
    reference's order. Returns the total loss."""
    n_t, nf = cfg["n_timesteps"], cfg["pharm_nf"]
    dev = generator.device
    pm = batch["pharm_mask"]
    fm = pm.to(torch.float32)
    b = pm.shape[0]
    h0 = batch["pharm_h"] / cfg["pharm_feat_norm_constant"]
    x0 = batch["pharm_x"]
    prot_x, prot_h, rm = batch["prot_x"], batch["prot_h"], batch["prot_mask"]
    pp = edge_state(cfg, prot_x, rm)
    com = masked_com(x0, pm)
    x0 = (x0 - com[:, None]) * fm[..., None]
    prot_x = prot_x - com[:, None]
    t_int = torch.randint(0, n_t, (b,), generator=generator, device=dev)
    eps_x = torch.randn((b,) + x0.shape[1:], generator=generator,
                        device=dev) * fm[..., None]
    eps_h = torch.randn((b,) + h0.shape[1:], generator=generator,
                        device=dev) * fm[..., None]
    gamma = torch.from_numpy(gamma_table(n_t, cfg["precision"])).to(dev)
    g = gamma[t_int]
    alpha = torch.sqrt(torch.sigmoid(-g))[:, None, None]
    sigma = torch.sqrt(torch.sigmoid(g))[:, None, None]
    x_t = alpha * x0 + sigma * eps_x
    h_t = alpha * h0 + sigma * eps_h
    sampled_com = masked_com(x_t, pm)
    x_t = (x_t - sampled_com[:, None]) * fm[..., None]
    prot_x = prot_x - sampled_com[:, None]
    t = t_int.to(torch.float32) / n_t
    model.train()
    h_dyn, x_dyn = model(h_t, x_t, pm, prot_h, prot_x, rm, t, pp,
                         drop=Dropout(cfg["dropout"], generator))
    if cfg["endpoint_param_feat"]:
        labels = torch.argmax(h0, dim=-1)
        h_loss = -torch.gather(F.log_softmax(h_dyn, -1), -1,
                               labels[..., None])[..., 0]
    else:
        h_loss = torch.sum(torch.square(eps_h - h_dyn), -1)
    if cfg["endpoint_param_coord"]:
        x_loss = torch.sum(torch.square(x_dyn + sampled_com[:, None] - x0),
                           -1)
    else:
        x_loss = torch.sum(torch.square(eps_x - x_dyn), -1)
    n_valid = torch.clamp(fm.sum(), min=1.0)
    return ((x_loss * fm).sum() / (n_valid * 3.0)
            + (h_loss * fm).sum() / (n_valid * float(nf)))


class Adam:
    """torch.optim.Adam's update with L2 weight decay added to the
    gradient (the reference's optimiser, pharmacodiff.py:254-263)."""

    def __init__(self, params, lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.wd, self.b1, self.b2, self.eps = (
            lr, weight_decay, betas[0], betas[1], eps)
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads) -> None:
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            g = g + self.wd * p
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = v.sqrt() / np.sqrt(c2) + self.eps
            p.sub_(self.lr / c1 * m / denom)

