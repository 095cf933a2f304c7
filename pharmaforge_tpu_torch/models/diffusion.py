"""Joint Gaussian diffusion over pharmacophore coordinates and types:
the training loss and the reverse sampling chain.

Port of `pharmaforge_tpu/models/diffusion.py` (`DiffusionConfig`, the
schedule helpers, `loss` :232 and `sample_given_receptor` :350). The
loss draws its timesteps, noise and dropout masks from an explicit
`torch.Generator` (or takes them injected), switches the model to train
mode (dropout on) and returns tensors, so autograd differentiates it;
sampling switches back to eval mode. The JAX package runs
the chain as one `lax.scan`; here it is a Python loop over T whose every
step calls the denoiser once. The chain keeps the JAX package's contract:
injected-noise keys `x_T`, `h_T`, `pos`, `feat`; COM removal at every
step; noise added at s=0 too; both endpoint parameterisations;
[T+1, B, F, .] trajectory frames with the initial frame first; the same
finalisation back into the pocket frame.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from pharmaforge_tpu_torch import resolve_device
from pharmaforge_tpu_torch.data.batch import PharmComplexBatch
from pharmaforge_tpu_torch.models.dynamics import PharmRecDynamics
from pharmaforge_tpu_torch.models.edges import (
    GroupedEdgeData,
    build_pp_edge,
    build_pp_out_edges,
)
from pharmaforge_tpu_torch.models.gvp import reset_parameters_
from pharmaforge_tpu_torch.models.schedules import make_gamma_table
from pharmaforge_tpu_torch.ops.geometry import masked_com
from pharmaforge_tpu_torch.ops.pp_message import COMPUTE_DTYPES


def sigma_of_gamma(gamma: torch.Tensor) -> torch.Tensor:
    """sigma = sqrt(sigmoid(gamma))."""
    return torch.sqrt(torch.sigmoid(gamma))


def alpha_of_gamma(gamma: torch.Tensor) -> torch.Tensor:
    """alpha = sqrt(sigmoid(-gamma))."""
    return torch.sqrt(torch.sigmoid(-gamma))


def sigma_and_alpha_t_given_s(gamma_t: torch.Tensor, gamma_s: torch.Tensor):
    """Transition parameters of p(z_t | z_s): (sigma2_t|s, sigma_t|s,
    alpha_t|s, alpha_s)."""
    sigma2_t_given_s = -torch.expm1(F.softplus(gamma_s) - F.softplus(gamma_t))
    log_alpha2_t = F.logsigmoid(-gamma_t)
    log_alpha2_s = F.logsigmoid(-gamma_s)
    alpha_t_given_s = torch.exp(0.5 * (log_alpha2_t - log_alpha2_s))
    alpha_s = torch.exp(0.5 * log_alpha2_s)
    sigma_t_given_s = torch.sqrt(sigma2_t_given_s)
    return sigma2_t_given_s, sigma_t_given_s, alpha_t_given_s, alpha_s


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """Hyperparameters of the diffusion process + denoiser; the fields and
    defaults of the JAX package's `DiffusionConfig`, so one YAML config
    builds both.

    `compact_prot_tail` and `dedup_prot_encoder` switch the JAX package's
    sampling reorderings of the same math (the compact prot tail, the prot
    encoder once per pocket group); `precompute_step_tables` is accepted
    and not ported (the full per-step computation runs). `fused_pp` other
    than False runs the middle convs' prot-prot chain through the fused
    kernel (`ops/pp_message.py`), and with it the pocket-copy correction
    (`sample_given_receptor`'s `pp_k_out`); `compute_dtype` is "float32"
    or "bfloat16" (the edge-message chains)."""

    pharm_nf: int = 6
    rec_nf: int = 11
    n_timesteps: int = 1000
    precision: float = 1e-4
    noise_schedule: str = "polynomial_2"
    pharm_feat_norm_constant: float = 1.0
    endpoint_param_feat: bool = False
    endpoint_param_coord: bool = False
    weighted_loss: bool = False
    remove_com: bool = True
    # denoiser
    vector_size: int = 16
    n_convs: int = 4
    n_hidden_scalars: int = 128
    message_norm: Any = 1
    n_message_gvps: int = 3
    n_update_gvps: int = 2
    n_noise_gvps: int = 3
    dropout: float = 0.0
    ff_k: int = 0
    pf_k: int = 0
    prune_dead_prot_tail: bool = True
    compact_prot_tail: bool = True
    dedup_prot_encoder: bool = True
    graph_cutoffs: Tuple[Tuple[str, float], ...] = (
        ("pp", 3.5), ("pf", 8.0), ("fp", 8.0), ("ff", 9.0))
    # static width of the prot-prot neighbor list
    pp_k_max: int = 16
    compute_dtype: str = "float32"
    fused_pp: Any = "auto"
    sample_scan_unroll: int = 1
    precompute_step_tables: bool = False
    precompute_table_budget: int = 4 << 30

    @classmethod
    def from_config(cls, config: dict) -> "DiffusionConfig":
        """Build from a merged YAML config dict."""
        diff = dict(config.get("diffusion", {}))
        dyn = dict(config.get("dynamics", {}))
        graph = dict(config.get("graph", {}))
        dataset = config.get("dataset", {})
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs: Dict[str, Any] = {}
        kwargs["pharm_nf"] = len(dataset.get("ph_type_map", range(6)))
        kwargs["rec_nf"] = len(dataset.get("prot_elements", range(11)))
        for src in (diff, dyn):
            for k, v in src.items():
                if k in known:
                    kwargs[k] = v
        cutoffs = graph.get("graph_cutoffs")
        if cutoffs:
            kwargs["graph_cutoffs"] = tuple(sorted(
                (k, float(v)) for k, v in cutoffs.items()))
        if "pp_k_max" in graph:
            kwargs["pp_k_max"] = graph["pp_k_max"]
        mn = kwargs.get("message_norm")
        if isinstance(mn, dict):
            kwargs["message_norm"] = tuple(sorted(mn.items()))
        return cls(**kwargs)

    def check_supported(self) -> None:
        """Raise NotImplementedError for options the port lacks."""
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise NotImplementedError(
                f"compute_dtype={self.compute_dtype!r}: the port has "
                f"{sorted(COMPUTE_DTYPES)}")

    def make_dynamics(self) -> PharmRecDynamics:
        return PharmRecDynamics(
            n_pharm_scalars=self.pharm_nf,
            n_prot_scalars=self.rec_nf,
            vector_size=self.vector_size,
            n_convs=self.n_convs,
            n_hidden_scalars=self.n_hidden_scalars,
            message_norm=self.message_norm,
            graph_cutoffs=tuple(self.graph_cutoffs),
            n_message_gvps=self.n_message_gvps,
            n_update_gvps=self.n_update_gvps,
            n_noise_gvps=self.n_noise_gvps,
            dropout=self.dropout,
            ff_k=self.ff_k,
            pf_k=self.pf_k,
            prune_dead_prot_tail=self.prune_dead_prot_tail,
            compact_prot_tail=self.compact_prot_tail,
            dedup_prot_encoder=self.dedup_prot_encoder,
            compute_dtype=self.compute_dtype,
            fused_pp=self.fused_pp,
        )


def _step_coefficients(gamma_table: np.ndarray, cfg: DiffusionConfig
                       ) -> np.ndarray:
    """Per-step scalars of the reverse chain in float32, rows in loop
    order (row i is s = T-1-i): (alpha_t|s, var_terms, sigma, c_x, c_pred)
    where the eps parameterisation uses mu = z/alpha_t|s - var_terms*pred
    and the endpoint one mu = c_x*z + c_pred*pred."""
    gamma = torch.from_numpy(np.asarray(gamma_table, np.float32))
    n_t = cfg.n_timesteps
    s = torch.arange(n_t - 1, -1, -1)
    gamma_s, gamma_t = gamma[s], gamma[s + 1]
    sigma2_tgs, sigma_tgs, alpha_tgs, alpha_s = sigma_and_alpha_t_given_s(
        gamma_t, gamma_s)
    sigma_s = sigma_of_gamma(gamma_s)
    sigma_t = sigma_of_gamma(gamma_t)
    var_terms = sigma2_tgs / alpha_tgs / sigma_t
    sigma = sigma_tgs * sigma_s / sigma_t
    c_x = alpha_tgs * (sigma_s ** 2) / (sigma_t ** 2)
    c_pred = alpha_s * sigma2_tgs / (sigma_t ** 2)
    return torch.stack([alpha_tgs, var_terms, sigma, c_x, c_pred],
                       dim=1).numpy()


class PharmacophoreDiffusion(nn.Module):
    """The diffusion model: `dynamics` (the denoiser) plus the noise
    schedule. Runs on `device` (CUDA by default; raises without CUDA unless
    a device is named). `generator` draws the initial weights with torch's
    default init; reference or JAX weights load with
    `interop.load_reference_state_dict` / `interop.params_from_jax`."""

    def __init__(self, config: DiffusionConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        config.check_supported()
        self.config = config
        self.dynamics = config.make_dynamics()
        self.gamma_table = make_gamma_table(
            config.noise_schedule, config.n_timesteps, config.precision)
        self.cutoffs = dict(config.graph_cutoffs)
        if generator is not None:
            reset_parameters_(self, generator)
        self.eval()
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        if not torch.is_tensor(a):
            a = torch.from_numpy(np.array(a))
        return a.to(device=self.device, dtype=dtype)

    def loss(self, batch: PharmComplexBatch,
             generator: Optional[torch.Generator] = None, train: bool = True,
             phase: str = "train", noise: Optional[Dict[str, Any]] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Forward diffusion + denoiser + losses (reference
        pharmacodiff.py:162-243, JAX diffusion.py:232-346), with masked
        reductions. Returns (total loss, {name: scalar tensor}) under the
        reference's metric names, prefixed with `phase`.

        `train` sets train mode (dropout on) or eval mode. `noise` injects
        the draws: 't_int' [B] int, 'eps_x' [B,F,3], 'eps_h' [B,F,nf];
        draws not injected, and the dropout masks, come from `generator`
        (on the model's device), which is then required."""
        cfg = self.config
        self.train(train)
        dev = self.device
        noise = dict(noise or {})
        pharm_mask = self._tensor(batch.pharm_mask, torch.bool)
        prot_mask = self._tensor(batch.prot_mask, torch.bool)
        fmask = pharm_mask.to(torch.float32)
        b = pharm_mask.shape[0]

        def draw(name, fn):
            if name in noise:
                return self._tensor(noise[name])
            if generator is None:
                raise ValueError(f"loss: no generator to draw {name!r}")
            return fn()

        # normalize features (pharmacodiff.py:80-82,168)
        h0 = self._tensor(batch.pharm_h, torch.float32) \
            / cfg.pharm_feat_norm_constant
        x0 = self._tensor(batch.pharm_x, torch.float32)
        prot_x = self._tensor(batch.prot_x, torch.float32)
        prot_h = self._tensor(batch.prot_h, torch.float32)
        # pp neighbours + geometry: translation invariant, from the raw
        # pocket coordinates
        _, pp_edge = build_pp_edge(prot_x, prot_mask, self.cutoffs["pp"],
                                   cfg.pp_k_max)

        # remove the pharmacophore COM from the complex (pharmacodiff.py:179)
        com = masked_com(x0, pharm_mask)
        x0 = (x0 - com[:, None]) * fmask[..., None]
        prot_x = prot_x - com[:, None]
        x0_clean, h0_clean = x0, h0

        t_int = draw("t_int", lambda: torch.randint(
            0, cfg.n_timesteps, (b,), generator=generator,
            device=dev)).long()
        t = t_int.to(torch.float32) / cfg.n_timesteps
        eps_x = draw("eps_x", lambda: torch.randn(
            x0.shape, generator=generator, device=dev)).float() \
            * fmask[..., None]
        eps_h = draw("eps_h", lambda: torch.randn(
            h0.shape, generator=generator, device=dev)).float() \
            * fmask[..., None]

        gamma_t = self._tensor(np.asarray(self.gamma_table, np.float32))[
            t_int]
        alpha_t = alpha_of_gamma(gamma_t)[:, None, None]
        sigma_t = sigma_of_gamma(gamma_t)[:, None, None]
        x_t = alpha_t * x0 + sigma_t * eps_x
        h_t = alpha_t * h0 + sigma_t * eps_h

        sampled_com = torch.zeros_like(com)
        if cfg.remove_com:
            sampled_com = masked_com(x_t, pharm_mask)
            x_t = (x_t - sampled_com[:, None]) * fmask[..., None]
            prot_x = prot_x - sampled_com[:, None]

        h_dyn, x_dyn = self.dynamics(h_t, x_t, pharm_mask, prot_h, prot_x,
                                     prot_mask, t, pp_edge=pp_edge,
                                     generator=generator)

        # losses (pharmacodiff.py:204-232)
        if cfg.endpoint_param_feat:
            h0_pred = h_dyn
            labels = torch.argmax(h0_clean, dim=-1)
            logz = F.log_softmax(h_dyn, dim=-1)
            h_loss = -torch.gather(logz, -1, labels[..., None])[..., 0]
        else:
            h_loss = torch.sum(torch.square(eps_h - h_dyn), dim=-1)
            h0_pred = (h_t - sigma_t * h_dyn) / alpha_t
        if cfg.endpoint_param_coord:
            if cfg.remove_com:
                x_dyn = x_dyn + sampled_com[:, None]
            x0_pred = x_dyn
            x_loss = torch.sum(torch.square(x0_pred - x0_clean), dim=-1)
        else:
            x_loss = torch.sum(torch.square(eps_x - x_dyn), dim=-1)
            x0_pred = (x_t - sigma_t * x_dyn) / alpha_t

        weight_metric = (1.0 - t[:, None]) * fmask
        weight_loss = weight_metric if cfg.weighted_loss else fmask
        h_loss = torch.sum(h_loss * weight_loss)
        x_loss = torch.sum(x_loss * weight_loss)
        n_valid = torch.clamp(torch.sum(fmask), min=1.0)
        losses = {
            f"{phase} pos loss": x_loss / (n_valid * 3.0),
            f"{phase} feat loss": h_loss / (n_valid * float(cfg.pharm_nf)),
        }
        total = losses[f"{phase} pos loss"] + losses[f"{phase} feat loss"]
        losses[f"{phase} total loss"] = total

        # metrics (pharmacodiff.py:234-239), gradient-free
        pos_err = torch.sum(torch.square(x0_pred.detach() - x0_clean), dim=-1)
        acc = (torch.argmax(h0_pred.detach(), dim=-1)
               == torch.argmax(h0_clean, dim=-1)).to(torch.float32)
        metrics = {
            f"{phase} position error": torch.sum(pos_err * fmask) / n_valid,
            f"{phase} weighted position error":
                torch.sum(pos_err * weight_metric) / n_valid,
            f"{phase} accuracy": torch.sum(acc * fmask) / n_valid,
            f"{phase} weighted accuracy":
                torch.sum(acc * weight_metric) / n_valid,
        }
        metrics[f"{phase} total error"] = (
            metrics[f"{phase} position error"] + 1.0
            - metrics[f"{phase} accuracy"])
        metrics[f"{phase} weighted total error"] = (
            metrics[f"{phase} weighted position error"] + 1.0
            - metrics[f"{phase} weighted accuracy"])
        return total, {**losses, **metrics}

    @torch.no_grad()
    def sample_given_receptor(self, batch: PharmComplexBatch,
                              generator: Optional[torch.Generator] = None,
                              init_pharm_com=None,
                              visualize_trajectory: bool = False,
                              noise: Optional[Dict[str, Any]] = None,
                              pocket_group_size: int = 1,
                              pp_k_out: int = 0) -> Dict[str, torch.Tensor]:
        """The full reverse DDPM chain (reference pharmacodiff.py:433-514).

        Returns tensors on the model's device: final `pharm_x`/`pharm_h`
        in the original pocket frame, `pharm_mask`, and with
        `visualize_trajectory` the frames `traj_x` [T+1,B,F,3] and
        `traj_h` [T+1,B,F,nf], initial frame first.

        `noise` injects every random draw: 'x_T' [B,F,3] and 'h_T'
        [B,F,nf] initial latents, 'pos'/'feat' [T,B,F,.] per-step noise in
        loop order (i=0 is s=T-1). Draws not injected come from
        `generator` (all at once, on the generator's device).

        `pocket_group_size` = C > 1 declares that every C consecutive rows
        carry one pocket; the first conv's prot-prot messages are then
        computed once per group (numerically the same result).

        `pp_k_out` > 0 with C > 1 turns on the pocket-copy correction of
        the second conv (the JAX package's argument; `PocketSampler`
        probes it with `probe_pp_k_out`): the pp edge's out-edge tables are
        built once per chain with `pp_k_out` slots per atom, and a value
        below the pp graph's maximum out-degree raises ValueError."""
        cfg = self.config
        self.eval()
        dev = self.device
        pharm_mask = self._tensor(batch.pharm_mask, torch.bool)
        prot_mask = self._tensor(batch.prot_mask, torch.bool)
        fmask = pharm_mask.to(torch.float32)[..., None]
        b, f = pharm_mask.shape
        if b % pocket_group_size:
            raise ValueError(f"batch {b} not divisible by "
                             f"pocket_group_size {pocket_group_size}")
        prot_x0 = self._tensor(batch.prot_x, torch.float32)
        prot_h = self._tensor(batch.prot_h, torch.float32)

        init_prot_com = masked_com(prot_x0, prot_mask)
        init_pharm_com = init_prot_com if init_pharm_com is None else \
            self._tensor(init_pharm_com, torch.float32).expand(b, 3)

        # pp neighbors + geometry are translation invariant: built once
        # per chain, on the pocket-group representatives when grouped
        pp_out = None
        if pocket_group_size > 1:
            c = pocket_group_size
            _, ed_g = build_pp_edge(prot_x0[::c], prot_mask[::c],
                                    self.cutoffs["pp"], cfg.pp_k_max)
            pp_edge = GroupedEdgeData(ed_g.mask, ed_g.idx, ed_g.x_dir,
                                      ed_g.d_rbf, copies=c)
            # the pp edge's transpose, static over the chain
            if pp_k_out:
                pp_out = build_pp_out_edges(ed_g, int(pp_k_out))
        else:
            _, pp_edge = build_pp_edge(prot_x0, prot_mask,
                                       self.cutoffs["pp"], cfg.pp_k_max)

        prot_x = prot_x0 - init_pharm_com[:, None]
        n_t = cfg.n_timesteps
        noise = dict(noise or {})
        gen_dev = generator.device if generator is not None else "cpu"

        def draw(shape):
            return torch.randn(shape, generator=generator,
                               device=gen_dev).to(dev)

        if "x_T" in noise:
            x_t = self._tensor(noise["x_T"], torch.float32) * fmask
            h_t = self._tensor(noise["h_T"], torch.float32) * fmask
        else:
            x_t = draw((b, f, 3)) * fmask
            h_t = draw((b, f, cfg.pharm_nf)) * fmask
        if "pos" in noise:
            pos_noise = self._tensor(noise["pos"], torch.float32)
            feat_noise = self._tensor(noise["feat"], torch.float32)
        else:
            pos_noise = draw((n_t, b, f, 3))
            feat_noise = draw((n_t, b, f, cfg.pharm_nf))
        x_init, h_init, prot_x_init = x_t, h_t, prot_x

        def frame(x_t, h_t, prot_x):
            """Trajectory frame in the initial pocket frame."""
            delta = init_prot_com - masked_com(prot_x, prot_mask)
            return ((x_t + delta[:, None]) * fmask,
                    h_t * cfg.pharm_feat_norm_constant)

        coef = _step_coefficients(self.gamma_table, cfg)
        frames = [frame(x_init, h_init, prot_x_init)] \
            if visualize_trajectory else None
        for i in range(n_t):
            s = n_t - 1 - i
            alpha_tgs, var_terms, sigma, c_x, c_pred = (float(v)
                                                        for v in coef[i])
            t_arr = torch.full((b,), float(np.float32(s + 1)
                                           / np.float32(n_t)),
                               dtype=torch.float32, device=dev)
            pred_h, pred_x = self.dynamics(
                h_t, x_t, pharm_mask, prot_h, prot_x, prot_mask, t_arr,
                pp_edge=pp_edge, pocket_group_size=pocket_group_size,
                pp_out=pp_out)
            if cfg.endpoint_param_coord:
                mu_pos = c_x * x_t + c_pred * pred_x
            else:
                mu_pos = x_t / alpha_tgs - var_terms * pred_x
            if cfg.endpoint_param_feat:
                mu_feat = c_x * h_t + c_pred * pred_h
            else:
                mu_feat = h_t / alpha_tgs - var_terms * pred_h
            # noise is added at EVERY step including s=0
            x_t = (mu_pos + sigma * pos_noise[i]) * fmask
            h_t = (mu_feat + sigma * feat_noise[i]) * fmask
            com = masked_com(x_t, pharm_mask)
            x_t = (x_t - com[:, None]) * fmask
            prot_x = prot_x - com[:, None]
            if visualize_trajectory:
                frames.append(frame(x_t, h_t, prot_x))

        # finalize (pharmacodiff.py:479-488)
        prot_com = masked_com(prot_x, prot_mask)
        x_0 = (x_t - prot_com[:, None]) * fmask
        x_0 = (x_0 + init_prot_com[:, None]) * fmask
        h_0 = h_t * cfg.pharm_feat_norm_constant
        out = {"pharm_x": x_0, "pharm_h": h_0, "pharm_mask": pharm_mask}
        if visualize_trajectory:
            out["traj_x"] = torch.stack([fr[0] for fr in frames])
            out["traj_h"] = torch.stack([fr[1] for fr in frames])
        return out
