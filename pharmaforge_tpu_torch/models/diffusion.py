"""Joint Gaussian diffusion over pharmacophore coordinates and types:
the training loss and the reverse sampling chain.

Port of `pharmaforge_tpu/models/diffusion.py` (`DiffusionConfig`, the
schedule helpers, `loss` :232 and `sample_given_receptor` :350). The
loss draws its timesteps, noise and dropout masks from an explicit
`torch.Generator` (or takes them injected), switches the model to train
mode (dropout on) and returns tensors, so autograd differentiates it;
sampling switches back to eval mode. The JAX package runs
the chain as one `lax.scan`; here the chain is split into its set-up
(`chain_setup`), a step that reads and writes device tensors only
(`chain_step`, the scan body) and its result (`chain_result`), and on the
card the steps run as replays of CUDA graphs (`ChainGraphs`), with no
host round trip between steps. The chain keeps the JAX package's contract:
injected-noise keys `x_T`, `h_T`, `pos`, `feat`; COM removal at every
step; noise added at s=0 too; both endpoint parameterisations;
[T+1, B, F, .] trajectory frames with the initial frame first; the same
finalisation back into the pocket frame.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from pharmaforge_tpu_torch import resolve_device
from pharmaforge_tpu_torch.data.batch import PharmComplexBatch
from pharmaforge_tpu_torch.models.dynamics import (
    PharmRecDynamics,
    precompute_sampling_tables,
)
from pharmaforge_tpu_torch.models.edges import (
    GroupedEdgeData,
    build_pp_edge,
    build_pp_out_edges,
    radius_slot_count,
)
from pharmaforge_tpu_torch.models.gvp import batch_rows, reset_parameters_
from pharmaforge_tpu_torch.models.schedules import make_gamma_table
from pharmaforge_tpu_torch.ops.geometry import masked_com
from pharmaforge_tpu_torch.ops.pp_message import COMPUTE_DTYPES
from pharmaforge_tpu_torch.parallel.mesh import all_reduce_sum
from pharmaforge_tpu_torch.utils import trace


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
    encoder once per pocket group); `precompute_step_tables` builds the
    step tables of a chain where they fit `precompute_table_budget`
    bytes (`sample_given_receptor`). `fused_pp` other
    than False runs the middle convs' prot-prot chain through the fused
    kernel (`ops/pp_message.py`), and with it the pocket-copy correction
    (`sample_given_receptor`'s `pp_k_out`); `compute_dtype` is "float32"
    or "bfloat16" (the edge-message chains). `sample_scan_unroll` is U,
    the denoiser steps of one CUDA graph of the reverse chain
    (`ChainGraphs`; the JAX scan's unroll): the chain replays that graph
    T // U times, then a graph of the T mod U steps left; on the CPU the
    steps run eagerly, U at a time."""

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


def step_table_plan(cfg: DiffusionConfig, groups: int, prot_slots: int,
                    pp_k: int) -> Tuple[int, int]:
    """(bytes of a chain's step tables, steps built per chunk) for `groups`
    pocket groups of `prot_slots` atoms and pp lists of `pp_k`.

    The bytes are the JAX package's budget count (diffusion.py:465-468):
    per step and atom, the encoder output, the pp aggregate and counts in
    fp32 and the pf table in the compute dtype. Each chunk of steps also
    holds the first conv's pp chain on every edge of its rows, counted
    here as eight fp32 scalar rows and the vector rows of each edge; the
    chunk takes as many steps as that fits the same budget, at least
    one."""
    s, v = cfg.n_hidden_scalars, cfg.vector_size
    elt = 2 if cfg.compute_dtype == "bfloat16" else 4
    table = cfg.n_timesteps * groups * prot_slots * (
        4 * (2 * s + 3 * v + 1) + elt * s)
    work = groups * prot_slots * max(pp_k, 1) * 4 * (8 * s + 12 * (v + 1))
    return table, max(1, min(cfg.n_timesteps,
                             cfg.precompute_table_budget // work))


def draw_chain_noise(generator: Optional[torch.Generator], b: int, f: int,
                     pharm_nf: int, n_t: int, initial: bool = True,
                     steps: bool = True) -> Dict[str, torch.Tensor]:
    """The draws of a reverse chain from `generator` (torch's default
    generator on the CPU when None), on the generator's device, in the
    chain's order: with `initial`, 'x_T' [B,F,3] and 'h_T' [B,F,nf]; with
    `steps`, 'pos' [T,B,F,3] and 'feat' [T,B,F,nf]."""
    dev = generator.device if generator is not None else "cpu"
    shapes = {}
    if initial:
        shapes.update(x_T=(b, f, 3), h_T=(b, f, pharm_nf))
    if steps:
        shapes.update(pos=(n_t, b, f, 3), feat=(n_t, b, f, pharm_nf))
    return {k: torch.randn(shape, generator=generator, device=dev)
            for k, shape in shapes.items()}


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
             phase: str = "train", noise: Optional[Dict[str, Any]] = None,
             rows: Optional[Tuple[int, int]] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Forward diffusion + denoiser + losses (reference
        pharmacodiff.py:162-243, JAX diffusion.py:232-346), with masked
        reductions. Returns (total loss, {name: scalar tensor}) under the
        reference's metric names, prefixed with `phase`.

        `train` sets train mode (dropout on) or eval mode. `noise` injects
        the draws: 't_int' [B] int, 'eps_x' [B,F,3], 'eps_h' [B,F,nf];
        draws not injected, and the dropout masks, come from `generator`
        (on the model's device), which is then required.

        `rows` = (start, n_global): `batch` holds rows start.. of a global
        batch of n_global rows, split over the ranks of a process group
        (`parallel/mesh.py`). The draws and dropout masks are made at the
        global shape and sliced (injected draws are this slice's), the
        masked sums are divided by the global valid-centre count, and the
        metrics returned are the global batch's (one all-reduce each, JAX
        diffusion.py:316-321); the total returned is this slice's share
        of the global total, so its gradients summed over the ranks are
        the global batch's."""
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

        start, n_global = rows if rows is not None else (0, b)
        mine = slice(start, start + b)
        t_int = draw("t_int", lambda: torch.randint(
            0, cfg.n_timesteps, (n_global,), generator=generator,
            device=dev)[mine]).long()
        t = t_int.to(torch.float32) / cfg.n_timesteps
        eps_x = draw("eps_x", lambda: torch.randn(
            (n_global,) + x0.shape[1:], generator=generator,
            device=dev)[mine]).float() * fmask[..., None]
        eps_h = draw("eps_h", lambda: torch.randn(
            (n_global,) + h0.shape[1:], generator=generator,
            device=dev)[mine]).float() * fmask[..., None]

        gamma_t = self._gamma()[t_int]
        alpha_t = alpha_of_gamma(gamma_t)[:, None, None]
        sigma_t = sigma_of_gamma(gamma_t)[:, None, None]
        x_t = alpha_t * x0 + sigma_t * eps_x
        h_t = alpha_t * h0 + sigma_t * eps_h

        sampled_com = torch.zeros_like(com)
        if cfg.remove_com:
            sampled_com = masked_com(x_t, pharm_mask)
            x_t = (x_t - sampled_com[:, None]) * fmask[..., None]
            prot_x = prot_x - sampled_com[:, None]

        with batch_rows(start, n_global):
            h_dyn, x_dyn = self.dynamics(h_t, x_t, pharm_mask, prot_h,
                                         prot_x, prot_mask, t,
                                         pp_edge=pp_edge,
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
        n_valid = torch.sum(fmask)
        if rows is not None:
            n_valid = all_reduce_sum(n_valid)
        n_valid = torch.clamp(n_valid, min=1.0)
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
        if rows is not None:
            # the global batch's metrics: the sums of every rank's shares
            parts = {**losses, **metrics}
            summed = all_reduce_sum(torch.stack(
                [v.detach() for v in parts.values()]))
            parts = dict(zip(parts, summed.unbind()))
            losses = {k: parts[k] for k in losses}
            metrics = {k: parts[k] for k in metrics}
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
                              pp_k_out: int = 0, to_host: bool = False
                              ) -> Dict[str, Any]:
        """The full reverse DDPM chain (reference pharmacodiff.py:433-514).

        Returns tensors on the model's device (with `to_host`, numpy
        arrays copied to the host): final `pharm_x`/`pharm_h` in the
        original pocket frame, `pharm_mask`, and with
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
        below the pp graph's maximum out-degree raises ValueError.

        With `precompute_step_tables` the first conv's (timestep,
        pocket)-only work is built for all T steps before the chain
        (`dynamics.precompute_sampling_tables`, in chunks of steps sized
        by `step_table_plan`) and each step reads its slice. Where the
        tables' bytes exceed `precompute_table_budget`, the chain computes
        every step in full, as the JAX package does: a documented gate of
        the configuration, not a fallback of the device.

        The chain runs in three parts, as the JAX package's one `lax.scan`
        (diffusion.py:487-550) does: `chain_setup` once (pp edges, out-edge
        tables, step tables, noise, the per-step coefficient and timestep
        tables on the device), T calls of `chain_step`, which reads and
        writes only device tensors, and `chain_result`. On the card the
        steps are replays of CUDA graphs of U = max(1,
        `sample_scan_unroll`) steps each (and one graph of the last T mod
        U steps), with no host round trip between steps (`ChainGraphs`);
        a capture that fails raises. The graphs of the last signature stay
        on the model and serve the next chain of the same shapes, flags
        and parameter storage, as the JAX sampler reuses its jit. On the
        CPU the same step runs eagerly, U steps at a time.

        Spans (`utils/trace.py`): "chain.setup", "chain.graphs" (with
        "chain.capture" inside where new graphs are captured), then
        "chain.run", which holds "chain.replay" (the replays' enqueue;
        "chain.eager" for the CPU's eager steps) and "chain.fetch" (the
        result and, with `to_host`, its copy to the host, which waits for
        the device)."""
        chain = self.chain_setup(batch, generator, init_pharm_com,
                                 visualize_trajectory, noise,
                                 pocket_group_size, pp_k_out)
        unroll = max(1, self.config.sample_scan_unroll)
        graphs = None
        if chain.device.type == "cuda":
            graphs = self._graphs_for(chain, unroll)
            chain = graphs.chain
        with trace.span("chain.run"):
            if graphs is not None:
                with trace.span("chain.replay"):
                    graphs.run()
            else:
                with trace.span("chain.eager"):
                    for start in range(0, chain.n_steps, unroll):
                        for _ in range(min(unroll, chain.n_steps - start)):
                            self.chain_step(chain)
            with trace.span("chain.fetch"):
                out = self.chain_result(chain)
                if to_host:
                    out = {k: v.cpu().numpy() for k, v in out.items()}
        return out

    @torch.no_grad()
    def chain_setup(self, batch: PharmComplexBatch,
                    generator: Optional[torch.Generator] = None,
                    init_pharm_com=None, visualize_trajectory: bool = False,
                    noise: Optional[Dict[str, Any]] = None,
                    pocket_group_size: int = 1,
                    pp_k_out: int = 0) -> "ReverseChain":
        """Everything a chain does before its first step, once per chain
        (`sample_given_receptor`'s arguments). Holds a chain's host syncs,
        outside every graph: the out-degree check of `build_pp_out_edges`
        and, with radius pf edges (pf_k 0), the slot count M of
        `edges.radius_slot_count` (`inputs["pf_slots"]`, a Python int, so
        a chain of another M captures its own graphs). Span "chain.setup"
        (`utils/trace.py`)."""
        with trace.span("chain.setup"):
            return self._chain_setup(batch, generator, init_pharm_com,
                                     visualize_trajectory, noise,
                                     pocket_group_size, pp_k_out)

    def _chain_setup(self, batch, generator, init_pharm_com,
                     visualize_trajectory, noise, pocket_group_size,
                     pp_k_out) -> "ReverseChain":
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
            _, pp_edge = build_pp_edge(prot_x0[::c], prot_mask[::c],
                                       self.cutoffs["pp"], cfg.pp_k_max)
            # the pp edge's transpose, static over the chain
            if pp_k_out:
                pp_out = build_pp_out_edges(pp_edge, int(pp_k_out))
        else:
            _, pp_edge = build_pp_edge(prot_x0, prot_mask,
                                       self.cutoffs["pp"], cfg.pp_k_max)
        # radius pf edges on M slots a centre: the pocket's atoms keep
        # their relative places over the chain, so M holds at every step
        pf_slots = None
        if not (self.dynamics.pf_k and self.dynamics.pf_k > 0):
            c = pocket_group_size
            pf_slots = radius_slot_count(prot_x0[::c], prot_mask[::c],
                                         self.cutoffs["pf"])

        n_t = cfg.n_timesteps
        coef, t_values = self._schedule()
        # the (timestep, pocket)-only work of the first conv, for every
        # step at once, where the tables fit the budget
        tables = None
        if cfg.precompute_step_tables:
            c = pocket_group_size
            table_bytes, chunk = step_table_plan(
                cfg, pp_edge.mask.shape[0], pp_edge.mask.shape[1],
                pp_edge.mask.shape[2])
            if table_bytes <= cfg.precompute_table_budget:
                tables = precompute_sampling_tables(
                    self.dynamics, prot_h[::c], prot_mask[::c], pp_edge,
                    t_values, chunk)

        prot_x = prot_x0 - init_pharm_com[:, None]
        noise = dict(noise or {})
        noise = {**draw_chain_noise(generator, b, f, cfg.pharm_nf, n_t,
                                    initial="x_T" not in noise,
                                    steps="pos" not in noise), **noise}
        x_t = self._tensor(noise["x_T"], torch.float32) * fmask
        h_t = self._tensor(noise["h_T"], torch.float32) * fmask
        chain = ReverseChain(
            inputs=dict(
                pharm_mask=pharm_mask, fmask=fmask, prot_h=prot_h,
                prot_mask=prot_mask, init_prot_com=init_prot_com,
                pp_edge=pp_edge, pp_out=pp_out, tables=tables,
                pf_slots=pf_slots,
                pos_noise=self._tensor(noise["pos"], torch.float32),
                feat_noise=self._tensor(noise["feat"], torch.float32),
                coef=coef, t=t_values),
            state=dict(x=x_t, h=h_t, prot_x=prot_x,
                       i=torch.zeros(1, dtype=torch.int64, device=dev)),
            pocket_group_size=pocket_group_size, n_steps=n_t)
        if visualize_trajectory:
            x0, h0 = self._frame(chain, x_t, h_t, prot_x)
            chain.state["traj_x"] = x0.new_zeros((n_t + 1,) + x0.shape)
            chain.state["traj_h"] = h0.new_zeros((n_t + 1,) + h0.shape)
            chain.state["traj_x"][0] = x0
            chain.state["traj_h"][0] = h0
        return chain

    def _gamma(self) -> torch.Tensor:
        """The noise table [T+1] fp32 on the model's device, made once per
        device, so the loss makes no host copy (a captured train step
        cannot)."""
        gamma = getattr(self, "_gamma_table", None)
        if gamma is None or gamma.device != self.device:
            gamma = torch.from_numpy(
                np.asarray(self.gamma_table, np.float32)).to(self.device)
            self._gamma_table = gamma
        return gamma

    def _schedule(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The chain's per-step tables on the model's device, made once
        per device (no host copy, so no sync, in a later chain's set-up):
        coef [T, 5] (`_step_coefficients`) and the timestep of every step
        in loop order, t [T] (float32 s+1 over T, the values the per-step
        `torch.full` took)."""
        dev = self.device
        tables = getattr(self, "_schedule_tables", None)
        if tables is None or tables[0].device != dev:
            n_t = self.config.n_timesteps
            tables = (
                torch.from_numpy(_step_coefficients(
                    self.gamma_table, self.config)).to(dev),
                torch.tensor([np.float32(s + 1) / np.float32(n_t)
                              for s in range(n_t - 1, -1, -1)],
                             dtype=torch.float32, device=dev))
            self._schedule_tables = tables
        return tables

    def _frame(self, chain: "ReverseChain", x_t, h_t, prot_x):
        """Trajectory frame in the initial pocket frame."""
        inp = chain.inputs
        delta = inp["init_prot_com"] - masked_com(prot_x, inp["prot_mask"])
        return ((x_t + delta[:, None]) * inp["fmask"],
                h_t * self.config.pharm_feat_norm_constant)

    @torch.no_grad()
    def chain_step(self, chain: "ReverseChain") -> None:
        """One denoiser step of `chain`, in place: the JAX package's scan
        body (diffusion.py:487-546). Every per-step value comes from a
        device tensor indexed by the chain's device step counter `i` (the
        coefficients, the timestep, the noise, the step tables), and the
        step writes the new state into the chain's own tensors (and, with
        a trajectory, its frame at index i + 1) before it advances `i`, so
        a CUDA graph of it replays as the next step. No host sync."""
        cfg = self.config
        inp, st = chain.inputs, chain.state
        i = st["i"]
        b = st["x"].shape[0]
        c = chain.pocket_group_size
        alpha_tgs, var_terms, sigma, c_x, c_pred = \
            inp["coef"].index_select(0, i)[0].unbind()
        t_arr = inp["t"].index_select(0, i).expand(b)
        pp_edge = inp["pp_edge"]
        if c > 1:
            pp_edge = GroupedEdgeData(*pp_edge, copies=c)
        x_t, h_t = st["x"], st["h"]
        pred_h, pred_x = self.dynamics(
            h_t, x_t, inp["pharm_mask"], inp["prot_h"], st["prot_x"],
            inp["prot_mask"], t_arr, pp_edge=pp_edge, pocket_group_size=c,
            pp_out=inp["pp_out"],
            step_tables=None if inp["tables"] is None
            else inp["tables"].step(i), pf_slots=inp["pf_slots"])
        if cfg.endpoint_param_coord:
            mu_pos = c_x * x_t + c_pred * pred_x
        else:
            mu_pos = x_t / alpha_tgs - var_terms * pred_x
        if cfg.endpoint_param_feat:
            mu_feat = c_x * h_t + c_pred * pred_h
        else:
            mu_feat = h_t / alpha_tgs - var_terms * pred_h
        # noise is added at EVERY step including s=0
        fmask = inp["fmask"]
        x_new = (mu_pos + sigma * inp["pos_noise"].index_select(0, i)[0]) \
            * fmask
        h_new = (mu_feat + sigma * inp["feat_noise"].index_select(0, i)[0]) \
            * fmask
        com = masked_com(x_new, inp["pharm_mask"])
        x_new = (x_new - com[:, None]) * fmask
        prot_new = st["prot_x"] - com[:, None]
        if "traj_x" in st:
            fx, fh = self._frame(chain, x_new, h_new, prot_new)
            st["traj_x"].index_copy_(0, i + 1, fx[None])
            st["traj_h"].index_copy_(0, i + 1, fh[None])
        st["x"].copy_(x_new)
        st["h"].copy_(h_new)
        st["prot_x"].copy_(prot_new)
        i.add_(1)

    @torch.no_grad()
    def chain_result(self, chain: "ReverseChain") -> Dict[str, torch.Tensor]:
        """Finalize a chain after its T steps (pharmacodiff.py:479-488):
        new tensors, none of them the chain's own."""
        inp, st = chain.inputs, chain.state
        fmask = inp["fmask"]
        prot_com = masked_com(st["prot_x"], inp["prot_mask"])
        x_0 = (st["x"] - prot_com[:, None]) * fmask
        x_0 = (x_0 + inp["init_prot_com"][:, None]) * fmask
        h_0 = st["h"] * self.config.pharm_feat_norm_constant
        out = {"pharm_x": x_0, "pharm_h": h_0,
               "pharm_mask": inp["pharm_mask"].clone()}
        if "traj_x" in st:
            out["traj_x"] = st["traj_x"].clone()
            out["traj_h"] = st["traj_h"].clone()
        return out

    def _graphs_for(self, chain: "ReverseChain",
                    unroll: int) -> "ChainGraphs":
        """The captured graphs that run `chain`: the last ones, with
        `chain` copied into their tensors, where its signature matches
        theirs; else new ones, captured on a copy of `chain` (the old ones
        are freed first). Span "chain.graphs" (`utils/trace.py`)."""
        with trace.span("chain.graphs"):
            key = (_spec(chain.inputs), _spec(chain.state),
                   chain.pocket_group_size, chain.n_steps, unroll,
                   tuple(t.data_ptr() for t in
                         (*self.parameters(), *self.buffers())))
            graphs = getattr(self, "_chain_graphs", None)
            if graphs is not None and graphs.key == key:
                graphs.load(chain)
                return graphs
            self._chain_graphs = None
            graphs = ChainGraphs(self.chain_step, chain, unroll, key)
            self._chain_graphs = graphs
            return graphs


@dataclasses.dataclass
class ReverseChain:
    """One reverse chain on the device: `inputs`, which the set-up makes
    and every step reads (pharm_mask, fmask, prot_h, prot_mask,
    init_prot_com, pp_edge at pocket-group level when grouped, pp_out,
    step tables, pf_slots (the radius pf edge's slot count, an int, or
    None with kNN pf), pos_noise / feat_noise [T,B,F,.], coef [T,5] from
    `_step_coefficients`, t [T]); `state`, which the steps advance in
    place (x, h, prot_x, the step counter i [1] int64, and with a
    trajectory traj_x / traj_h [T+1,B,F,.])."""

    inputs: Dict[str, Any]
    state: Dict[str, torch.Tensor]
    pocket_group_size: int
    n_steps: int

    @property
    def device(self) -> torch.device:
        return self.state["x"].device


def _tensors(tree):
    """The tensors of a nest of dicts, tuples and lists, in order."""
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def _spec(tree):
    """The structure of a nest with every tensor as (shape, dtype,
    device): what a captured graph is specialised to."""
    if torch.is_tensor(tree):
        return tuple(tree.shape), tree.dtype, tree.device
    if isinstance(tree, dict):
        return tuple((k, _spec(v)) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return type(tree).__name__, tuple(_spec(v) for v in tree)
    return tree


def _clone(tree):
    """A copy of a nest with every tensor cloned."""
    if torch.is_tensor(tree):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_clone(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(v) for v in tree)
    return tree


# the registry's counters (`utils/trace.py`) that a graph's capture
# records, by kernel: each replay of the graph counts them again as
# "<kind>.replayed.<kernel>"
KERNEL_COUNTERS = {"knn_select": "knn_select.launches",
                   "pp_message": "pp_message.launches",
                   "pp_message_bwd": "pp_message.bwd_launches",
                   "corrections": "conv.corrections",
                   "gvp_chain": "gvp_chain.launches"}


@contextlib.contextmanager
def collector_paused():
    """Dead reference cycles collected now, and Python's cyclic garbage
    collector off inside the block: a collection during a CUDA graph
    capture could destroy an old graph kept in such a cycle, which a
    capturing stream does not allow (the capture is invalidated)."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def kernel_counts() -> Dict[str, int]:
    """The kernel counters now, by kernel (`KERNEL_COUNTERS`)."""
    now = trace.counters()
    return {k: now[name] for k, name in KERNEL_COUNTERS.items()}


def count_replays(kind: str, captured: Dict[str, int], replays: int) -> None:
    """Count `replays` replays of a `kind` graph ("chain", "train" or
    "eval") whose capture counted `captured` (kernel -> launches):
    "<kind>.replays" and "<kind>.replayed.<kernel>"."""
    trace.count(f"{kind}.replays", replays)
    for k, n in captured.items():
        trace.count(f"{kind}.replayed.{k}", n * replays)


class ChainGraphs:
    """A reverse chain as CUDA graphs: `unroll` steps of `step` in one
    graph, replayed T // unroll times, and the T mod unroll steps left in
    a second graph that shares the first one's memory pool.

    The chain is copied first, so the graphs read and write tensors of
    their own (`chain`); `load` copies a later chain of the same signature
    into them. Before capture one step runs eagerly on a side stream, so
    first-use work (kernel builds, launch attributes, cuBLAS workspaces)
    is done outside the graphs; the chain is then reloaded, so that step
    leaves no trace. `capture_ms` is the host time of that step and the
    captures, `pool_bytes` the device memory the captures reserved, and
    `graphs` holds (graph, its replays a chain, the launches its capture
    counted, by kernel). Building one counts "chain.captures" once its
    captures returned, inside the span "chain.capture" (`utils/trace.py`)."""

    def __init__(self, step, chain: ReverseChain, unroll: int, key):
        with trace.span("chain.capture"):
            self._capture(step, chain, unroll, key)
            trace.count("chain.captures")

    def _capture(self, step, chain: ReverseChain, unroll: int, key) -> None:
        dev = chain.device
        self.key = key
        self.chain = dataclasses.replace(chain,
                                         inputs=_clone(chain.inputs),
                                         state=_clone(chain.state))
        unroll = min(unroll, chain.n_steps)
        self.graphs = []
        t0 = time.perf_counter()
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                step(self.chain)
            torch.cuda.current_stream(dev).wait_stream(side)
            self.load(chain)
            with collector_paused():
                torch.cuda.synchronize(dev)
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved(dev)
                full, tail = divmod(chain.n_steps, unroll)
                pool = None
                for steps, replays in ((unroll, full), (tail, 1)):
                    if not steps or not replays:
                        continue
                    graph = torch.cuda.CUDAGraph()
                    before = kernel_counts()
                    with torch.cuda.graph(graph, pool=pool):
                        for _ in range(steps):
                            step(self.chain)
                    pool = graph.pool()
                    after = kernel_counts()
                    self.graphs.append(
                        (graph, replays, {k: after[k] - before[k]
                                          for k in after}))
                torch.cuda.synchronize(dev)
                self.pool_bytes = (torch.cuda.memory_reserved(dev)
                                   - reserved)
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def load(self, chain: ReverseChain) -> None:
        """Copy `chain`'s tensors (same signature) into the graphs' own."""
        for dst, src in zip(_tensors((self.chain.inputs, self.chain.state)),
                            _tensors((chain.inputs, chain.state))):
            dst.copy_(src)

    def run(self) -> None:
        """The chain's T steps, from the loaded state: every graph's
        replays, enqueued on the current stream without a host sync."""
        self.chain.state["i"].zero_()
        for graph, replays, counts in self.graphs:
            for _ in range(replays):
                graph.replay()
            count_replays("chain", counts, replays)
