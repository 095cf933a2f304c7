"""Predefined (non-learned) diffusion noise schedules.

Copy of `pharmaforge_tpu/models/schedules.py` (numpy only), kept here so
the port imports nothing from the JAX package. The tables are built in
float64 numpy at model-construction time and used as float32.

gamma(t) is defined through alpha^2:  gamma = -log(alpha^2 / sigma^2) with
sigma^2 = 1 - alpha^2, so  alpha = sqrt(sigmoid(-gamma)) and
sigma = sqrt(sigmoid(gamma)).
"""

from __future__ import annotations

import numpy as np


def cosine_beta_schedule(timesteps: int, s: float = 0.008,
                         raise_to_power: float = 1.0) -> np.ndarray:
    """Cosine alpha-bar schedule (reference pharmacodiff.py:582-599)."""
    steps = timesteps + 2
    x = np.linspace(0, steps, steps)
    alphas_cumprod = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    betas = np.clip(betas, a_min=0, a_max=0.999)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    if raise_to_power != 1:
        alphas_cumprod = np.power(alphas_cumprod, raise_to_power)
    return alphas_cumprod


def clip_noise_schedule(alphas2: np.ndarray, clip_value: float = 0.001) -> np.ndarray:
    """Clip per-step alpha ratios for sampling stability
    (reference pharmacodiff.py:602-615)."""
    alphas2 = np.concatenate([np.ones(1), alphas2], axis=0)
    alphas_step = alphas2[1:] / alphas2[:-1]
    alphas_step = np.clip(alphas_step, a_min=clip_value, a_max=1.0)
    return np.cumprod(alphas_step, axis=0)


def polynomial_schedule(timesteps: int, s: float = 1e-4, power: float = 3.0) -> np.ndarray:
    """alpha^2(t) = ((1 - (t/T')^power)^2, clipped and precision-scaled
    (reference pharmacodiff.py:618-632)."""
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    alphas2 = (1 - np.power(x / steps, power)) ** 2
    alphas2 = clip_noise_schedule(alphas2, clip_value=0.001)
    precision = 1 - 2 * s
    return precision * alphas2 + s


def make_gamma_table(noise_schedule: str, timesteps: int,
                     precision: float) -> np.ndarray:
    """Lookup table gamma[t_int] for t_int in 0..timesteps.

    Mirrors PredefinedNoiseSchedule (reference pharmacodiff.py:636-668):
    `noise_schedule` is 'cosine' or 'polynomial_<power>'. The reference
    hardcodes 'polynomial_2' at construction (pharmacodiff.py:64).
    Lookup: gamma(t) for continuous t in [0,1] is gamma_table[round(t*T)].
    """
    if noise_schedule == "cosine":
        alphas2 = cosine_beta_schedule(timesteps)
    elif "polynomial" in noise_schedule:
        splits = noise_schedule.split("_")
        assert len(splits) == 2, noise_schedule
        power = float(splits[1])
        alphas2 = polynomial_schedule(timesteps, s=precision, power=power)
    else:
        raise ValueError(noise_schedule)

    sigmas2 = 1 - alphas2
    log_alphas2 = np.log(alphas2)
    log_sigmas2 = np.log(sigmas2)
    gamma = -(log_alphas2 - log_sigmas2)
    return gamma.astype(np.float32)
