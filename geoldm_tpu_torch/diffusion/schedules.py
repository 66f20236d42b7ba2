"""Noise schedules and the gamma parametrisation (port of
``geoldm_tpu/diffusion/schedules.py:29-197``, fixed schedules only).

gamma(t) = -log(alpha_t^2 / sigma_t^2), alpha_t^2 = sigmoid(-gamma),
sigma_t^2 = sigmoid(gamma). Predefined schedules are (T+1)-entry tables
built with numpy, bit for bit as the JAX package builds them; the algebra
on them runs in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def clip_noise_schedule(alphas2: np.ndarray, clip_value: float = 0.001) -> np.ndarray:
    """reference: en_diffusion.py:23-35."""
    alphas2 = np.concatenate([np.ones(1), alphas2], axis=0)
    alphas_step = alphas2[1:] / alphas2[:-1]
    alphas_step = np.clip(alphas_step, a_min=clip_value, a_max=1.0)
    return np.cumprod(alphas_step, axis=0)


def polynomial_schedule(timesteps: int, s: float = 1e-4, power: float = 2.0) -> np.ndarray:
    """reference: en_diffusion.py:38-52."""
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    alphas2 = (1 - np.power(x / steps, power)) ** 2
    alphas2 = clip_noise_schedule(alphas2, clip_value=0.001)
    precision = 1 - 2 * s
    return precision * alphas2 + s


def cosine_beta_schedule(timesteps: int, s: float = 0.008,
                         raise_to_power: float = 1.0) -> np.ndarray:
    """reference: en_diffusion.py:55-72."""
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


def gamma_table(noise_schedule: str, timesteps: int, precision: float) -> np.ndarray:
    """(T+1)-entry gamma table (reference: en_diffusion.py:176-203)."""
    if noise_schedule == "cosine":
        alphas2 = cosine_beta_schedule(timesteps)
    elif "polynomial" in noise_schedule:
        splits = noise_schedule.split("_")
        if len(splits) != 2:
            raise ValueError(f"bad polynomial schedule {noise_schedule!r}")
        alphas2 = polynomial_schedule(timesteps, s=precision, power=float(splits[1]))
    else:
        raise ValueError(f"unknown noise schedule {noise_schedule!r}")
    sigmas2 = 1 - alphas2
    gamma = -(np.log(alphas2) - np.log(sigmas2))
    return gamma.astype(np.float64)


def gamma_lookup(table: torch.Tensor, t: torch.Tensor, timesteps: int) -> torch.Tensor:
    """gamma(t) for t in [0, 1] by rounded table lookup; keeps t's shape.
    ``table`` is float32 (reference: en_diffusion.py:205-207)."""
    t_int = torch.round(t.float() * timesteps).long()
    return table[t_int]


def inflate(array: torch.Tensor, ndim: int) -> torch.Tensor:
    """[B] or [B,1] -> [B, 1, ..., 1] with ``ndim`` axes."""
    return array.reshape(array.shape[0], *([1] * (ndim - 1)))


def sigma(gamma: torch.Tensor, ndim: int) -> torch.Tensor:
    return inflate(torch.sqrt(torch.sigmoid(gamma)), ndim)


def alpha(gamma: torch.Tensor, ndim: int) -> torch.Tensor:
    return inflate(torch.sqrt(torch.sigmoid(-gamma)), ndim)


def snr(gamma: torch.Tensor) -> torch.Tensor:
    return torch.exp(-gamma)


def sigma_and_alpha_t_given_s(gamma_t: torch.Tensor, gamma_s: torch.Tensor, ndim: int):
    """Transition coefficients between two noise levels
    (reference: en_diffusion.py:382-405)."""
    sigma2_t_given_s = inflate(-torch.expm1(F.softplus(gamma_s) - F.softplus(gamma_t)), ndim)
    log_alpha2_t = F.logsigmoid(-gamma_t)
    log_alpha2_s = F.logsigmoid(-gamma_s)
    alpha_t_given_s = inflate(torch.exp(0.5 * (log_alpha2_t - log_alpha2_s)), ndim)
    return sigma2_t_given_s, torch.sqrt(sigma2_t_given_s), alpha_t_given_s


def check_issues_norm_values(table: np.ndarray, norm_values, num_stdevs: int = 8) -> None:
    """Raise if sigma_0 is too large for the normalisation
    (reference: en_diffusion.py:299-312)."""
    sigma_0 = math.sqrt(1.0 / (1.0 + math.exp(-float(table[0]))))
    max_norm_value = max(norm_values[1], norm_values[2])
    if sigma_0 * num_stdevs > 1.0 / max_norm_value:
        raise ValueError(
            f"Normalization value {max_norm_value} probably too large with "
            f"sigma_0 {sigma_0:.5f} and 1/norm_value = {1.0 / max_norm_value}")
