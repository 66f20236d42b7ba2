"""Noise schedules and the gamma parametrisation (port of
``geoldm_tpu/diffusion/schedules.py:29-197``).

gamma(t) = -log(alpha_t^2 / sigma_t^2), alpha_t^2 = sigmoid(-gamma),
sigma_t^2 = sigmoid(gamma). Predefined schedules are (T+1)-entry tables
built with numpy, bit for bit as the JAX package builds them
(``PredefinedNoiseSchedule``); the learned schedule is a monotone network
of positive-weight linear layers (``GammaNetwork``). Both are the model's
``gamma`` module, called on t in [0, 1]; all gamma algebra runs in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


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


class PredefinedNoiseSchedule(nn.Module):
    """Holds the fixed gamma table under the state-dict key ``gamma`` (a
    frozen parameter upstream, en_diffusion.py:172-207), for strict
    checkpoint loading. It is a buffer here, so neither the optimizer nor
    the EMA ever touches it (the JAX package keeps no such parameter).
    Called on t it looks gamma(t) up (``gamma_lookup``)."""

    def __init__(self, noise_schedule: str, timesteps: int, precision: float):
        super().__init__()
        self.timesteps = timesteps
        table = gamma_table(noise_schedule, timesteps, precision)
        self.register_buffer("gamma", torch.from_numpy(table).float())

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return gamma_lookup(self.gamma, t, self.timesteps)


class PositiveLinear(nn.Module):
    """x @ softplus(W)^T + b, W initialised with torch's default Linear
    init shifted by ``weight_init_offset`` (reference en_diffusion.py:122-148;
    ``_positive_linear``, schedules.py:130-131)."""

    def __init__(self, in_features: int, out_features: int, weight_init_offset: float = -2.0):
        super().__init__()
        self.weight_init_offset = weight_init_offset
        bound = 1.0 / math.sqrt(in_features)
        self.weight = nn.Parameter(torch.empty(out_features, in_features).uniform_(-bound, bound)
                                   + weight_init_offset)
        self.bias = nn.Parameter(torch.empty(out_features).uniform_(-bound, bound))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, F.softplus(self.weight), self.bias)


class GammaNetwork(nn.Module):
    """The learned monotone gamma(t), normalised to [gamma_0, gamma_1] over
    t in [0, 1]: layers 1->1, 1->1024, 1024->1 with softplus-positive
    weights (reference en_diffusion.py:210-247; ``gamma_network_init`` /
    ``gamma_network_apply``, schedules.py:114-150). gamma_0 and gamma_1 are
    parameters, trained like the rest; l3's bias cancels out of gamma, so it
    gets no gradient (JAX's is f32 rounding noise). Its input is cast to its
    parameters' dtype (float32: the compute dtype rounds only the EGNNs'
    products); the output keeps t's shape ([B] or [B, 1])."""

    def __init__(self):
        super().__init__()
        self.l1 = PositiveLinear(1, 1)
        self.l2 = PositiveLinear(1, 1024)
        self.l3 = PositiveLinear(1024, 1)
        self.gamma_0 = nn.Parameter(torch.tensor([-5.0]))
        self.gamma_1 = nn.Parameter(torch.tensor([10.0]))

    def _tilde_minus_tilde0(self, t: torch.Tensor, l1_0: torch.Tensor,
                            s_0: torch.Tensor) -> torch.Tensor:
        """gamma_tilde(t) - gamma_tilde(0), gamma_tilde(t) = l1(t) +
        l3(sigmoid(l2(l1(t)))), as the sum of its layers' differences: l3's
        bias cancels, and no ~1e2-sized gamma_tilde is formed only to be
        subtracted (at the reference init gamma_tilde(0) is ~64 and
        gamma_tilde(1) - gamma_tilde(0) ~0.7, so JAX's f32 difference carries
        ~2e-4 of rounding; the algebra is the same)."""
        l1_t = self.l1(t)
        s_t = torch.sigmoid(self.l2(l1_t))
        return (l1_t - l1_0) + F.linear(s_t - s_0, F.softplus(self.l3.weight))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        t2 = t.to(self.gamma_0.dtype).reshape(-1, 1)
        l1_0 = self.l1(torch.zeros_like(t2[:1]))
        s_0 = torch.sigmoid(self.l2(l1_0))
        normalized = (self._tilde_minus_tilde0(t2, l1_0, s_0)
                      / self._tilde_minus_tilde0(torch.ones_like(t2[:1]), l1_0, s_0))
        return (self.gamma_0 + (self.gamma_1 - self.gamma_0) * normalized).reshape(t.shape)


def make_gamma_module(noise_schedule: str, timesteps: int, precision: float) -> nn.Module:
    """The model's ``gamma`` module: a ``GammaNetwork`` for 'learned', else
    the table of a predefined schedule."""
    if noise_schedule == "learned":
        return GammaNetwork()
    return PredefinedNoiseSchedule(noise_schedule, timesteps, precision)


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
