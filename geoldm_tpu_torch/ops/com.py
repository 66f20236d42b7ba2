"""Masked centre-of-mass (CoM) subspace utilities and masked Gaussians.

Port of ``geoldm_tpu/ops/com.py:31-80``. Shapes: ``x`` is ``[B, N, D]``,
``node_mask`` is ``[B, N, 1]`` with values in {0, 1}; padded entries of any
masked tensor are exactly zero.

Noise comes from a ``noise`` source: a ``torch.Generator`` (the default
everywhere in the port) or any callable ``noise(shape) -> Tensor`` of
standard normals, so tests can feed both frameworks the same numbers.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

Noise = Union[torch.Generator, Callable[[tuple], torch.Tensor]]


def randn(noise: Noise, shape, like: torch.Tensor) -> torch.Tensor:
    """Standard normals of ``shape`` on ``like``'s device and dtype."""
    if isinstance(noise, torch.Generator):
        return torch.randn(tuple(shape), generator=noise, device=like.device,
                           dtype=like.dtype)
    out = torch.as_tensor(noise(tuple(shape)), dtype=like.dtype, device=like.device)
    if tuple(out.shape) != tuple(shape):
        raise ValueError(f"noise source returned {tuple(out.shape)}, wanted {tuple(shape)}")
    return out


def sum_except_batch(x: torch.Tensor) -> torch.Tensor:
    """Sum over all axes except the leading batch axis. -> [B]"""
    return x.reshape(x.shape[0], -1).sum(dim=-1)


def num_nodes(node_mask: torch.Tensor) -> torch.Tensor:
    """Number of real nodes per molecule. node_mask [B, N, 1] -> [B]"""
    return node_mask[:, :, 0].sum(dim=1)


def remove_mean_with_mask(x: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """Project x onto the zero-CoM subspace, respecting the node mask.

    Assumes padded rows of ``x`` are already zero.
    reference: equivariant_diffusion/utils.py:31-38."""
    n = node_mask.sum(dim=1, keepdim=True)  # [B, 1, 1]
    mean = x.sum(dim=1, keepdim=True) / n
    return x - mean * node_mask


def sample_gaussian_with_mask(noise: Noise, shape, node_mask: torch.Tensor) -> torch.Tensor:
    """Standard normal noise, zeroed at padded nodes."""
    return randn(noise, shape, node_mask) * node_mask


def sample_center_gravity_zero_gaussian_with_mask(
    noise: Noise, shape, node_mask: torch.Tensor
) -> torch.Tensor:
    """Normal noise projected onto the masked zero-CoM subspace."""
    x = randn(noise, shape, node_mask) * node_mask
    return remove_mean_with_mask(x, node_mask)
