"""Dense pairwise-distance features (port of ``geoldm_tpu/ops/distance.py``).

Node tensors stay ``[B, N, D]``; pairwise quantities are dense
``[B, N, N, D]`` broadcasts.
"""

from __future__ import annotations

import math

import torch

# Sinusoidal distance-embedding constants (reference: egnn/egnn_new.py:235-246,
# SinusoidsEmbeddingNew with max_res=15, min_res=15/2000, div_factor=4).
_MAX_RES = 15.0
_MIN_RES = 15.0 / 2000.0
_DIV_FACTOR = 4
_N_FREQUENCIES = int(math.log(_MAX_RES / _MIN_RES, _DIV_FACTOR)) + 1
SIN_EMBEDDING_DIM = 2 * _N_FREQUENCIES

_FREQUENCIES = tuple(
    2.0 * math.pi * _DIV_FACTOR**i / _MAX_RES for i in range(_N_FREQUENCIES)
)


def coord2diff(x: torch.Tensor, norm_constant: float = 1.0):
    """x [B, N, D] -> (radial [B, N, N, 1], coord_diff [B, N, N, D]) with
    radial = ||x_i - x_j||^2 and coord_diff = (x_i - x_j)/(||.|| + norm_constant).
    The norm is sqrt(radial + 1e-8). reference: egnn/egnn_new.py:249-255."""
    diff = x[:, :, None, :] - x[:, None, :, :]
    radial = (diff * diff).sum(dim=-1, keepdim=True)
    norm = torch.sqrt(radial + 1e-8)
    return radial, diff / (norm + norm_constant)


def sin_embedding(radial: torch.Tensor) -> torch.Tensor:
    """Fourier features of the distance (input is the squared distance),
    detached like the reference (egnn/egnn_new.py:242-246).
    radial [..., 1] -> [..., SIN_EMBEDDING_DIM]."""
    d = torch.sqrt(radial + 1e-8)
    freqs = torch.tensor(_FREQUENCIES, dtype=radial.dtype, device=radial.device)
    emb = d * freqs
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1).detach()


def build_edge_mask(node_mask: torch.Tensor) -> torch.Tensor:
    """Outer product of node masks with the diagonal removed.
    node_mask [B, N, 1] -> [B, N, N, 1]."""
    n = node_mask.shape[1]
    m = node_mask[:, :, None, :] * node_mask[:, None, :, :]
    eye = torch.eye(n, dtype=node_mask.dtype, device=node_mask.device)[None, :, :, None]
    return m * (1.0 - eye)
