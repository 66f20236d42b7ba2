"""Data augmentation: random 3D rotations (host-side numpy; a copy of
``geoldm_tpu/train/augment.py``, so the same generator gives the same
matrices).

reference: utils.py:70-129 (random_rotation) — composed per-sample rotations
about the three axes, applied to the coordinate block during training when
--data_augmentation is set (train_test.py:32-33).
"""

from __future__ import annotations

import numpy as np


def random_rotation(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """x [B, N, 3] -> randomly rotated per batch element."""
    b = x.shape[0]
    thetas = rng.uniform(-np.pi, np.pi, size=(3, b))
    cos, sin = np.cos(thetas), np.sin(thetas)

    rx = np.zeros((b, 3, 3), dtype=x.dtype)
    rx[:, 0, 0] = 1
    rx[:, 1, 1] = cos[0]
    rx[:, 1, 2] = sin[0]
    rx[:, 2, 1] = -sin[0]
    rx[:, 2, 2] = cos[0]

    ry = np.zeros((b, 3, 3), dtype=x.dtype)
    ry[:, 1, 1] = 1
    ry[:, 0, 0] = cos[1]
    ry[:, 0, 2] = -sin[1]
    ry[:, 2, 0] = sin[1]
    ry[:, 2, 2] = cos[1]

    rz = np.zeros((b, 3, 3), dtype=x.dtype)
    rz[:, 2, 2] = 1
    rz[:, 0, 0] = cos[2]
    rz[:, 0, 1] = sin[2]
    rz[:, 1, 0] = -sin[2]
    rz[:, 1, 1] = cos[2]

    xt = np.swapaxes(x, 1, 2)  # [B, 3, N]
    xt = rz @ (ry @ (rx @ xt))
    return np.ascontiguousarray(np.swapaxes(xt, 1, 2))
