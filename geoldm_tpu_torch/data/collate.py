"""Static-shape masks (port of ``geoldm_tpu/data/collate.py:17-31``)."""

from __future__ import annotations

import numpy as np


def edge_mask_from_node_mask(node_mask: np.ndarray) -> np.ndarray:
    """node_mask [B,N,1] -> edge_mask [B,N,N,1]: outer minus diagonal."""
    n = node_mask.shape[1]
    edge = node_mask[:, :, None, 0] * node_mask[:, None, :, 0]
    eye = np.eye(n, dtype=np.float32)[None]
    return (edge * (1.0 - eye))[..., None].astype(np.float32)


def build_masks(n_atoms: np.ndarray, pad_nodes: int):
    """n_atoms [B] -> node_mask [B,N,1], edge_mask [B,N,N,1] float32."""
    node_mask = (
        np.arange(pad_nodes)[None, :] < np.asarray(n_atoms)[:, None]
    ).astype(np.float32)[..., None]
    return node_mask, edge_mask_from_node_mask(node_mask)
