"""Batch collation: pad variable-size molecules into static-shape arrays
(port of ``geoldm_tpu/data/collate.py``). Batches are padded to a fixed
``pad_nodes``; the edge mask is the node-mask outer product minus the
diagonal (reference collate.py:89-97).
"""

from __future__ import annotations

from typing import Dict, Sequence

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


def prepare_split_arrays(
    num_atoms: np.ndarray,
    positions: np.ndarray,
    one_hot: np.ndarray,
    charges: np.ndarray,
    pad_nodes: int,
    include_charges: bool,
) -> Dict[str, np.ndarray]:
    """Pad, CoM-center, and mask already-stacked split arrays.

    The single source of the model-input convention (x CoM-centered on real
    atoms — reference train_test.py:28 — h_cat/h_int masked, width padded
    to ``pad_nodes``), shared by QM9Loader batches and the device-resident
    packed-NLL path so the two can't drift apart. Returns x / h_cat /
    h_int / node_mask; edge masks are built separately (host: build_masks,
    device: ops.distance.build_edge_mask)."""
    num_atoms = np.asarray(num_atoms)
    m = len(num_atoms)
    stored_n = positions.shape[1]
    assert stored_n <= pad_nodes, (
        f"pad_nodes={pad_nodes} < stored width {stored_n}"
    )
    pad_extra = pad_nodes - stored_n
    pos = positions.astype(np.float32)
    oh = one_hot.astype(np.float32)
    ch = charges.astype(np.float32)
    if pad_extra:
        pos = np.pad(pos, ((0, 0), (0, pad_extra), (0, 0)))
        oh = np.pad(oh, ((0, 0), (0, pad_extra), (0, 0)))
        ch = np.pad(ch, ((0, 0), (0, pad_extra)))
    node_mask = (
        np.arange(pad_nodes)[None, :] < num_atoms[:, None]
    ).astype(np.float32)[..., None]
    mean = pos.sum(axis=1, keepdims=True) / np.maximum(num_atoms[:, None, None], 1)
    pos = (pos - mean) * node_mask
    h_int = (
        (ch[..., None] * node_mask).astype(np.float32)
        if include_charges
        else np.zeros((m, pad_nodes, 0), dtype=np.float32)
    )
    return {
        "x": pos,
        "h_cat": oh * node_mask,
        "h_int": h_int,
        "node_mask": node_mask,
    }


def collate_molecules(
    positions: Sequence[np.ndarray],
    one_hot: Sequence[np.ndarray],
    charges: Sequence[np.ndarray],
    pad_nodes: int,
    include_charges: bool = True,
    center: bool = True,
) -> Dict[str, np.ndarray]:
    """Pad a list of molecules to a static-size batch dict."""
    b = len(positions)
    num_classes = one_hot[0].shape[-1]
    x = np.zeros((b, pad_nodes, 3), dtype=np.float32)
    h_cat = np.zeros((b, pad_nodes, num_classes), dtype=np.float32)
    h_int = np.zeros((b, pad_nodes, 1 if include_charges else 0), dtype=np.float32)
    n_atoms = np.zeros((b,), dtype=np.int64)
    for i in range(b):
        n = positions[i].shape[0]
        assert n <= pad_nodes, f"molecule with {n} atoms exceeds pad_nodes={pad_nodes}"
        n_atoms[i] = n
        pos = np.asarray(positions[i], dtype=np.float32)
        if center:
            pos = pos - pos.mean(axis=0, keepdims=True)
        x[i, :n] = pos
        h_cat[i, :n] = np.asarray(one_hot[i], dtype=np.float32)
        if include_charges:
            h_int[i, :n, 0] = np.asarray(charges[i], dtype=np.float32).reshape(n)
    node_mask, edge_mask = build_masks(n_atoms, pad_nodes)
    return {
        "x": x,
        "h_cat": h_cat,
        "h_int": h_int,
        "node_mask": node_mask,
        "edge_mask": edge_mask,
        "n_atoms": n_atoms,
    }
