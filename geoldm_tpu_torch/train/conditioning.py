"""Property conditioning (port of ``geoldm_tpu/train/conditioning.py``),
host-side numpy:

- mean/MAD normalizers per property (reference qm9/utils.py:4-23): ``qm9``
  takes them from its train split, the halves from their **valid** split;
- ``load_conditional_protocol``: what evaluating or serving a conditional
  QM9 checkpoint needs, all from the split it trained on;
- per-node context from global properties (reference qm9/utils.py:56-89);
- the classifier's charge-power node features (reference qm9/utils.py:48-53).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Sequence

import numpy as np


def compute_mean_mad_from_arrays(data: Dict[str, np.ndarray], properties: Sequence[str]
                                 ) -> Dict[str, Dict[str, float]]:
    """{property: {"mean", "mad"}} over the arrays of one split."""
    norms = {}
    for key in properties:
        values = np.asarray(data[key], dtype=np.float64)
        mean = float(values.mean())
        norms[key] = {"mean": mean, "mad": float(np.abs(values - mean).mean())}
    return norms


def compute_mean_mad(splits: Dict[str, Dict[str, np.ndarray]], properties: Sequence[str],
                     dataset_name: str) -> Dict[str, Dict[str, float]]:
    """``qm9`` uses its train split's statistics, ``qm9_first_half`` and
    ``qm9_second_half`` their valid split's (reference qm9/utils.py:4-10)."""
    if dataset_name == "qm9":
        return compute_mean_mad_from_arrays(splits["train"], properties)
    if dataset_name in ("qm9_second_half", "qm9_first_half"):
        return compute_mean_mad_from_arrays(splits["valid"], properties)
    raise ValueError(dataset_name)


def load_conditional_protocol(datadir: str, properties: Sequence[str],
                              dataset: str = "qm9_second_half"):
    """(splits, norms, prop_dist, nodes_dist, pad) for evaluating or serving
    a conditional QM9 checkpoint (reference eval_conditional_qm9.py:55-76).
    ``nodes_dist`` and ``pad`` come from the train split's own size
    histogram, not the dataset table: the checkpoint only saw those sizes."""
    from geoldm_tpu_torch.data.qm9 import load_qm9
    from geoldm_tpu_torch.models.distributions import DistributionNodes, DistributionProperty

    splits, _ = load_qm9(datadir, dataset=dataset)
    train = splits["train"]
    norms = compute_mean_mad(splits, list(properties), dataset)
    prop_dist = DistributionProperty(train["num_atoms"], {p: train[p] for p in properties})
    prop_dist.set_normalizer(norms)
    nodes_dist = DistributionNodes(dict(Counter(int(n) for n in train["num_atoms"])))
    return splits, norms, prop_dist, nodes_dist, int(np.max(train["num_atoms"]))


def property_channels(model_cfg) -> int:
    """How many property channels a model's context holds: its context
    width less the indicator channel."""
    sub = model_cfg.dynamics if model_cfg.dynamics is not None else model_cfg.vae
    return sub.context_node_nf - int(model_cfg.context_indicator)


def prepare_context(conditioning: Sequence[str], batch: Dict[str, np.ndarray],
                    property_norms: Dict[str, Dict[str, float]],
                    indicator: bool = False) -> np.ndarray:
    """[B, N, context_nf] per-node context from a batch's properties,
    normalized and masked at padding. Global (per-molecule) properties
    broadcast over the nodes; per-node ones pass through. ``indicator``
    appends a trailing all-ones channel (models built with
    ``context_indicator``), which tells the guidance null (all zeros) from a
    property at its mean."""
    node_mask = batch["node_mask"]
    b, n = node_mask.shape[0], node_mask.shape[1]
    pieces = []
    for key in conditioning:
        props = np.asarray(batch[key], dtype=np.float32)
        props = (props - property_norms[key]["mean"]) / property_norms[key]["mad"]
        if props.ndim == 1:
            assert props.shape == (b,)
            pieces.append(np.broadcast_to(props[:, None, None], (b, n, 1)))
        elif props.ndim in (2, 3):
            assert props.shape[:2] == (b, n)
            pieces.append(props[..., None] if props.ndim == 2 else props)
        else:
            raise ValueError(f"invalid property shape {props.shape}")
    if indicator:
        pieces.append(np.ones((b, n, 1), dtype=np.float32))
    context = np.concatenate(pieces, axis=2).astype(np.float32)
    return context * node_mask


def preprocess_input(one_hot: np.ndarray, charges: np.ndarray, charge_power: int,
                     charge_scale: float) -> np.ndarray:
    """one_hot x (charge / scale)^p for p = 0..charge_power, flattened per
    node: the classifier's charge-power features."""
    powers = np.arange(charge_power + 1, dtype=np.float32)
    charge_tensor = (np.asarray(charges, dtype=np.float32)[..., None] / charge_scale) ** powers
    atom_scalars = one_hot[..., None] * charge_tensor[..., None, :]
    return atom_scalars.reshape(charges.shape[:2] + (-1,)).astype(np.float32)
