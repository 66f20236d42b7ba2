"""Training checkpoints in the upstream GeoLDM layout (the role of
``geoldm_tpu/utils/checkpoint.py``, in the format upstream main_qm9.py
writes): a directory holding ``args.pickle`` (the run's argparse
namespace), ``generative_model.npy``, ``generative_model_ema.npy`` (when
training with EMA) and ``optim.npy``, each ``.npy`` a ``torch.save``d state
dict. ``utils.convert.load_reference_checkpoint`` and the server load it.
"""

from __future__ import annotations

import os
import pickle

import torch


def _cpu_state(module) -> dict:
    return {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}


def save_checkpoint(path: str, state, args, ema_decay: float) -> str:
    """Write one checkpoint directory at ``path`` (replacing its files)."""
    os.makedirs(path, exist_ok=True)
    torch.save(_cpu_state(state.model), os.path.join(path, "generative_model.npy"))
    if ema_decay > 0:
        torch.save(_cpu_state(state.ema_model), os.path.join(path, "generative_model_ema.npy"))
    torch.save(state.optimizer.state_dict(), os.path.join(path, "optim.npy"))
    with open(os.path.join(path, "args.pickle"), "wb") as f:
        pickle.dump(args, f)
    return path
