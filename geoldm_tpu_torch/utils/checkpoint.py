"""Training checkpoints in the upstream GeoLDM layout (the role of
``geoldm_tpu/utils/checkpoint.py``, in the format upstream main_qm9.py
writes): a directory holding ``args.pickle`` (the run's argparse
namespace), ``generative_model.npy``, ``generative_model_ema.npy`` (when
training with EMA) and ``optim.npy``, each ``.npy`` a ``torch.save``d state
dict. ``utils.convert.load_reference_checkpoint`` and the server load it.

What upstream does not keep goes into a file of its own,
``train_state.npy``: the adaptive clip's ring buffer and the step count
(JAX keeps both in its train state). ``optim.npy`` stays exactly AdamW's
state dict, so released GeoLDM checkpoints and upstream tools still read the
directory, and a directory without ``train_state.npy`` (written before the
port saved it, or by upstream) resumes with a fresh clip.

``args.pickle`` is unpickled: load only checkpoints you trust, as with
upstream GeoLDM itself.
"""

from __future__ import annotations

import os
import pickle
import warnings

import torch

TRAIN_STATE = "train_state.npy"


def _cpu_state(module) -> dict:
    return {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}


def save_checkpoint(path: str, state, args, ema_decay: float) -> str:
    """Write one checkpoint directory at ``path`` (replacing its files)."""
    os.makedirs(path, exist_ok=True)
    torch.save(_cpu_state(state.model), os.path.join(path, "generative_model.npy"))
    if ema_decay > 0:
        torch.save(_cpu_state(state.ema_model), os.path.join(path, "generative_model_ema.npy"))
    torch.save(state.optimizer.state_dict(), os.path.join(path, "optim.npy"))
    torch.save({"step": state.step,
                "clip": state.clip.state_dict() if state.clip is not None else None},
               os.path.join(path, TRAIN_STATE))
    with open(os.path.join(path, "args.pickle"), "wb") as f:
        pickle.dump(args, f)
    return path


def checkpoint_dir(path: str, name: str) -> str:
    """``path`` itself when it is a checkpoint directory (it holds
    ``args.pickle``: an upstream or released checkpoint), else the run
    directory's ``<path>/<name>``."""
    if os.path.exists(os.path.join(path, "args.pickle")):
        return path
    sub = os.path.join(path, name)
    if not os.path.exists(os.path.join(sub, "args.pickle")):
        raise FileNotFoundError(f"{path} is neither a checkpoint directory (args.pickle) nor a "
                                f"run directory holding {name}/args.pickle")
    return sub


def load_args(path: str):
    """The pickled argparse namespace of a checkpoint directory."""
    with open(os.path.join(path, "args.pickle"), "rb") as f:
        return pickle.load(f)


def load_model_config(path: str):
    """The ModelConfig a checkpoint directory was trained with, from its
    ``args.pickle`` through ``utils.convert.model_config_from_reference_args``
    (JAX: ``geoldm_tpu/utils/checkpoint.py:117 load_config``)."""
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.utils.convert import model_config_from_reference_args

    args = load_args(path)
    info = get_dataset_info(getattr(args, "dataset", "qm9"), getattr(args, "remove_h", False))
    return model_config_from_reference_args(args, info)


def _load(path: str, name: str):
    return torch.load(os.path.join(path, name), map_location="cpu", weights_only=True)


_FRESH_CLIP_WARNED = False


def load_train_state(path: str, state) -> None:
    """Restore a whole train state in place from the checkpoint directory
    ``path``: the model, the EMA model, AdamW's state, the clip's ring buffer
    and the step. The state must be built for the checkpoint's config (every
    load is strict). Without ``train_state.npy`` the clip and the step start
    fresh, with one warning."""
    global _FRESH_CLIP_WARNED
    state.model.load_state_dict(_load(path, "generative_model.npy"), strict=True)
    if state.ema_model is not state.model:
        ema = os.path.join(path, "generative_model_ema.npy")
        if not os.path.exists(ema):
            raise FileNotFoundError(f"{ema} is missing: the run trains with EMA, and the "
                                    "checkpoint was written without it (--ema_decay 0)")
        state.ema_model.load_state_dict(_load(path, "generative_model_ema.npy"), strict=True)
    state.optimizer.load_state_dict(_load(path, "optim.npy"))
    if not os.path.exists(os.path.join(path, TRAIN_STATE)):
        if not _FRESH_CLIP_WARNED:
            warnings.warn(f"{path} has no {TRAIN_STATE} (written before the clip state was "
                          "saved): the gradient clip and the step count start fresh",
                          stacklevel=2)
            _FRESH_CLIP_WARNED = True
        return
    extra = _load(path, TRAIN_STATE)
    state.step = int(extra["step"])
    if state.clip is not None and extra["clip"] is not None:
        state.clip.load_state_dict(extra["clip"])


def load_first_stage(ae_path: str, use_ema: bool) -> dict:
    """The first-stage VAE's weights from ``<ae_path>/best`` (or ``ae_path``
    itself when it is a checkpoint directory), for the latent diffusion's
    ``vae`` (reference qm9/models.py:103-128): the EMA weights when
    ``use_ema`` (the run trains with EMA, JAX's rule), which must then be
    there; never the non-EMA weights in their place."""
    from geoldm_tpu_torch.utils.convert import checkpoint_kind

    path = checkpoint_dir(ae_path, "best")
    kind = checkpoint_kind(load_args(path))
    if kind != "vae":
        raise ValueError(f"{path} holds a {kind.replace('_', ' ')} model, not a first-stage VAE")
    name = "generative_model_ema.npy" if use_ema else "generative_model.npy"
    if not os.path.exists(os.path.join(path, name)):
        why = " (the run trains with EMA, so the first stage's EMA weights are required)"
        raise SystemExit(f"--ae_path: {os.path.join(path, name)} is missing"
                         f"{why if use_ema else ''}")
    return _load(path, name)
