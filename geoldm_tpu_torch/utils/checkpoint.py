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

Under tensor parallelism (``--tp``) every rank joins the gathers of the EMA
and of AdamW's moments (``full_state``) and one rank writes exactly the
files a one-rank run writes; on load every rank reads the full files and
keeps its rows of the sharded parameters, so a checkpoint resumes under any
``--tp``.

``args.pickle`` is unpickled: load only checkpoints you trust, as with
upstream GeoLDM itself.
"""

from __future__ import annotations

import copy
import os
import pickle
import warnings

import torch

TRAIN_STATE = "train_state.npy"


def _cpu(obj):
    """A copy of a nested state dict with every tensor cloned to the CPU."""
    if torch.is_tensor(obj):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return copy.deepcopy(obj)


def full_state(state) -> dict:
    """A CPU copy of a train state as one rank holds it: the model's and
    the EMA model's state dicts (None without EMA), AdamW's state dict, the
    clip's ring buffer and the step. Under TP the EMA and the moments are
    gathered over the model ranks: every rank must call it."""
    from geoldm_tpu_torch.train import train_step as ts

    return {"model": {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()},
            "ema": None if state.ema_model is state.model else ts.ema_state_dict(state),
            "optim": _cpu(ts.optimizer_state_dict(state)),
            "clip": state.clip.state_dict() if state.clip is not None else None,
            "step": state.step}


def save_checkpoint(path: str, state, args, ema_decay: float, write: bool = True) -> str:
    """Write one checkpoint directory at ``path`` (replacing its files).
    Under TP every rank calls it for the gathers and only the one with
    ``write`` writes; without TP a rank without ``write`` does nothing."""
    if not write and state.model_group is None:
        return path
    full = full_state(state)
    if not write:
        return path
    os.makedirs(path, exist_ok=True)
    torch.save(full["model"], os.path.join(path, "generative_model.npy"))
    if ema_decay > 0:
        torch.save(full["ema"], os.path.join(path, "generative_model_ema.npy"))
    torch.save(full["optim"], os.path.join(path, "optim.npy"))
    torch.save({"step": full["step"], "clip": full["clip"]}, os.path.join(path, TRAIN_STATE))
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
    load is strict); under TP each rank keeps its rows of the sharded
    parameters' EMA and moments (the model's own rows share its storage).
    Without ``train_state.npy`` the clip and the step start fresh, with one
    warning."""
    from geoldm_tpu_torch.train import train_step as ts

    global _FRESH_CLIP_WARNED
    state.model.load_state_dict(_load(path, "generative_model.npy"), strict=True)
    if state.ema_model is not state.model:
        ema = os.path.join(path, "generative_model_ema.npy")
        if not os.path.exists(ema):
            raise FileNotFoundError(f"{ema} is missing: the run trains with EMA, and the "
                                    "checkpoint was written without it (--ema_decay 0)")
        ts.load_ema_state_dict(state, _load(path, "generative_model_ema.npy"))
    ts.load_optimizer_state(state, _load(path, "optim.npy"))
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
