"""Weight carry-over between the JAX package, upstream GeoLDM checkpoints and
the port (port of ``geoldm_tpu/utils/torch_convert.py:172-376``).

- ``state_dict_from_jax_params``: a JAX param pytree, as numpy arrays with
  scan-stacked blocks, -> the port's upstream-layout state dict
  (conditional models too: their embeddings are wider by the context).
- ``classifier_state_dict_from_jax_params``: the JAX property classifier's
  params -> ``models.classifier.PropertyClassifier``'s state dict.
- ``model_config_from_reference_args`` / ``reference_args_from_model_config``:
  the pickled upstream ``args`` namespace <-> ``ModelConfig``. Upstream
  has no field for the classifier-free guidance indicator channel, so the
  port writes ``context_indicator`` beside ``context_node_nf`` (the
  property count) and reads it with default False.
- ``load_reference_checkpoint`` / ``save_reference_checkpoint``: the upstream
  checkpoint directory (``args.pickle`` + ``generative_model[_ema].npy``,
  a ``torch.save``d state dict), as ``geoldm_tpu.cli.export_torch_checkpoint``
  writes it and released GeoLDM models ship it.
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Any, Dict

import numpy as np
import torch

from geoldm_tpu_torch.config import ModelConfig
from geoldm_tpu_torch.data.datasets_config import get_dataset_info
from geoldm_tpu_torch.diffusion.schedules import gamma_table
from geoldm_tpu_torch.models import factory


def _lin_out(out: Dict[str, np.ndarray], prefix: str, p: Dict[str, Any]) -> None:
    out[prefix + ".weight"] = np.ascontiguousarray(np.asarray(p["w"]).T)
    if "b" in p:
        out[prefix + ".bias"] = np.asarray(p["b"])


def _egnn_out(out, prefix: str, egnn: Dict[str, Any], attention: bool) -> None:
    _lin_out(out, prefix + "embedding", egnn["embedding"])
    _lin_out(out, prefix + "embedding_out", egnn["embedding_out"])
    blocks = egnn["blocks"]
    n_layers = np.asarray(blocks["coord_mlp"][0]["w"]).shape[0]
    at = lambda p, i: {k: np.asarray(v)[i] for k, v in p.items()}  # noqa: E731
    for i in range(n_layers):
        bp = f"{prefix}e_block_{i}."
        for j, g in enumerate(blocks["gcls"]):
            gp = f"{bp}gcl_{j}."
            _lin_out(out, gp + "edge_mlp.0", at(g["edge_mlp"][0], i))
            _lin_out(out, gp + "edge_mlp.2", at(g["edge_mlp"][1], i))
            _lin_out(out, gp + "node_mlp.0", at(g["node_mlp"][0], i))
            _lin_out(out, gp + "node_mlp.2", at(g["node_mlp"][1], i))
            if attention:
                _lin_out(out, gp + "att_mlp.0", at(g["att_mlp"], i))
        for k, idx in enumerate((0, 2, 4)):
            _lin_out(out, f"{bp}gcl_equiv.coord_mlp.{idx}", at(blocks["coord_mlp"][k], i))


def state_dict_from_jax_params(params_np: Dict[str, Any], model_cfg: ModelConfig
                               ) -> Dict[str, torch.Tensor]:
    """JAX latent-diffusion params (numpy leaves) -> upstream-layout state
    dict, including the fixed gamma table and the dummy buffers."""
    if model_cfg.kind != "latent_diffusion":
        raise NotImplementedError(f"model kind {model_cfg.kind!r} is not ported yet")
    d = model_cfg.diffusion
    if d.noise_schedule == "learned":
        raise NotImplementedError("the learned gamma schedule is not ported yet")
    out: Dict[str, np.ndarray] = {
        "buffer": np.zeros(1, dtype=np.float32),
        "gamma.gamma": gamma_table(d.noise_schedule, d.timesteps,
                                   d.noise_precision).astype(np.float32),
    }
    _egnn_out(out, "dynamics.egnn.", params_np["dynamics"]["egnn"],
              model_cfg.dynamics.egnn.attention)
    vae, vcfg = params_np["vae"], model_cfg.vae
    out["vae.buffer"] = np.zeros(1, dtype=np.float32)
    _egnn_out(out, "vae.encoder.egnn.", vae["encoder"]["egnn"], vcfg.encoder_egnn.attention)
    _lin_out(out, "vae.encoder.final_mlp.0", vae["encoder"]["final_mlp"][0])
    _lin_out(out, "vae.encoder.final_mlp.2", vae["encoder"]["final_mlp"][1])
    _egnn_out(out, "vae.decoder.egnn.", vae["decoder"]["egnn"], vcfg.decoder_egnn.attention)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}


def classifier_state_dict_from_jax_params(params_np: Dict[str, Any], model_name: str = "egnn"
                                          ) -> Dict[str, torch.Tensor]:
    """JAX property-classifier params (``geoldm_tpu/models/classifier.py``,
    numpy leaves, scan-stacked layers) -> the state dict of
    ``models.classifier.PropertyClassifier`` (``egnn``) or of its baselines
    (``naive``, ``numnodes``)."""
    out: Dict[str, np.ndarray] = {}
    if model_name == "naive":
        _lin_out(out, "linear", params_np["linear"])
    elif model_name == "numnodes":
        _lin_out(out, "linear1", params_np["l1"])
        _lin_out(out, "linear2", params_np["l2"])
    else:
        _lin_out(out, "embedding", params_np["embedding"])
        gcls = params_np["gcls"]
        n_layers = np.asarray(gcls["edge_mlp"][0]["w"]).shape[0]
        at = lambda p, i: {k: np.asarray(v)[i] for k, v in p.items()}  # noqa: E731
        for i in range(n_layers):
            for name in ("edge_mlp", "node_mlp"):
                _lin_out(out, f"gcl_{i}.{name}.0", at(gcls[name][0], i))
                _lin_out(out, f"gcl_{i}.{name}.2", at(gcls[name][1], i))
            if "att_mlp" in gcls:
                _lin_out(out, f"gcl_{i}.att_mlp.0", at(gcls["att_mlp"], i))
        for name in ("node_dec", "graph_dec"):
            _lin_out(out, f"{name}.0", params_np[name][0])
            _lin_out(out, f"{name}.2", params_np[name][1])
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}


# The fields of an upstream ``args`` namespace that define the model (what
# ``model_config_from_reference_args`` reads), with ``conditioning``: the
# property names behind ``context_node_nf``.
MODEL_ARGS = ("include_charges", "context_node_nf", "context_indicator", "conditioning", "nf",
              "n_layers", "latent_nf", "kl_weight", "attention", "tanh", "norm_constant",
              "inv_sublayers", "sin_embedding", "normalization_factor", "aggregation_method",
              "train_diffusion", "condition_time", "trainable_ae", "diffusion_steps",
              "diffusion_noise_schedule", "diffusion_noise_precision", "diffusion_loss_type",
              "normalize_factors", "model")


def model_config_from_reference_args(args: Any, dataset_info) -> ModelConfig:
    """Pickled upstream argparse namespace -> ModelConfig, with the
    back-compat defaults of qm9/models.py:112-116. ``context_node_nf`` is
    the property count; ``context_indicator`` (the port's field, default
    False) adds the indicator channel."""
    g = lambda name, default: getattr(args, name, default)  # noqa: E731
    common = dict(
        include_charges=g("include_charges", True),
        context_node_nf=g("context_node_nf", 0),
        context_indicator=bool(g("context_indicator", False)),
        nf=g("nf", 256), n_layers=g("n_layers", 9), latent_nf=g("latent_nf", 1),
        kl_weight=g("kl_weight", 0.01), attention=g("attention", True),
        tanh=g("tanh", True), norm_constant=g("norm_constant", 1.0),
        inv_sublayers=g("inv_sublayers", 1), sin_embedding=g("sin_embedding", False),
        normalization_factor=g("normalization_factor", 1),
        aggregation_method=g("aggregation_method", "sum"))
    if not g("train_diffusion", False):  # a first-stage VAE checkpoint
        return factory.make_vae_config(dataset_info, **common)
    return factory.make_latent_diffusion_config(
        dataset_info, **common,
        condition_time=g("condition_time", True), trainable_ae=g("trainable_ae", False),
        diffusion_steps=g("diffusion_steps", 1000),
        noise_schedule=g("diffusion_noise_schedule", "polynomial_2"),
        noise_precision=g("diffusion_noise_precision", 1e-5),
        loss_type=g("diffusion_loss_type", "l2"),
        normalize_factors=tuple(g("normalize_factors", (1.0, 4.0, 10.0))),
        model=g("model", "egnn_dynamics"),
    )


def reference_args_from_model_config(model_cfg: ModelConfig, dataset: str = "qm9",
                                     remove_h: bool = False, ema_decay: float = 0.9999,
                                     conditioning=()) -> argparse.Namespace:
    """ModelConfig -> the upstream ``args.pickle`` namespace of a
    latent-diffusion model (torch_convert.py:251-335): ``conditioning`` names
    its properties, one per property channel, and ``context_indicator``
    records the guidance indicator channel."""
    from geoldm_tpu_torch.train.conditioning import property_channels

    e, vae, d = model_cfg.dynamics.egnn, model_cfg.vae, model_cfg.diffusion
    n_props = property_channels(model_cfg)
    if len(conditioning) != n_props:
        raise ValueError(f"the model has {n_props} property channel(s); conditioning names "
                         f"{len(conditioning)}: {list(conditioning)}")
    return argparse.Namespace(
        dataset=dataset, remove_h=remove_h, conditioning=list(conditioning), ae_path=None,
        cuda=False, ema_decay=float(ema_decay), include_charges=vae.include_charges,
        context_node_nf=n_props, context_indicator=model_cfg.context_indicator,
        nf=e.hidden_nf,
        n_layers=e.n_layers, latent_nf=vae.latent_nf, kl_weight=vae.kl_weight,
        attention=e.attention, tanh=e.tanh, norm_constant=e.norm_constant,
        inv_sublayers=e.inv_sublayers, sin_embedding=e.sin_embedding,
        normalization_factor=e.normalization_factor,
        aggregation_method=e.aggregation_method, train_diffusion=True,
        trainable_ae=model_cfg.trainable_ae, model=model_cfg.dynamics.mode,
        probabilistic_model="diffusion", condition_time=model_cfg.dynamics.condition_time,
        diffusion_steps=d.timesteps, diffusion_noise_schedule=d.noise_schedule,
        diffusion_noise_precision=d.noise_precision, diffusion_loss_type=d.loss_type,
        normalize_factors=tuple(d.norm_values),
    )


def save_reference_checkpoint(model, path: str, dataset: str = "qm9",
                              remove_h: bool = False, conditioning=()) -> None:
    """Write ``args.pickle`` + ``generative_model[_ema].npy`` (the same
    weights in both, as an export of EMA-free weights would be);
    ``conditioning`` names a conditional model's properties."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "args.pickle"), "wb") as f:
        pickle.dump(reference_args_from_model_config(model.cfg, dataset, remove_h,
                                                     conditioning=conditioning), f)
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    for name in ("generative_model.npy", "generative_model_ema.npy"):
        torch.save(sd, os.path.join(path, name))


def load_reference_checkpoint(path: str, device="cuda", use_ema: bool = True):
    """Upstream checkpoint directory -> (model on ``device``, ModelConfig,
    args namespace). ``args.pickle`` is unpickled: load only checkpoints
    you trust, as with upstream GeoLDM itself."""
    with open(os.path.join(path, "args.pickle"), "rb") as f:
        args = pickle.load(f)
    info = get_dataset_info(getattr(args, "dataset", "qm9"), getattr(args, "remove_h", False))
    cfg = model_config_from_reference_args(args, info)
    name = "generative_model_ema.npy" if use_ema else "generative_model.npy"
    if use_ema and not os.path.exists(os.path.join(path, name)):
        name = "generative_model.npy"  # trained without EMA (ema_decay = 0)
    sd = torch.load(os.path.join(path, name), map_location="cpu", weights_only=True)
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    model = factory.build_model(cfg, device)
    model.load_state_dict(sd, strict=True)
    return model, cfg, args
