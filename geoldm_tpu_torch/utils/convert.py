"""Weight carry-over between the JAX package, upstream GeoLDM checkpoints and
the port (port of ``geoldm_tpu/utils/torch_convert.py:172-376``).

- ``state_dict_from_jax_params``: a JAX param pytree, as numpy arrays with
  scan-stacked blocks, -> the port's upstream-layout state dict, for every
  model kind (the plain diffusion model, the VAE, the latent diffusion
  model), either noise schedule (the table, or the learned gamma network's
  ``gamma.l{1,2,3}``, ``gamma.gamma_{0,1}``) and either dynamics mode
  (``dynamics.egnn.`` or the GNN's ``dynamics.gnn.``); conditional models
  too, whose embeddings are wider by the context. ``gnn_state_dict`` and
  ``legacy_egnn_state_dict`` convert the standalone GNN and legacy EGNN.
- ``classifier_state_dict_from_jax_params``: the JAX property classifier's
  params -> ``models.classifier.PropertyClassifier``'s state dict.
- ``model_config_from_reference_args`` / ``reference_args_from_model_config``:
  the pickled upstream ``args`` namespace <-> ``ModelConfig``
  (``checkpoint_kind`` tells the three kinds apart). Upstream has no field
  for the classifier-free guidance indicator channel, so the port writes
  ``context_indicator`` beside ``context_node_nf`` (the property count) and
  reads it with default False.
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


def _at(p: Dict[str, Any], i: int) -> Dict[str, np.ndarray]:
    """Layer i of a scan-stacked linear layer."""
    return {k: np.asarray(v)[i] for k, v in p.items()}


def _egnn_out(out, prefix: str, egnn: Dict[str, Any], attention: bool) -> None:
    _lin_out(out, prefix + "embedding", egnn["embedding"])
    _lin_out(out, prefix + "embedding_out", egnn["embedding_out"])
    blocks = egnn["blocks"]
    n_layers = np.asarray(blocks["coord_mlp"][0]["w"]).shape[0]
    for i in range(n_layers):
        bp = f"{prefix}e_block_{i}."
        for j, g in enumerate(blocks["gcls"]):
            gp = f"{bp}gcl_{j}."
            _lin_out(out, gp + "edge_mlp.0", _at(g["edge_mlp"][0], i))
            _lin_out(out, gp + "edge_mlp.2", _at(g["edge_mlp"][1], i))
            _lin_out(out, gp + "node_mlp.0", _at(g["node_mlp"][0], i))
            _lin_out(out, gp + "node_mlp.2", _at(g["node_mlp"][1], i))
            if attention:
                _lin_out(out, gp + "att_mlp.0", _at(g["att_mlp"], i))
        for k, idx in enumerate((0, 2, 4)):
            _lin_out(out, f"{bp}gcl_equiv.coord_mlp.{idx}", _at(blocks["coord_mlp"][k], i))


def _stacked_layers_out(out, prefix: str, params: Dict[str, Any], mlps) -> None:
    """``embedding``, ``embedding_out`` and ``gcl_{i}.<mlp>.{0,2}`` (and
    ``att_mlp.0`` when present) of a network whose layers JAX stacks under
    ``gcls`` (the GNN's and the legacy EGNN's layout)."""
    _lin_out(out, prefix + "embedding", params["embedding"])
    _lin_out(out, prefix + "embedding_out", params["embedding_out"])
    gcls = params["gcls"]
    if gcls is None:
        return
    for i in range(np.asarray(gcls["edge_mlp"][0]["w"]).shape[0]):
        for name in mlps:
            _lin_out(out, f"{prefix}gcl_{i}.{name}.0", _at(gcls[name][0], i))
            _lin_out(out, f"{prefix}gcl_{i}.{name}.2", _at(gcls[name][1], i))
        if "att_mlp" in gcls:
            _lin_out(out, f"{prefix}gcl_{i}.att_mlp.0", _at(gcls["att_mlp"], i))


def _tensors(out: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}


def gnn_state_dict(params_np: Dict[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX ``gnn_init`` params -> ``nn.egnn.GNN``'s state dict (upstream
    egnn_new.py's names)."""
    out: Dict[str, np.ndarray] = {}
    _stacked_layers_out(out, prefix, params_np, ("edge_mlp", "node_mlp"))
    return _tensors(out)


def legacy_egnn_state_dict(params_np: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``legacy_egnn_init`` params -> ``nn.egnn_legacy.LegacyEGNN``'s
    state dict (upstream egnn/egnn.py's names)."""
    out: Dict[str, np.ndarray] = {}
    _stacked_layers_out(out, "", params_np, ("edge_mlp", "node_mlp", "coord_mlp"))
    return _tensors(out)


def state_dict_from_jax_params(params_np: Dict[str, Any], model_cfg: ModelConfig
                               ) -> Dict[str, torch.Tensor]:
    """JAX params (numpy leaves) of any model kind -> upstream-layout state
    dict, including the fixed gamma table (or the learned gamma network) and
    the dummy buffers (torch_convert.py:209-248)."""
    out: Dict[str, np.ndarray] = {}
    if model_cfg.kind in ("diffusion", "latent_diffusion"):
        d = model_cfg.diffusion
        out["buffer"] = np.zeros(1, dtype=np.float32)
        if d.noise_schedule == "learned":
            g = params_np["gamma"]
            for name in ("l1", "l2", "l3"):
                _lin_out(out, f"gamma.{name}", g[name])
            out["gamma.gamma_0"] = np.asarray(g["gamma_0"])
            out["gamma.gamma_1"] = np.asarray(g["gamma_1"])
        else:
            out["gamma.gamma"] = gamma_table(d.noise_schedule, d.timesteps,
                                             d.noise_precision).astype(np.float32)
        dyn = params_np["dynamics"]
        if model_cfg.dynamics.mode == "gnn_dynamics":
            _stacked_layers_out(out, "dynamics.gnn.", dyn["gnn"], ("edge_mlp", "node_mlp"))
        else:
            _egnn_out(out, "dynamics.egnn.", dyn["egnn"], model_cfg.dynamics.egnn.attention)
    if model_cfg.kind in ("vae", "latent_diffusion"):
        vp = "vae." if model_cfg.kind == "latent_diffusion" else ""
        vae = params_np["vae"] if model_cfg.kind == "latent_diffusion" else params_np
        vcfg = model_cfg.vae
        out[vp + "buffer"] = np.zeros(1, dtype=np.float32)
        _egnn_out(out, vp + "encoder.egnn.", vae["encoder"]["egnn"],
                  vcfg.encoder_egnn.attention)
        _lin_out(out, vp + "encoder.final_mlp.0", vae["encoder"]["final_mlp"][0])
        _lin_out(out, vp + "encoder.final_mlp.2", vae["encoder"]["final_mlp"][1])
        _egnn_out(out, vp + "decoder.egnn.", vae["decoder"]["egnn"],
                  vcfg.decoder_egnn.attention)
    if not out:
        raise ValueError(f"unknown model kind {model_cfg.kind!r}")
    return _tensors(out)


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
        for i in range(np.asarray(gcls["edge_mlp"][0]["w"]).shape[0]):
            for name in ("edge_mlp", "node_mlp"):
                _lin_out(out, f"gcl_{i}.{name}.0", _at(gcls[name][0], i))
                _lin_out(out, f"gcl_{i}.{name}.2", _at(gcls[name][1], i))
            if "att_mlp" in gcls:
                _lin_out(out, f"gcl_{i}.att_mlp.0", _at(gcls["att_mlp"], i))
        for name in ("node_dec", "graph_dec"):
            _lin_out(out, f"{name}.0", params_np[name][0])
            _lin_out(out, f"{name}.2", params_np[name][1])
    return _tensors(out)


# The fields of an upstream ``args`` namespace that define the model (what
# ``model_config_from_reference_args`` reads), with ``conditioning``: the
# property names behind ``context_node_nf``.
MODEL_ARGS = ("include_charges", "context_node_nf", "context_indicator", "conditioning", "nf",
              "n_layers", "latent_nf", "kl_weight", "attention", "tanh", "norm_constant",
              "inv_sublayers", "sin_embedding", "normalization_factor", "aggregation_method",
              "train_diffusion", "condition_time", "trainable_ae", "diffusion_steps",
              "diffusion_noise_schedule", "diffusion_noise_precision", "diffusion_loss_type",
              "normalize_factors", "model", "probabilistic_model")


def checkpoint_kind(args: Any) -> str:
    """The model kind an upstream ``args`` namespace describes. GeoLDM's
    (main_qm9.py) always has ``train_diffusion``: a latent diffusion model
    when set, else a first-stage VAE. EDM's (the plain E(n) diffusion model)
    has no such field and ``probabilistic_model='diffusion'``. A namespace
    with neither stays a VAE, as it always loaded."""
    if hasattr(args, "train_diffusion"):
        return "latent_diffusion" if args.train_diffusion else "vae"
    if getattr(args, "probabilistic_model", None) == "diffusion":
        return "diffusion"
    return "vae"


def model_config_from_reference_args(args: Any, dataset_info) -> ModelConfig:
    """Pickled upstream argparse namespace -> ModelConfig of the kind
    ``checkpoint_kind`` reads, with the back-compat defaults of
    qm9/models.py:112-116. ``context_node_nf`` is the property count;
    ``context_indicator`` (the port's field, default False) adds the
    indicator channel."""
    g = lambda name, default: getattr(args, name, default)  # noqa: E731
    common = dict(
        include_charges=g("include_charges", True),
        context_node_nf=g("context_node_nf", 0),
        context_indicator=bool(g("context_indicator", False)),
        nf=g("nf", 256), n_layers=g("n_layers", 9), attention=g("attention", True),
        tanh=g("tanh", True), norm_constant=g("norm_constant", 1.0),
        inv_sublayers=g("inv_sublayers", 1), sin_embedding=g("sin_embedding", False),
        normalization_factor=g("normalization_factor", 1),
        aggregation_method=g("aggregation_method", "sum"))
    kind = checkpoint_kind(args)
    if kind == "vae":
        return factory.make_vae_config(dataset_info, latent_nf=g("latent_nf", 1),
                                       kl_weight=g("kl_weight", 0.01), **common)
    diffusion = dict(
        condition_time=g("condition_time", True), diffusion_steps=g("diffusion_steps", 1000),
        noise_schedule=g("diffusion_noise_schedule", "polynomial_2"),
        noise_precision=g("diffusion_noise_precision", 1e-5),
        loss_type=g("diffusion_loss_type", "l2"),
        normalize_factors=tuple(g("normalize_factors", (1.0, 4.0, 10.0))),
        model=g("model", "egnn_dynamics"))
    if kind == "diffusion":
        return factory.make_diffusion_model_config(dataset_info, **common, **diffusion)
    return factory.make_latent_diffusion_config(
        dataset_info, **common, **diffusion, latent_nf=g("latent_nf", 1),
        kl_weight=g("kl_weight", 0.01), trainable_ae=g("trainable_ae", False))


def reference_args_from_model_config(model_cfg: ModelConfig, dataset: str = "qm9",
                                     remove_h: bool = False, ema_decay: float = 0.9999,
                                     conditioning=()) -> argparse.Namespace:
    """ModelConfig -> the upstream ``args.pickle`` namespace of a generative
    model (torch_convert.py:251-335): GeoLDM's shape for a latent diffusion
    model, EDM's for the plain kind (no ``train_diffusion``, no VAE fields;
    ``checkpoint_kind``). ``conditioning`` names its properties, one per
    property channel, and ``context_indicator`` records the guidance
    indicator channel."""
    from geoldm_tpu_torch.train.conditioning import property_channels

    if model_cfg.kind not in ("diffusion", "latent_diffusion"):
        raise ValueError(f"{model_cfg.kind} is not a generative model")
    e, d = model_cfg.dynamics.egnn, model_cfg.diffusion
    n_props = property_channels(model_cfg)
    if len(conditioning) != n_props:
        raise ValueError(f"the model has {n_props} property channel(s); conditioning names "
                         f"{len(conditioning)}: {list(conditioning)}")
    ns = argparse.Namespace(
        dataset=dataset, remove_h=remove_h, conditioning=list(conditioning),
        cuda=False, ema_decay=float(ema_decay), include_charges=model_cfg.include_charges,
        context_node_nf=n_props, context_indicator=model_cfg.context_indicator,
        nf=e.hidden_nf, n_layers=e.n_layers, attention=e.attention, tanh=e.tanh,
        norm_constant=e.norm_constant, inv_sublayers=e.inv_sublayers,
        sin_embedding=e.sin_embedding, normalization_factor=e.normalization_factor,
        aggregation_method=e.aggregation_method, model=model_cfg.dynamics.mode,
        probabilistic_model="diffusion", condition_time=model_cfg.dynamics.condition_time,
        diffusion_steps=d.timesteps, diffusion_noise_schedule=d.noise_schedule,
        diffusion_noise_precision=d.noise_precision, diffusion_loss_type=d.loss_type,
        normalize_factors=tuple(d.norm_values),
    )
    if model_cfg.kind == "latent_diffusion":
        vae = model_cfg.vae
        ns.ae_path, ns.latent_nf, ns.kl_weight = None, vae.latent_nf, vae.kl_weight
        ns.train_diffusion, ns.trainable_ae = True, model_cfg.trainable_ae
    return ns


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
