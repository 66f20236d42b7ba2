"""Typed model configuration (port of ``geoldm_tpu/config.py:20-272``).

The same frozen dataclasses and the same JSON serde as the JAX package, so
a ``config.json`` written by either package loads in the other. Only the
model-side classes are copied; data/train configs belong to later slices.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class EGNNConfig:
    """Architecture of one dense-masked EGNN stack
    (reference: egnn/egnn_new.py:150-182)."""

    in_node_nf: int
    out_node_nf: int
    hidden_nf: int = 256
    n_layers: int = 9
    inv_sublayers: int = 1
    attention: bool = True
    tanh: bool = True
    coords_range: float = 15.0
    norm_constant: float = 1.0
    sin_embedding: bool = False
    normalization_factor: float = 1.0
    aggregation_method: str = "sum"  # 'sum' (divide by normalization_factor) | 'mean'
    remat: bool = False  # JAX-side training option; no effect in the port

    @property
    def coords_range_layer(self) -> float:
        # The reference computes coords_range/n_layers (egnn_new.py:160) but
        # passes the UNDIVIDED coords_range to every EquivariantBlock
        # (egnn_new.py:175-181), so the per-block tanh multiplier is the
        # full value.
        return float(self.coords_range)

    @property
    def edge_feat_nf(self) -> int:
        # Distance features of the current and of the initial coordinates
        # (reference: egnn/egnn_new.py:139, :184-191).
        if self.sin_embedding:
            from geoldm_tpu_torch.ops.distance import SIN_EMBEDDING_DIM

            return 2 * SIN_EMBEDDING_DIM
        return 2


@dataclass(frozen=True)
class DynamicsConfig:
    """The denoiser wrapper (reference: egnn/models.py:8-47)."""

    in_node_nf: int
    context_node_nf: int = 0
    n_dims: int = 3
    condition_time: bool = True
    mode: str = "egnn_dynamics"
    egnn: EGNNConfig = None  # type: ignore[assignment]


@dataclass(frozen=True)
class VAEConfig:
    """First-stage E(n) VAE (reference: en_diffusion.py:858-1048)."""

    in_node_nf: int
    latent_nf: int = 1
    n_dims: int = 3
    kl_weight: float = 0.01
    include_charges: bool = True
    encoder_egnn: EGNNConfig = None  # type: ignore[assignment]
    decoder_egnn: EGNNConfig = None  # type: ignore[assignment]
    context_node_nf: int = 0
    encoder_sigma: float = 0.0032

    @property
    def num_classes(self) -> int:
        return self.in_node_nf - int(self.include_charges)


@dataclass(frozen=True)
class DiffusionConfig:
    """E(n) variational diffusion (reference: en_diffusion.py:254-296)."""

    in_node_nf: int
    n_dims: int = 3
    timesteps: int = 1000
    noise_schedule: str = "polynomial_2"
    noise_precision: float = 1e-5
    loss_type: str = "l2"
    norm_values: Tuple[float, float, float] = (1.0, 4.0, 10.0)
    norm_biases: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    include_charges: bool = True
    parametrization: str = "eps"

    @property
    def num_classes(self) -> int:
        return self.in_node_nf - int(self.include_charges)


@dataclass(frozen=True)
class ModelConfig:
    """Top-level generative model (reference factories: qm9/models.py)."""

    kind: str = "latent_diffusion"  # 'diffusion' | 'vae' | 'latent_diffusion'
    diffusion: Optional[DiffusionConfig] = None
    dynamics: Optional[DynamicsConfig] = None
    vae: Optional[VAEConfig] = None
    trainable_ae: bool = False
    context_indicator: bool = False

    @property
    def include_charges(self) -> bool:
        """Whether the data carries the charge channel: the VAE's flag, or
        the plain diffusion model's."""
        return (self.vae if self.vae is not None else self.diffusion).include_charges


_CONFIG_TYPES = {
    cls.__name__: cls
    for cls in (EGNNConfig, DynamicsConfig, VAEConfig, DiffusionConfig, ModelConfig)
}


def to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        out = {"__type__": type(cfg).__name__}
        for f in dataclasses.fields(cfg):
            out[f.name] = to_dict(getattr(cfg, f.name))
        return out
    if isinstance(cfg, tuple):
        return {"__tuple__": [to_dict(v) for v in cfg]}
    if isinstance(cfg, list):
        return [to_dict(v) for v in cfg]
    return cfg


def from_dict(obj: Any) -> Any:
    if isinstance(obj, dict) and "__type__" in obj:
        cls = _CONFIG_TYPES[obj["__type__"]]
        kwargs = {k: from_dict(v) for k, v in obj.items() if k != "__type__"}
        known = {f.name for f in dataclasses.fields(cls)}
        # Forward compatibility: ignore unknown fields from newer configs.
        return cls(**{k: v for k, v in kwargs.items() if k in known})
    if isinstance(obj, dict) and "__tuple__" in obj:
        return tuple(from_dict(v) for v in obj["__tuple__"])
    if isinstance(obj, list):
        return [from_dict(v) for v in obj]
    return obj


def dumps(cfg: Any, **kwargs: Any) -> str:
    kwargs.setdefault("indent", 2)
    return json.dumps(to_dict(cfg), **kwargs)


def loads(s: str) -> Any:
    return from_dict(json.loads(s))
