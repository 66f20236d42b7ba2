"""Analytic matmul-FLOP accounting for the EGNN models, and MFU (port of
``geoldm_tpu/utils/flops.py``; the counts are JAX's integers).

Conventions (the usual MFU accounting, as JAX's):
- only matrix-product FLOPs count (2*m*k*n per [m,k]x[k,n] product);
  elementwise work (silu, sigmoid, tanh over the [B,N,N,H] edge grid) is
  left out, though it is a large share of this model's time;
- a backward is twice the forward; recomputation is not counted (model
  FLOPs, not hardware FLOPs);
- the peak is the card's dense bf16 tensor-core peak whatever the run's
  dtype, so numbers compare across dtypes.

JAX's table of TPU peaks does not carry over: the port's is keyed by
``torch.cuda.get_device_name()``.
"""

from __future__ import annotations

from typing import Optional

from geoldm_tpu_torch.config import EGNNConfig, ModelConfig

# Dense bf16 tensor-core peak FLOP/s by the name torch.cuda.get_device_name()
# gives: the H100 SXM ("NVIDIA H100 80GB HBM3") 989 TFLOP/s, from NVIDIA's
# data sheet (PERF.md §3's device row).
_PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def device_peak_flops(device_name: str) -> Optional[float]:
    """The dense bf16 peak FLOP/s of a card by its name, or None for an
    unknown name and for the CPU."""
    for key, peak in sorted(_PEAK_FLOPS.items(), key=lambda kv: -len(kv[0])):
        if device_name.startswith(key):
            return peak
    return None


def egnn_flops(cfg: EGNNConfig, n: int) -> int:
    """Matmul FLOPs of one EGNN forward for ONE molecule padded to n nodes.

    The first edge-MLP layer counts as two [N,H]x[H,H] node-side products
    plus one [N^2,E]x[E,H] edge-feature product, as the kernels compute it
    (the concatenation is never formed), so its cost is O(N H^2), not
    O(N^2 H^2).
    """
    h = cfg.hidden_nf
    e = cfg.edge_feat_nf
    n2 = n * n

    def pair_first_layer() -> int:
        # src + dst [N,H]x[H,H] matmuls + [N^2,E]x[E,H] edge features.
        return 2 * (2 * n * h * h) + 2 * n2 * e * h

    gcl = (
        pair_first_layer()
        + 2 * n2 * h * h  # second edge-MLP layer [N^2,H]x[H,H]
        + (2 * n2 * h if cfg.attention else 0)  # attention gate [N^2,H]x[H,1]
        + 2 * n * (2 * h) * h  # node MLP layer 1 [N,2H]x[2H,H]
        + 2 * n * h * h  # node MLP layer 2
    )
    coord = (
        pair_first_layer()
        + 2 * n2 * h * h  # coord MLP layer 2
        + 2 * n2 * h  # coord MLP layer 3 [N^2,H]x[H,1]
    )
    block = cfg.inv_sublayers * gcl + coord
    embed = 2 * n * cfg.in_node_nf * h + 2 * n * h * cfg.out_node_nf
    return embed + cfg.n_layers * block


def _dynamics_flops(model_cfg: ModelConfig, n: int) -> int:
    return egnn_flops(model_cfg.dynamics.egnn, n)


def sample_flops(model_cfg: ModelConfig, n: int) -> int:
    """Matmul FLOPs to generate ONE molecule at pad n through the full
    reverse process: T denoiser calls (+1 for the t=0 projection) plus, for
    latent diffusion, one VAE decode."""
    t = model_cfg.diffusion.timesteps if model_cfg.diffusion else 0
    total = (t + 1) * _dynamics_flops(model_cfg, n)
    if model_cfg.kind == "latent_diffusion":
        total += egnn_flops(model_cfg.vae.decoder_egnn, n)
    return total


def forward_flops(model_cfg: ModelConfig, n: int) -> int:
    """Matmul FLOPs of one training-loss forward for ONE molecule at pad n."""
    kind = model_cfg.kind
    if kind == "diffusion":
        return _dynamics_flops(model_cfg, n)
    if kind == "vae":
        return egnn_flops(model_cfg.vae.encoder_egnn, n) + egnn_flops(
            model_cfg.vae.decoder_egnn, n
        )
    if kind == "latent_diffusion":
        total = egnn_flops(model_cfg.vae.encoder_egnn, n) + _dynamics_flops(
            model_cfg, n
        )
        if model_cfg.trainable_ae:
            total += egnn_flops(model_cfg.vae.decoder_egnn, n)
        return total
    raise ValueError(kind)


def train_step_flops(model_cfg: ModelConfig, n: int) -> int:
    """Model FLOPs of one train step for ONE molecule: forward + 2x
    backward (recomputation not counted)."""
    return 3 * forward_flops(model_cfg, n)


def mfu(total_flops: float, seconds: float, device_name: str) -> Optional[float]:
    """Achieved model-FLOP/s over the card's bf16 peak; None for an unknown
    card and the CPU."""
    peak = device_peak_flops(device_name)
    if peak is None or seconds <= 0:
        return None
    return total_flops / seconds / peak
