"""The yardstick's operation and byte counts of the EGNN work, and the
device peaks they are held to.

FLOPs: a frozen copy of the program's matrix-product count
(``geoldm_tpu_torch/utils/flops.py``, itself JAX's): 2*m*k*n per product,
elementwise work left out, a backward twice its forward. Here it is taken
at each molecule's true atom count, so padding counts as waste and the
number is the same whatever implements the work. Bytes: each EGNN block's
weights, node features and coordinates read once and its node features and
coordinates written once; a backward moves them again with their
gradients. A call's least time is the larger of its FLOPs over the peak
and its bytes over the bandwidth.
"""

from __future__ import annotations

from typing import Iterable

# NVIDIA H100 SXM data sheet, dense tensor-core rates and HBM3 bandwidth.
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}  # TF32; bf16
HBM_BYTES_PER_S = 3.35e12


def peak(precision: str) -> float:
    """The dense tensor-core peak of a cell's precision: TF32's for float32
    (the f32 kernels' split products run on it), bf16's for the bf16 names."""
    return PEAK_FLOPS["float32" if precision == "float32" else "bfloat16"]


def egnn_flops(e: dict, n: int) -> int:
    """Matrix-product FLOPs of one EGNN forward of one molecule of ``n``
    atoms (``utils/flops.py:egnn_flops``; ``e``: hidden, in_nf, out_nf,
    layers, attention; two edge features; one GCL a block)."""
    h, ef, n2 = e["hidden"], 2, n * n
    pair_first = 2 * (2 * n * h * h) + 2 * n2 * ef * h
    gcl = (pair_first + 2 * n2 * h * h + (2 * n2 * h if e["attention"] else 0)
           + 2 * n * (2 * h) * h + 2 * n * h * h)
    coord = pair_first + 2 * n2 * h * h + 2 * n2 * h
    embed = 2 * n * e["in_nf"] * h + 2 * n * h * e["out_nf"]
    return embed + e["layers"] * (gcl + coord)


def train_step_flops(M: dict, n: int) -> int:
    """``utils/flops.py:train_step_flops`` of a latent diffusion model with a
    trainable decoder: 3x the forward of the encoder, denoiser and decoder."""
    return 3 * (egnn_flops(M["encoder"], n) + egnn_flops(M["dynamics"], n)
                + egnn_flops(M["decoder"], n))


def useful_train_flops(M: dict, n: int) -> int:
    """The work a train step needs for one molecule: the encoder forward
    (its latent is detached, so it has no backward) and 3x the denoiser's
    and the decoder's forward."""
    return egnn_flops(M["encoder"], n) + 3 * (egnn_flops(M["dynamics"], n)
                                              + egnn_flops(M["decoder"], n))


def sample_flops(M: dict, n: int, n_steps: int) -> int:
    """One molecule sampled with ``n_steps`` jumps: n_steps + 1 denoiser
    forwards and one decode."""
    return (n_steps + 1) * egnn_flops(M["dynamics"], n) + egnn_flops(M["decoder"], n)


def block_weights(e: dict) -> int:
    """Parameters of one EGNN block: a GCL (edge MLP, attention gate, node
    MLP) and the coordinate update's MLP."""
    h = e["hidden"]
    first = (2 * h + 2) * h + h
    w = first + (h * h + h) + (2 * h * h + h) + (h * h + h) + first + (h * h + h) + h
    return w + (h + 1 if e["attention"] else 0)


def least_seconds(e: dict, sizes: Iterable[int], peak_flops: float,
                  backward: bool = False) -> float:
    """The least time one call of EGNN ``e`` over molecules of ``sizes`` can
    take: per block the larger of its FLOPs over the peak and its bytes over
    the bandwidth, plus the embeddings' FLOPs over the peak. With
    ``backward`` the call is a forward and its backward: three times the
    FLOPs, and the bytes again with their gradients (three times)."""
    sizes = [int(n) for n in sizes]
    if not sizes:
        return 0.0
    h = e["hidden"]
    blk = dict(e, layers=1)
    base = dict(e, layers=0)
    f_blk = sum(egnn_flops(blk, n) - egnn_flops(base, n) for n in sizes)
    f_emb = sum(egnn_flops(base, n) for n in sizes)
    b_blk = 4 * (block_weights(e) + sum(2 * (n * h + 3 * n) for n in sizes))
    k = 3 if backward else 1
    per_block = max(k * f_blk / peak_flops, k * b_blk / HBM_BYTES_PER_S)
    return e["layers"] * per_block + k * f_emb / peak_flops
