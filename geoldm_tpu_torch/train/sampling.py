"""Sampling orchestration (port of ``geoldm_tpu/train/sampling.py:75-293``):
build masks on the host, run the sampler on the model's device, post-process.

Noise: ``sample`` takes a noise source; ``sample_bucketed`` gives every
chunk its own ``torch.Generator`` seeded from (request seed, chunk index),
so a seeded request replays exactly.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from geoldm_tpu_torch.data.collate import build_masks
from geoldm_tpu_torch.diffusion import latent as ldm_mod
from geoldm_tpu_torch.ops import com

DEFAULT_SAMPLE_BUCKETS = (16, 24, 32)  # QM9
# GEOM-Drugs (sizes up to 181 atoms, mean 46.6): buckets matched to the size
# histogram (sampling.py:162-167).
GEOM_SAMPLE_BUCKETS = (32, 48, 64, 96, 136, 184)


def default_buckets(dataset_info) -> tuple:
    """Per-dataset sampling buckets matched to the size histogram."""
    return GEOM_SAMPLE_BUCKETS if "geom" in dataset_info["name"] else DEFAULT_SAMPLE_BUCKETS


def chunk_generator(seed: int, chunk_index: int, device) -> torch.Generator:
    """The noise generator of one dispatched chunk of a request."""
    state = np.random.SeedSequence([int(seed) % 2**64, chunk_index]).generate_state(
        1, dtype=np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def sample(model, noise: com.Noise, dataset_info, nodesxsample: np.ndarray,
           fix_noise: bool = False, pad_nodes: Optional[int] = None):
    """Generate molecules with the requested atom counts (unconditional).
    Returns (one_hot, charges, x, node_mask): the first three are tensors on
    the model's device (still computing there), node_mask a numpy array."""
    max_n_nodes = pad_nodes or dataset_info["max_n_nodes"]
    nodesxsample = np.asarray(nodesxsample)
    if int(nodesxsample.max()) > max_n_nodes:
        raise ValueError(f"molecule of {int(nodesxsample.max())} atoms exceeds pad {max_n_nodes}")
    node_mask_np, _ = build_masks(nodesxsample, max_n_nodes)
    node_mask = torch.from_numpy(node_mask_np).to(_model_device(model))
    x, h_cat, h_int = ldm_mod.ldm_sample(model, noise, node_mask, fix_noise)
    return h_cat, h_int, x, node_mask_np


def sample_bucketed(model, seed: int, dataset_info, nodesxsample: np.ndarray,
                    batch_size: int = 128, buckets=DEFAULT_SAMPLE_BUCKETS,
                    fix_noise: bool = False):
    """Size-bucketed generation: molecules are grouped by atom count and
    each group is padded only to its bucket, in chunks of ``batch_size``.
    The last chunk of a bucket is padded (by repeating its last size) to the
    next power of two, at most ``batch_size``, and trimmed afterwards. (The
    JAX server pads every chunk to ``batch_size`` so one compiled shape
    serves each bucket; the port compiles nothing, so it keeps the smaller
    padding.) Returns arrays padded to the largest bucket, in the original
    molecule order. ``n_chunks`` counts the chunks it dispatches."""
    nodesxsample = np.asarray(nodesxsample)
    buckets = _aligned(buckets, nodesxsample)
    max_pad = buckets[-1]
    device = _model_device(model)
    m = len(nodesxsample)
    pending = []
    for chunk_index, (chunk, pad, sizes) in enumerate(
            _chunks(nodesxsample, batch_size, buckets)):
        gen = chunk_generator(seed, chunk_index, device)
        res = sample(model, gen, dataset_info, sizes, fix_noise=fix_noise, pad_nodes=pad)
        pending.append((chunk, pad, res))
    # Every chunk is queued on the card before the first copy to the host.
    s = len(dataset_info["atom_decoder"])
    out = None
    for chunk, pad, (one_hot, charges, x, node_mask) in pending:
        if out is None:
            out = (np.zeros((m, max_pad, s), dtype=np.float32),
                   np.zeros((m, max_pad, charges.shape[-1]), dtype=np.float32),
                   np.zeros((m, max_pad, 3), dtype=np.float32),
                   np.zeros((m, max_pad, 1), dtype=np.float32))
        n_real = len(chunk)
        for dst, src in zip(out, (one_hot, charges, x, node_mask)):
            src = src.cpu().numpy() if isinstance(src, torch.Tensor) else src
            dst[chunk, :pad] = src[:n_real]
    return out


def _aligned(buckets, nodesxsample) -> tuple:
    """Bucket boundaries rounded up to multiples of 8, topped to cover the
    largest molecule (sampling.py:225-228)."""
    buckets = tuple(sorted(set(-(-int(b) // 8) * 8 for b in buckets)))
    need = -(-int(np.max(nodesxsample)) // 8) * 8
    return buckets + (need,) if buckets[-1] < need else buckets


def _chunks(nodesxsample, batch_size, buckets):
    """Yield (indices, pad, padded sizes) per dispatched chunk."""
    for bi, pad in enumerate(buckets):
        lo = 0 if bi == 0 else buckets[bi - 1]
        idxs = np.where((nodesxsample > lo) & (nodesxsample <= pad))[0]
        for start in range(0, len(idxs), batch_size):
            chunk = idxs[start:start + batch_size]
            sizes = nodesxsample[chunk]
            n_real = len(sizes)
            if n_real < batch_size:
                bsz = min(1 << (n_real - 1).bit_length() if n_real > 1 else 1, batch_size)
                sizes = np.concatenate([sizes, np.full(bsz - n_real, sizes[-1], dtype=sizes.dtype)])
            yield chunk, pad, sizes


def chunk_pads(nodesxsample, batch_size: int, buckets=DEFAULT_SAMPLE_BUCKETS) -> list:
    """The pad of each chunk ``sample_bucketed`` dispatches for these sizes
    with these buckets (those the caller passes it), in dispatch order."""
    nodesxsample = np.asarray(nodesxsample)
    return [pad for _, pad, _ in _chunks(nodesxsample, batch_size,
                                         _aligned(buckets, nodesxsample))]


def n_chunks(nodesxsample, batch_size: int, buckets=DEFAULT_SAMPLE_BUCKETS) -> int:
    """How many chunks ``sample_bucketed`` dispatches for these sizes."""
    return len(chunk_pads(nodesxsample, batch_size, buckets))
