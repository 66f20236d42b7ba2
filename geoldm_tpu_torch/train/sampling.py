"""Sampling orchestration (port of ``geoldm_tpu/train/sampling.py:27-361``):
build masks on the host, run the sampler on the model's device, post-process.

Noise: ``sample`` takes a noise source; ``sample_bucketed`` gives every
chunk its own ``torch.Generator`` seeded from (request seed, chunk index),
so a seeded request replays exactly. Both take the sampler settings of
``diffusion.vdm.vdm_sample``: ``n_steps``, ``eta``, ``method``, ``clip_z``
and ``compute_dtype``. ``sample_chain`` samples the visualization chain,
``rotate_chain`` appends rotated copies of a frame.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from geoldm_tpu_torch.data.collate import build_masks
from geoldm_tpu_torch.diffusion import latent as ldm_mod
from geoldm_tpu_torch.evalsuite.analyze import check_stability
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


def rotate_chain(z: np.ndarray, n_steps: int = 30) -> np.ndarray:
    """Append ``n_steps`` rotated copies of a single frame's coordinates
    (visualization; sampling.py:27-45, reference qm9/sampling.py:9-47)."""
    assert z.shape[0] == 1
    theta = 0.6 * np.pi / n_steps
    c, s = np.cos(theta), np.sin(theta)
    qz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    qx = np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])
    qy = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    q = qz @ qx @ qy
    z_h = z[:, :, 3:]
    frames = [z]
    for _ in range(n_steps):
        x = frames[-1][:, :, :3]
        frames.append(np.concatenate([x @ q.T, z_h], axis=2))
    return np.concatenate(frames, axis=0)


def sample(model, noise: com.Noise, dataset_info, nodesxsample: np.ndarray,
           fix_noise: bool = False, pad_nodes: Optional[int] = None,
           n_steps: Optional[int] = None, eta: float = 1.0, method: str = "ddim",
           clip_z: float = 0.0, compute_dtype=None):
    """Generate molecules with the requested atom counts (unconditional).
    Returns (one_hot, charges, x, node_mask): the first three are tensors on
    the model's device (still computing there), node_mask a numpy array."""
    max_n_nodes = pad_nodes or dataset_info["max_n_nodes"]
    nodesxsample = np.asarray(nodesxsample)
    if int(nodesxsample.max()) > max_n_nodes:
        raise ValueError(f"molecule of {int(nodesxsample.max())} atoms exceeds pad {max_n_nodes}")
    node_mask_np, _ = build_masks(nodesxsample, max_n_nodes)
    node_mask = torch.from_numpy(node_mask_np).to(_model_device(model))
    x, h_cat, h_int = ldm_mod.ldm_sample(model, noise, node_mask, fix_noise, compute_dtype,
                                         n_steps, eta, method, clip_z)
    return h_cat, h_int, x, node_mask_np


def sample_bucketed(model, seed: int, dataset_info, nodesxsample: np.ndarray,
                    batch_size: int = 128, buckets=DEFAULT_SAMPLE_BUCKETS,
                    fix_noise: bool = False, n_steps: Optional[int] = None, eta: float = 1.0,
                    method: str = "ddim", clip_z: float = 0.0, compute_dtype=None):
    """Size-bucketed generation: molecules are grouped by atom count and
    each group is padded only to its bucket, in chunks of ``batch_size``.
    The last chunk of a bucket is padded (by repeating its last size) to the
    next power of two, at most ``batch_size``, and trimmed afterwards. (The
    JAX server pads every chunk to ``batch_size`` so one compiled shape
    serves each bucket; the port compiles nothing, so it keeps the smaller
    padding.) Returns arrays padded to the largest bucket, in the original
    molecule order. ``n_chunks`` counts the chunks it dispatches. The
    sampler settings go to every chunk (``sample``)."""
    nodesxsample = np.asarray(nodesxsample)
    buckets = _aligned(buckets, nodesxsample)
    max_pad = buckets[-1]
    device = _model_device(model)
    m = len(nodesxsample)
    pending = []
    for chunk_index, (chunk, pad, sizes) in enumerate(
            _chunks(nodesxsample, batch_size, buckets)):
        gen = chunk_generator(seed, chunk_index, device)
        res = sample(model, gen, dataset_info, sizes, fix_noise=fix_noise, pad_nodes=pad,
                     n_steps=n_steps, eta=eta, method=method, clip_z=clip_z,
                     compute_dtype=compute_dtype)
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


def sample_chain(model, seed: int, dataset_info, n_tries: int = 1, keep_frames: int = 100,
                 compute_dtype=None):
    """A visualization chain of one molecule (19 atoms for QM9, 44 for
    GEOM), retried until its final molecule is stable, at most ``n_tries``
    times (sampling.py:296-361, reference qm9/sampling.py:54-107). Try i
    draws from ``chunk_generator(seed, i)``. Returns numpy (one_hot [F, N, S],
    charges [F, N, 1], x [F, N, 3]), noise first, the final frame repeated
    10 times at the end (F = keep_frames + 10)."""
    n_nodes = 19 if "qm9" in dataset_info["name"] else 44
    num_classes = len(dataset_info["atom_decoder"])
    node_mask_np, _ = build_masks(np.array([n_nodes]), n_nodes)
    device = _model_device(model)
    node_mask = torch.from_numpy(node_mask_np).to(device)
    for i in range(n_tries):
        chain = ldm_mod.ldm_sample_chain(model, chunk_generator(seed, i, device), node_mask,
                                         keep_frames, compute_dtype)
        chain = chain.cpu().numpy()[::-1, 0]  # noise -> sample; drop the batch
        chain = np.concatenate([chain, np.repeat(chain[-1:], 10, axis=0)], axis=0)
        final = chain[-1]
        atom_types = np.argmax(final[:, 3:3 + num_classes], axis=1)
        if check_stability(final[:, :3], atom_types, dataset_info)[0]:
            break
    x = chain[:, :, :3]
    one_hot = np.eye(num_classes, dtype=np.float32)[np.argmax(chain[:, :, 3:3 + num_classes],
                                                              axis=2)]
    charges = np.round(chain[:, :, -1:])
    return one_hot, charges, x


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
