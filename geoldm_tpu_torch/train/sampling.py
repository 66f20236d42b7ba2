"""Sampling orchestration (port of ``geoldm_tpu/train/sampling.py:27-361``):
build masks on the host, run the sampler on the model's device, post-process.

Noise: ``sample`` takes a noise source; ``sample_bucketed`` gives every
chunk its own ``torch.Generator`` seeded from (request seed, chunk index),
so a seeded request replays exactly. Both take the sampler settings of
``diffusion.vdm.vdm_sample``: ``n_steps``, ``eta``, ``method``, ``clip_z``,
``guidance_scale`` and ``compute_dtype``; a conditional model takes
property rows ``context`` [B, P] (normalized) or draws them from
``prop_dist`` with the caller's numpy generator. ``sample_chain`` samples
the visualization chain, ``rotate_chain`` appends rotated copies of a frame,
``sample_sweep_conditional`` sweeps each property over its range.
"""

from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch

from geoldm_tpu_torch.data.collate import build_masks
from geoldm_tpu_torch.diffusion import latent as ldm_mod
from geoldm_tpu_torch.diffusion import vdm as vdm_mod
from geoldm_tpu_torch.evalsuite.analyze import check_stability
from geoldm_tpu_torch.models import factory
from geoldm_tpu_torch.ops import com
from geoldm_tpu_torch.parallel import sharding
from geoldm_tpu_torch.utils import spans

DEFAULT_SAMPLE_BUCKETS = (16, 24, 32)  # QM9
# GEOM-Drugs (sizes up to 181 atoms, mean 46.6): buckets matched to the size
# histogram (sampling.py:162-167).
GEOM_SAMPLE_BUCKETS = (32, 48, 64, 96, 136, 184)
_CALLS = itertools.count()  # sample_bucketed's calls in this process: its spans' ids


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


def append_indicator_if_needed(model_cfg, context: np.ndarray) -> np.ndarray:
    """Property-only context -> the model's: a model built with
    ``context_indicator`` takes a trailing all-ones channel, appended when
    the context is one channel short of the model's width
    (sampling.py:60-72)."""
    want = (model_cfg.dynamics.context_node_nf if model_cfg.dynamics is not None
            else model_cfg.vae.context_node_nf)
    if model_cfg.context_indicator and context.shape[-1] == want - 1:
        context = np.concatenate([context, np.ones_like(context[..., :1])], axis=-1)
    return context


def sample(model, noise: com.Noise, dataset_info, nodesxsample: np.ndarray,
           fix_noise: bool = False, pad_nodes: Optional[int] = None,
           n_steps: Optional[int] = None, eta: float = 1.0, method: str = "ddim",
           clip_z: float = 0.0, compute_dtype=None, context: Optional[np.ndarray] = None,
           prop_dist=None, rng: Optional[np.random.Generator] = None,
           guidance_scale: float = 1.0):
    """Generate molecules with the requested atom counts (sampling.py:75-140).
    A conditional model takes ``context``: [B, P] property rows, broadcast
    over the nodes, or [B, N, P]; without it the rows are drawn from
    ``prop_dist`` with ``rng``. The indicator channel is appended when the
    model has one, and the context is masked. Returns (one_hot, charges, x,
    node_mask): the first three are tensors on the model's device (still
    computing there), node_mask a numpy array."""
    max_n_nodes = pad_nodes or dataset_info["max_n_nodes"]
    nodesxsample = np.asarray(nodesxsample)
    if int(nodesxsample.max()) > max_n_nodes:
        raise ValueError(f"molecule of {int(nodesxsample.max())} atoms exceeds pad {max_n_nodes}")
    node_mask_np, _ = build_masks(nodesxsample, max_n_nodes)
    device = _model_device(model)
    node_mask = torch.from_numpy(node_mask_np).to(device)
    context_dev = None
    if context is not None or prop_dist is not None:
        if context is None:
            context = prop_dist.sample_batch(nodesxsample, rng)
        context = np.asarray(context, dtype=np.float32)
        if context.ndim == 2:  # [B, P] rows -> per node
            context = np.broadcast_to(context[:, None, :],
                                      (len(nodesxsample), max_n_nodes, context.shape[-1]))
        context = append_indicator_if_needed(model.cfg, context)
        context_dev = torch.from_numpy(np.ascontiguousarray(context * node_mask_np)).to(device)
    sample_fn = factory.model_sample_fn(model.cfg, compute_dtype, n_steps, eta, method,
                                        guidance_scale, clip_z)
    x, h_cat, h_int = sample_fn(model, noise, node_mask, context_dev, fix_noise)
    return h_cat, h_int, x, node_mask_np


def sample_bucketed(model, seed: int, dataset_info, nodesxsample: np.ndarray,
                    batch_size: int = 128, buckets=DEFAULT_SAMPLE_BUCKETS,
                    fix_noise: bool = False, n_steps: Optional[int] = None, eta: float = 1.0,
                    method: str = "ddim", clip_z: float = 0.0, compute_dtype=None,
                    context: Optional[np.ndarray] = None, prop_dist=None,
                    rng: Optional[np.random.Generator] = None, guidance_scale: float = 1.0,
                    data: Optional[sharding.RankGroup] = None):
    """Size-bucketed generation: molecules are grouped by atom count and
    each group is padded only to its bucket, in chunks of ``batch_size``.
    The last chunk of a bucket is padded (by repeating its last size) to the
    next power of two, at most ``batch_size``, and trimmed afterwards. (The
    JAX server pads every chunk to ``batch_size`` so one compiled shape
    serves each bucket; the port compiles nothing, so it keeps the smaller
    padding.) Returns arrays padded to the largest bucket, in the original
    molecule order. ``n_chunks`` counts the chunks it dispatches. The
    sampler settings go to every chunk (``sample``). A conditional model's
    per-molecule rows ``context`` [M, P] are split and padded with the
    sizes, a chunk's padding repeating its last row (sampling.py:116-119);
    without them each chunk draws its rows from ``prop_dist`` with ``rng``,
    padded sizes included, in dispatch order (JAX's).

    With ``data`` (this rank's data group) chunk i runs on data rank i % D
    with its own ``chunk_generator(seed, i)``; every rank draws every chunk's
    properties with ``rng``, so the draws stay in dispatch order, and the
    chunks are gathered to every rank in order: the molecules of one rank's
    run, molecule for molecule.

    Under a profiler a call is a ``sample.call`` span (``utils.spans``, id:
    the process's call number) holding ``sample.setup`` (the plan, and a
    conditional model's property draws, before the first dispatch),
    ``sample.chunk`` per dispatched chunk (id: (call, chunk index)),
    ``sample.fetch`` (the copies to the host, and the gather over the data
    ranks) and ``sample.assemble``; each dispatched chunk adds rows x pad^2 to
    ``sample.pair_slots``, repeats included, and its real molecules' n^2 to
    ``sample.pairs``."""
    call = next(_CALLS)
    with spans.span("sample.call", call):
        with spans.span("sample.setup", call):
            nodesxsample = np.asarray(nodesxsample)
            if context is not None:
                context = np.asarray(context, dtype=np.float32)
                if context.ndim != 2 or len(context) != len(nodesxsample):
                    raise ValueError(f"context must be [{len(nodesxsample)}, P] property rows, "
                                     f"got {context.shape}")
            buckets = _aligned(buckets, nodesxsample)
            max_pad = buckets[-1]
            device = _model_device(model)
            m = len(nodesxsample)
            plan = []
            for chunk_index, (chunk, pad, sizes) in enumerate(
                    _chunks(nodesxsample, batch_size, buckets)):
                ctx_chunk = None
                if context is not None:
                    ctx_chunk = context[chunk]
                    ctx_chunk = np.concatenate(
                        [ctx_chunk, np.repeat(ctx_chunk[-1:], len(sizes) - len(chunk), axis=0)])
                elif prop_dist is not None:
                    ctx_chunk = prop_dist.sample_batch(sizes, rng)  # what ``sample`` would draw
                if data is None or chunk_index % data.size == data.rank:
                    plan.append((chunk_index, chunk, pad, sizes, ctx_chunk))
        pending = []
        for chunk_index, chunk, pad, sizes, ctx_chunk in plan:
            with spans.span("sample.chunk", (call, chunk_index)):
                real = nodesxsample[chunk].astype(np.int64)
                spans.count("sample.pairs", int((real * real).sum()))
                spans.count("sample.pair_slots", len(sizes) * pad * pad)
                gen = chunk_generator(seed, chunk_index, device)
                res = sample(model, gen, dataset_info, sizes, fix_noise=fix_noise, pad_nodes=pad,
                             n_steps=n_steps, eta=eta, method=method, clip_z=clip_z,
                             compute_dtype=compute_dtype, context=ctx_chunk,
                             guidance_scale=guidance_scale)
            pending.append((chunk, pad, res))
        # Every chunk is queued on the card before the first copy to the host.
        with spans.span("sample.fetch", call):
            done = [(chunk, pad, [src.cpu().numpy() if isinstance(src, torch.Tensor) else src
                                  for src in res]) for chunk, pad, res in pending]
            done = [c for part in sharding.all_gather_objects(done, data) for c in part]
        with spans.span("sample.assemble", call):
            s = len(dataset_info["atom_decoder"])
            out = None
            for chunk, pad, (one_hot, charges, x, node_mask) in done:
                if out is None:
                    out = (np.zeros((m, max_pad, s), dtype=np.float32),
                           np.zeros((m, max_pad, charges.shape[-1]), dtype=np.float32),
                           np.zeros((m, max_pad, 3), dtype=np.float32),
                           np.zeros((m, max_pad, 1), dtype=np.float32))
                n_real = len(chunk)
                for dst, src in zip(out, (one_hot, charges, x, node_mask)):
                    dst[chunk, :pad] = src[:n_real]
    return out


def sample_chain(model, seed: int, dataset_info, n_tries: int = 1, keep_frames: int = 100,
                 compute_dtype=None, prop_dist=None, rng: Optional[np.random.Generator] = None):
    """A visualization chain of one molecule (19 atoms for QM9, 44 for
    GEOM), retried until its final molecule is stable, at most ``n_tries``
    times (sampling.py:296-361, reference qm9/sampling.py:54-107). Try i
    draws from ``chunk_generator(seed, i)``. A conditional model's context is
    one row drawn from ``prop_dist`` with ``rng`` for the chain's size, as
    JAX draws it. Returns numpy (one_hot [F, N, S], charges [F, N, 1], x
    [F, N, 3]), noise first, the final frame repeated 10 times at the end (F
    = keep_frames + 10)."""
    n_nodes = 19 if "qm9" in dataset_info["name"] else 44
    num_classes = len(dataset_info["atom_decoder"])
    node_mask_np, _ = build_masks(np.array([n_nodes]), n_nodes)
    device = _model_device(model)
    node_mask = torch.from_numpy(node_mask_np).to(device)
    context = None
    if prop_dist is not None:
        row = prop_dist.sample(n_nodes, rng)  # [P]
        ctx = append_indicator_if_needed(
            model.cfg, np.broadcast_to(row[None, None, :], (1, n_nodes, len(row))).copy())
        context = torch.from_numpy(np.ascontiguousarray(ctx, dtype=np.float32)).to(device)
    for i in range(n_tries):
        noise = chunk_generator(seed, i, device)
        if model.cfg.kind == "latent_diffusion":
            chain = ldm_mod.ldm_sample_chain(model, noise, node_mask, keep_frames, compute_dtype,
                                             context=context)
        else:  # the plain kind's frames are unnormalised (sampling.py:331-339)
            with torch.no_grad():
                _, chain = vdm_mod.vdm_sample(model.dynamics, model.cfg.diffusion, noise,
                                              node_mask, compute_dtype=compute_dtype,
                                              keep_frames=keep_frames, context=context,
                                              latent_space=False, gamma=model.gamma)
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


def sample_sweep_conditional(model, seed: int, dataset_info, prop_dist, n_nodes: int = 19,
                             n_frames: int = 100, compute_dtype=None):
    """Each conditioning property swept linearly over its observed range at
    ``n_nodes`` atoms, one frame per value, all with the same noise
    (``fix_noise``; sampling.py:362-385, reference qm9/sampling.py:157-171).
    Noise from ``chunk_generator(seed, 0)``. Returns ``sample``'s tuple."""
    nodesxsample = np.full((n_frames,), n_nodes)
    rows = []
    for key_name in prop_dist.distributions:
        lo, hi = prop_dist.distributions[key_name][n_nodes]["params"]
        mean = prop_dist.normalizer[key_name]["mean"]
        mad = prop_dist.normalizer[key_name]["mad"]
        rows.append(np.linspace((lo - mean) / mad, (hi - mean) / mad, n_frames)[:, None])
    context = np.concatenate(rows, axis=1).astype(np.float32)
    return sample(model, chunk_generator(seed, 0, _model_device(model)), dataset_info,
                  nodesxsample, fix_noise=True, context=context, compute_dtype=compute_dtype)


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
