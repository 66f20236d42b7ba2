"""Shared helpers for the port's parity tests: numpy-seeded inputs and
weight transfer from JAX param pytrees into the port's modules."""

import numpy as np
import torch

from geoldm_tpu.utils.torch_convert import egnn_state_dict_from_params


def masked_inputs(seed, b, n, in_nf, n_real):
    """h [b,n,in_nf], x [b,n,3], x0 [b,n,3], node_mask [b,n,1] (float32
    numpy), zero on padded nodes; x and x0 are CoM-free per molecule."""
    rng = np.random.default_rng(seed)
    mask = (np.arange(n)[None, :] < np.asarray(n_real)[:, None]).astype(np.float32)[..., None]
    h = rng.standard_normal((b, n, in_nf)).astype(np.float32) * mask
    xs = []
    for _ in range(2):
        x = rng.standard_normal((b, n, 3)).astype(np.float32) * mask
        x -= x.sum(axis=1, keepdims=True) / mask.sum(axis=1, keepdims=True) * mask
        xs.append(x.astype(np.float32))
    return h, xs[0], xs[1], mask


def load_egnn_from_jax(module, jax_egnn_params, attention, prefix=""):
    """Strict-load JAX EGNN params into a port module through the upstream
    state-dict layout (geoldm_tpu.utils.torch_convert)."""
    sd = {}
    egnn_state_dict_from_params(sd, prefix, jax_egnn_params, attention)
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                           strict=True)
    return module


def t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))
