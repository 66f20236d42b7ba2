"""Shared helpers for the port's parity tests: numpy-seeded inputs, weight
transfer from JAX param pytrees into the port's modules, JAX gradients by
the port's parameter names, and noise sources that replay JAX's draws."""

import jax
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


# The plain stage backward from a kept node chain against the whole-stage
# autograd: the same f32 math summed in another order (the node MLP's vjp
# over all rows at once instead of tile by tile).
ROUTE_RTOL = 1e-5


def assert_routes_agree(want, got, rtol=ROUTE_RTOL):
    """Each tensor of ``got`` within rtol * max(1, max|want|) of ``want``'s."""
    assert len(want) == len(got)
    for k, (w, g) in enumerate(zip(want, got)):
        assert g.shape == w.shape, (k, g.shape, w.shape)
        scale = max(1.0, float(w.abs().max()))
        err = float((g - w).abs().max())
        assert err <= rtol * scale, f"tensor {k}: max|d|={err:.3e} > {rtol}*{scale:.3g}"


def t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def block_grads_by_name(block_grads, attention):
    """One block's JAX gradient pytree -> {port parameter name: array}."""
    sd = {}
    dummy = {"w": np.zeros((1, 1), np.float32), "b": np.zeros(1, np.float32)}
    egnn = {"embedding": dummy, "embedding_out": dummy,
            "blocks": jax.tree.map(lambda a: np.asarray(a)[None], block_grads)}
    egnn_state_dict_from_params(sd, "", egnn, attention)
    return {k[len("e_block_0."):]: v for k, v in sd.items() if k.startswith("e_block_0.")}


class Feed:
    """A noise source that hands out given draws in order: ('n', normals)
    through __call__ and ('i', integers) through randint, checking shapes."""

    def __init__(self, draws):
        self.draws = list(draws)

    def _next(self, kind, shape):
        got_kind, a = self.draws.pop(0)
        assert got_kind == kind and tuple(a.shape) == tuple(shape), (got_kind, a.shape, shape)
        return torch.from_numpy(np.array(a))

    def __call__(self, shape):
        return self._next("n", shape)

    def randint(self, low, high, shape):
        return self._next("i", shape)


def jax_combined_draws(key, b, n, d_x, d_h):
    """The raw normals behind JAX's sample_combined_*_noise(key, ...)."""
    kx, kh = jax.random.split(key)
    return [("n", np.asarray(jax.random.normal(kx, (b, n, d_x)))),
            ("n", np.asarray(jax.random.normal(kh, (b, n, d_h))))]


def jax_vdm_draws(key, b, n, feat_nf, timesteps, t0_always):
    """JAX vdm.compute_loss's draws from ``key`` (vdm.py:295-313, :346)."""
    k_t, k_eps, k_eps0 = jax.random.split(key, 3)
    t = jax.random.randint(k_t, (b, 1), 1 if t0_always else 0, timesteps + 1)
    draws = [("i", np.asarray(t))] + jax_combined_draws(k_eps, b, n, 3, feat_nf)
    if t0_always:
        draws += jax_combined_draws(k_eps0, b, n, 3, feat_nf)
    return draws


def jax_ldm_draws(key, b, n, latent_nf, timesteps, t0_always):
    """JAX latent.ldm_nll's draws from ``key`` (latent.py:84 split)."""
    k_enc, k_loss = jax.random.split(key)
    return (jax_combined_draws(k_enc, b, n, 3, latent_nf)
            + jax_vdm_draws(k_loss, b, n, latent_nf, timesteps, t0_always))
