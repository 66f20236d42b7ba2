"""Port parity on CPU: the EquivariantBlock's plain version against the JAX
Pallas kernel (interpret mode) and the JAX XLA block, the whole EGNN, and
the denoiser. The CUDA kernel itself is held against the plain version in
``test_torch_port_cuda.py``, which needs a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoldm_tpu.config import EGNNConfig as JaxEGNNConfig
from geoldm_tpu.data.datasets_config import get_dataset_info as jax_info
from geoldm_tpu.models import factory as jfactory
from geoldm_tpu.nn.dynamics import dynamics_apply, dynamics_init
from geoldm_tpu.nn.egnn import block_apply, egnn_init
from geoldm_tpu.ops.distance import build_edge_mask, coord2diff, sin_embedding
from geoldm_tpu.ops.pallas_egnn import egnn_apply_pallas, fused_block_apply
from geoldm_tpu_torch.config import EGNNConfig
from geoldm_tpu_torch.data.datasets_config import get_dataset_info
from geoldm_tpu_torch.models import factory as pfactory
from geoldm_tpu_torch.nn.dynamics import EGNNDynamics
from geoldm_tpu_torch.nn.egnn import EGNN, EquivariantBlock, init_parameters
from geoldm_tpu_torch.ops import egnn_block
from tests.torch_port_utils import load_egnn_from_jax, masked_inputs, t

torch.set_num_threads(1)

BASE = dict(in_node_nf=6, out_node_nf=6, hidden_nf=32, n_layers=2, inv_sublayers=1,
            attention=True, tanh=True, coords_range=15.0, norm_constant=1.0,
            sin_embedding=False, normalization_factor=100.0, aggregation_method="sum")
B, N, N_REAL = 2, 9, (5, 9)
ATOL = 2e-5  # as tests/test_pallas_egnn.py holds the Pallas kernel to the XLA path


def _cfgs(**kw):
    d = {**BASE, **kw}
    return EGNNConfig(**d), JaxEGNNConfig(**d)


def _block_pair(pcfg, jcfg, seed=0):
    """A JAX block's params and the port block loaded with the same weights."""
    params = egnn_init(jax.random.key(seed), jcfg)
    egnn = load_egnn_from_jax(EGNN(pcfg), params, pcfg.attention)
    block_params = jax.tree.map(lambda a: a[0], params["blocks"])
    return egnn.e_block_0, block_params


@pytest.mark.parametrize("variant", [
    {},
    {"attention": False},
    {"sin_embedding": True},
    {"inv_sublayers": 2},
    {"aggregation_method": "mean", "tanh": False},
])
def test_block_plain_matches_pallas_and_xla(variant):
    pcfg, jcfg = _cfgs(**variant)
    block, bp = _block_pair(pcfg, jcfg)
    _, x, x0, mask = masked_inputs(1, B, N, 1, N_REAL)
    h = np.random.default_rng(3).standard_normal((B, N, 32)).astype(np.float32) * mask

    with torch.no_grad():
        h_p, x_p = egnn_block.block_forward(block, t(h), t(x), t(x0), t(mask))
    hj, xj, x0j, mj = map(jnp.asarray, (h, x, x0, mask))
    h_f, x_f = fused_block_apply(jcfg, bp, hj, xj, x0j, mj, None, True)
    radial0, _ = coord2diff(x0j)
    e0 = sin_embedding(radial0) if jcfg.sin_embedding else radial0
    h_x, x_x = block_apply(bp, jcfg, hj, xj, e0, mj, build_edge_mask(mj))
    for ref_h, ref_x in ((h_f, x_f), (h_x, x_x)):
        np.testing.assert_allclose(h_p.numpy(), np.asarray(ref_h), atol=ATOL)
        np.testing.assert_allclose(x_p.numpy(), np.asarray(ref_x), atol=ATOL)


def test_egnn_matches_pallas_egnn():
    pcfg, jcfg = _cfgs(sin_embedding=True)
    params = egnn_init(jax.random.key(4), jcfg)
    egnn = load_egnn_from_jax(EGNN(pcfg), params, True)
    h, x, _, mask = masked_inputs(5, B, N, 6, N_REAL)
    with torch.no_grad():
        h_p, x_p = egnn(t(h), t(x), t(mask))
    h_j, x_j = egnn_apply_pallas(params, jcfg, jnp.asarray(h), jnp.asarray(x),
                                 jnp.asarray(mask), interpret=True)
    np.testing.assert_allclose(h_p.numpy(), np.asarray(h_j), atol=ATOL)
    np.testing.assert_allclose(x_p.numpy(), np.asarray(x_j), atol=ATOL)


def test_dynamics_matches_jax():
    kw = dict(nf=32, n_layers=2, latent_nf=2, diffusion_steps=10)
    jcfg = jfactory.make_latent_diffusion_config(jax_info("qm9"), **kw)
    pcfg = pfactory.make_latent_diffusion_config(get_dataset_info("qm9"), **kw)
    params = dynamics_init(jax.random.key(6), jcfg.dynamics)
    dyn = EGNNDynamics(pcfg.dynamics)
    load_egnn_from_jax(dyn, params["egnn"], True, prefix="egnn.")
    _, x, _, mask = masked_inputs(7, 3, 8, 1, (3, 8, 6))
    zh = np.random.default_rng(8).standard_normal((3, 8, 2)).astype(np.float32) * mask
    xh = np.concatenate([x, zh], axis=2)
    tt = np.array([[0.1], [0.5], [1.0]], dtype=np.float32)
    with torch.no_grad():
        out_p = dyn(t(tt), t(xh), t(mask))
    mj = jnp.asarray(mask)
    out_j = dynamics_apply(params, jcfg.dynamics, jnp.asarray(tt), jnp.asarray(xh), mj,
                           build_edge_mask(mj))
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_j), atol=1e-5, rtol=1e-5)


def test_init_parameters_is_seeded_and_reference_scaled():
    pcfg, _ = _cfgs()
    a, b = EquivariantBlock(pcfg), EquivariantBlock(pcfg)
    init_parameters(a, torch.Generator().manual_seed(3))
    init_parameters(b, torch.Generator().manual_seed(3))
    for (ka, va), (_, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(va, vb), ka
    w = a.gcl_equiv.coord_mlp[4].weight.detach()
    assert float(w.abs().max()) <= 0.001 * np.sqrt(6.0 / (32 + 1))


def test_kernel_wrapper_refuses_unsupported_inputs():
    pcfg, _ = _cfgs()
    block = EquivariantBlock(pcfg)
    h, x, x0, mask = (torch.zeros(1, 4, 32), torch.zeros(1, 4, 3), torch.zeros(1, 4, 3),
                      torch.ones(1, 4, 1))
    with pytest.raises(ValueError, match="CUDA"):
        egnn_block.block_forward_cuda(block, h, x, x0, mask)
