"""Port parity on CPU for the block backward and the encoder: the plain
backward (``torch.autograd.grad`` of the recomputed block) against the JAX
fused block's own backward (``jax.vjp`` through the Pallas kernel pair in
interpret mode, ``bwd_mode='pallas'``, exact dx0) and against the XLA
block's gradients; the autograd Function's wiring by ``gradcheck``; and the
VAE encoder's forward. The CUDA backward kernel is held against the plain
version in ``test_torch_port_cuda.py``, which needs a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoldm_tpu.config import EGNNConfig as JaxEGNNConfig
from geoldm_tpu.data.datasets_config import get_dataset_info as jax_info
from geoldm_tpu.models import factory as jfactory
from geoldm_tpu.nn.dynamics import encoder_apply
from geoldm_tpu.nn.egnn import block_apply, egnn_init
from geoldm_tpu.ops.distance import build_edge_mask, coord2diff, sin_embedding
from geoldm_tpu.ops.pallas_egnn import fused_block_apply
from geoldm_tpu_torch.config import EGNNConfig
from geoldm_tpu_torch.data.datasets_config import get_dataset_info
from geoldm_tpu_torch.models import factory as pfactory
from geoldm_tpu_torch.nn.dynamics import EGNNEncoder
from geoldm_tpu_torch.nn.egnn import EGNN, EquivariantBlock, init_parameters
from geoldm_tpu_torch.ops import egnn_block
from tests.torch_port_utils import block_grads_by_name, load_egnn_from_jax, masked_inputs, t

torch.set_num_threads(1)

BASE = dict(in_node_nf=6, out_node_nf=6, hidden_nf=32, n_layers=1, inv_sublayers=1,
            attention=True, tanh=True, coords_range=15.0, norm_constant=1.0,
            sin_embedding=False, normalization_factor=100.0, aggregation_method="sum")
B, N, N_REAL = 2, 9, (5, 9)
# f32 gradients through two frameworks' op orders: |d| <= ATOL + RTOL * |ref|.
ATOL, RTOL = 1e-5, 1e-4


@pytest.mark.parametrize("variant", [
    {},
    {"attention": False},
    {"sin_embedding": True},
    {"inv_sublayers": 2},
    {"aggregation_method": "mean", "tanh": False},
])
def test_block_backward_plain_matches_pallas_vjp_and_xla(variant):
    d = {**BASE, **variant}
    pcfg, jcfg = EGNNConfig(**d), JaxEGNNConfig(**d)
    params = egnn_init(jax.random.key(0), jcfg)
    block = load_egnn_from_jax(EGNN(pcfg), params, pcfg.attention).e_block_0
    bp = jax.tree.map(lambda a: a[0], params["blocks"])
    _, x, x0, mask = masked_inputs(1, B, N, 1, N_REAL)
    rng = np.random.default_rng(3)
    h = rng.standard_normal((B, N, 32)).astype(np.float32) * mask
    gh = rng.standard_normal((B, N, 32)).astype(np.float32)
    gx = rng.standard_normal((B, N, 3)).astype(np.float32)

    dh, dx, dx0, dws = egnn_block.block_backward_plain(block, t(h), t(x), t(x0), t(mask),
                                                       t(gh), t(gx))
    got = dict(zip(egnn_block.block_param_names(block), [w.numpy() for w in dws]))

    hj, xj, x0j, mj = map(jnp.asarray, (h, x, x0, mask))
    _, vjp = jax.vjp(lambda p, h_, x_, x0_: fused_block_apply(
        jcfg, p, h_, x_, x0_, mj, None, True, None, "pallas"), bp, hj, xj, x0j)
    dbp_f, dh_f, dx_f, dx0_f = vjp((jnp.asarray(gh), jnp.asarray(gx)))
    radial0, _ = coord2diff(x0j)
    e0 = sin_embedding(radial0) if jcfg.sin_embedding else radial0
    _, vjp_x = jax.vjp(lambda p, h_, x_: block_apply(p, jcfg, h_, x_, e0, mj,
                                                     build_edge_mask(mj)), bp, hj, xj)
    dbp_x, dh_x, dx_x = vjp_x((jnp.asarray(gh), jnp.asarray(gx)))

    np.testing.assert_allclose(dx0.numpy(), np.asarray(dx0_f), atol=ATOL, rtol=RTOL)
    for dbp, ref_h, ref_x in ((dbp_f, dh_f, dx_f), (dbp_x, dh_x, dx_x)):
        np.testing.assert_allclose(dh.numpy(), np.asarray(ref_h), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(dx.numpy(), np.asarray(ref_x), atol=ATOL, rtol=RTOL)
        want = block_grads_by_name(dbp, pcfg.attention)
        assert set(want) == set(got)
        for name, ref in want.items():
            np.testing.assert_allclose(got[name], ref, atol=ATOL, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("variant", [{"inv_sublayers": 2, "attention": False},
                                     {"sin_embedding": True, "aggregation_method": "mean"}])
def test_block_function_gradcheck(variant):
    """The Function's wiring (argument order, None for the mask, weight
    gradients in block_params order) in float64 through the plain versions.
    With sin features, which carry no gradient by design, only h and the
    weights are checked."""
    cfg = EGNNConfig(in_node_nf=2, out_node_nf=2, hidden_nf=8, n_layers=1,
                     normalization_factor=3.0, **variant)
    block = EquivariantBlock(cfg)
    init_parameters(block, torch.Generator().manual_seed(0))
    block = block.double()
    gen = torch.Generator().manual_seed(1)
    mask = torch.tensor([[1, 1, 1, 0], [1, 1, 1, 1]], dtype=torch.float64)[..., None]
    h, x, x0 = (torch.randn(2, 4, f, generator=gen, dtype=torch.float64) * mask
                for f in (8, 3, 3))
    ws = [w.detach().clone().requires_grad_() for w in egnn_block.block_params(block)]
    h.requires_grad_()
    if cfg.sin_embedding:
        def f(h_, *w):
            return egnn_block.EquivariantBlockFunction.apply(block, None, h_, x, x0, mask, *w)
        inputs = (h, *ws)
    else:
        def f(h_, x_, x0_, *w):
            return egnn_block.EquivariantBlockFunction.apply(block, None, h_, x_, x0_, mask, *w)
        inputs = (h, x.requires_grad_(), x0.requires_grad_(), *ws)
    assert torch.autograd.gradcheck(f, inputs, eps=1e-6, atol=1e-5)


def test_encoder_matches_jax():
    kw = dict(nf=32, n_layers=2, latent_nf=2)
    jcfg = jfactory.make_vae_config(jax_info("qm9"), **kw)
    pcfg = pfactory.make_vae_config(get_dataset_info("qm9"), **kw)
    params = jfactory.init_params(jax.random.key(2), jcfg)["encoder"]
    enc = EGNNEncoder(pcfg.vae.encoder_egnn, 2)
    load_egnn_from_jax(enc.egnn, params["egnn"], True)
    with torch.no_grad():
        for k, lin in enumerate(params["final_mlp"]):
            enc.final_mlp[2 * k].weight.copy_(t(np.asarray(lin["w"]).T))
            enc.final_mlp[2 * k].bias.copy_(t(lin["b"]))
    _, x, _, mask = masked_inputs(4, 3, 8, 1, (3, 8, 6))
    rng = np.random.default_rng(5)
    h = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (3, 8))] * mask
    xh = np.concatenate([x, h, rng.integers(1, 9, (3, 8, 1)).astype(np.float32) * mask], axis=2)
    with torch.no_grad():
        got = enc(t(xh), t(mask))
    mj = jnp.asarray(mask)
    want = encoder_apply(params, jcfg.vae.encoder_egnn, 2, 3, jnp.asarray(xh), mj,
                         build_edge_mask(mj))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
