"""The EquivariantBlock CUDA kernel against its plain PyTorch version on the
card, at small shapes and every block variant. Imports no jax, so it runs on
a machine with a card and no JAX:

    python -m pytest tests/test_torch_port_cuda.py -q -m cuda

Skips where torch.cuda is unavailable (the kernel has no CPU mode)."""

import numpy as np
import pytest
import torch

from geoldm_tpu_torch.config import EGNNConfig
from geoldm_tpu_torch.nn.egnn import EquivariantBlock, init_parameters
from geoldm_tpu_torch.ops import egnn_block

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)

ATOL = 2e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _block(card, hidden=32, **kw):
    cfg = EGNNConfig(in_node_nf=2, out_node_nf=2, hidden_nf=hidden, n_layers=1,
                     normalization_factor=100.0, **kw)
    block = EquivariantBlock(cfg)
    init_parameters(block, torch.Generator().manual_seed(0))
    return block.to(card)


def _inputs(card, b, n, hidden, n_real, seed=1):
    rng = np.random.default_rng(seed)
    mask = (np.arange(n)[None, :] < np.asarray(n_real)[:, None]).astype(np.float32)[..., None]
    h = rng.standard_normal((b, n, hidden)).astype(np.float32) * mask
    x = rng.standard_normal((b, n, 3)).astype(np.float32) * mask
    x0 = rng.standard_normal((b, n, 3)).astype(np.float32) * mask
    return [torch.from_numpy(a).to(card) for a in (h, x, x0, mask)]


@pytest.mark.parametrize("variant", [
    {}, {"attention": False}, {"sin_embedding": True}, {"inv_sublayers": 2},
    {"aggregation_method": "mean", "tanh": False}, {"norm_constant": 0.5},
])
@pytest.mark.parametrize("n,n_real", [(9, (5, 9)), (24, (24, 17)), (40, (33, 40))])
def test_kernel_matches_plain(card, variant, n, n_real):
    block = _block(card, **variant)
    args = _inputs(card, 2, n, 32, n_real)
    with torch.no_grad():
        h_k, x_k = egnn_block.block_forward_cuda(block, *args)
        h_p, x_p = egnn_block.block_forward_plain(block, *args)
    np.testing.assert_allclose(h_k.cpu().numpy(), h_p.cpu().numpy(), atol=ATOL)
    np.testing.assert_allclose(x_k.cpu().numpy(), x_p.cpu().numpy(), atol=ATOL)


def test_wide_hidden_and_launch_count(card):
    block = _block(card, hidden=512)
    args = _inputs(card, 3, 16, 512, (16, 11, 2))
    before = egnn_block.launches
    with torch.no_grad():
        h_k, x_k = egnn_block.block_forward(block, *args)
        h_p, x_p = egnn_block.block_forward_plain(block, *args)
    assert egnn_block.launches == before + 1
    scale = max(1.0, float(h_p.abs().max()))
    np.testing.assert_allclose(h_k.cpu().numpy(), h_p.cpu().numpy(), atol=1e-4 * scale)
    np.testing.assert_allclose(x_k.cpu().numpy(), x_p.cpu().numpy(), atol=1e-4 * scale)


def test_kernel_refuses_what_it_cannot_hold(card):
    block = _block(card)
    with pytest.raises(ValueError, match="at most 64 nodes"):
        egnn_block.block_forward_cuda(block, *_inputs(card, 1, 65, 32, (65,)))
    h, x, x0, mask = _inputs(card, 1, 8, 32, (8,))
    with pytest.raises(TypeError, match="float32"):
        egnn_block.block_forward_cuda(block, h.double(), x, x0, mask)
    with pytest.raises(ValueError, match="contiguous"):
        egnn_block.block_forward_cuda(block, h, torch.zeros(1, 8, 6, device=card)[..., :3],
                                      x0, mask)
