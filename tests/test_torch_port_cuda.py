"""The EquivariantBlock CUDA kernels (forward and backward) and the row-tiled
GCL and coordinate kernels against their plain PyTorch versions on the card,
at small shapes and every block variant, and the autograd Function that joins
the block kernels. Imports no jax, so it runs on a machine with a card and no
JAX:

    python -m pytest tests/test_torch_port_cuda.py -q -m cuda

Skips where torch.cuda is unavailable (the kernels have no CPU mode)."""

import numpy as np
import pytest
import torch

from geoldm_tpu_torch.config import EGNNConfig
from geoldm_tpu_torch.nn.egnn import EquivariantBlock, init_parameters
from geoldm_tpu_torch.ops import egnn_block, egnn_tiled

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)

ATOL = 2e-5
# Backward kernel vs plain autograd: both f32, sums in other orders (weight
# gradients add up to B*N*N edge terms): max|d| <= BWD_RTOL * max(1, max|ref|).
BWD_RTOL = 1e-4

VARIANTS = [
    {}, {"attention": False}, {"sin_embedding": True}, {"inv_sublayers": 2},
    {"aggregation_method": "mean", "tanh": False}, {"norm_constant": 0.5},
]


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


@pytest.mark.parametrize("variant", VARIANTS)
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


def _cotangents(card, b, n, hidden, seed=2):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(card)
            for shape in ((b, n, hidden), (b, n, 3))]


def _assert_backward_close(block, args, cots):
    got = egnn_block.block_backward_cuda(block, *args, *cots)
    want = egnn_block.block_backward_plain(block, *args, *cots)
    torch.cuda.synchronize()
    names = ["dh", "dx", "dx0"] + egnn_block.block_param_names(block)
    for name, g, w in zip(names, [*got[:3], *got[3]], [*want[:3], *want[3]]):
        scale = max(1.0, float(w.abs().max()))
        err = float((g - w).abs().max())
        assert err <= BWD_RTOL * scale, f"{name}: max|d|={err:.3e} > {BWD_RTOL}*{scale:.3g}"


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("n,n_real", [(9, (5, 9)), (24, (24, 17)), (29, (29, 12)),
                                      (40, (33, 40))])
def test_backward_kernel_matches_plain(card, variant, n, n_real):
    block = _block(card, **variant)
    _assert_backward_close(block, _inputs(card, 2, n, 32, n_real), _cotangents(card, 2, n, 32))


def test_backward_wide_hidden_and_launch_count(card):
    block = _block(card, hidden=512)
    args = _inputs(card, 3, 16, 512, (16, 11, 2))
    before = egnn_block.bwd_launches
    _assert_backward_close(block, args, _cotangents(card, 3, 16, 512))
    assert egnn_block.bwd_launches == before + 1


def test_block_forward_on_the_card_gives_the_weights_a_gradient(card):
    """block_forward under grad goes through the autograd Function: its
    outputs carry a grad_fn and every weight gets the backward kernel's
    gradient (a bare kernel call would leave them without one)."""
    block = _block(card)
    h, x, x0, mask = _inputs(card, 2, 9, 32, (5, 9))
    h.requires_grad_()
    fwd, bwd = egnn_block.launches, egnn_block.bwd_launches
    h_out, x_out = egnn_block.block_forward(block, h, x, x0, mask)
    assert h_out.grad_fn is not None and x_out.grad_fn is not None
    (h_out.square().sum() + x_out.square().sum()).backward()
    assert (egnn_block.launches, egnn_block.bwd_launches) == (fwd + 1, bwd + 1)
    for name, p in block.named_parameters():
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name
    assert h.grad is not None
    with torch.no_grad():
        h_out, _ = egnn_block.block_forward(block, h, x, x0, mask)
    assert h_out.grad_fn is None and egnn_block.launches == fwd + 2


def test_backward_refuses_what_it_cannot_hold(card):
    block = _block(card)
    args = _inputs(card, 1, 65, 32, (65,))
    with pytest.raises(ValueError, match="at most 64 nodes"):
        egnn_block.block_backward_cuda(block, *args, *_cotangents(card, 1, 65, 32))
    h, x, x0, mask = _inputs(card, 1, 8, 32, (8,))
    dh, dx = _cotangents(card, 1, 8, 32)
    with pytest.raises(TypeError, match="float32"):
        egnn_block.block_backward_cuda(block, h, x, x0, mask, dh.double(), dx)
    with pytest.raises(ValueError, match="contiguous"):
        egnn_block.block_backward_cuda(block, h, torch.zeros(1, 8, 6, device=card)[..., :3],
                                       x0, mask, dh, dx)


# Row-tiled kernels (#3, #4) vs their plain versions: f32 in other orders,
# each output within TILED_RTOL * max(1, max|ref|).
TILED_RTOL = 1e-4


def _assert_stages_close(block, args):
    x, x0, mask = args[1:]
    h = args[0]
    for j in range(block.cfg.inv_sublayers):
        gcl = getattr(block, f"gcl_{j}")
        with torch.no_grad():
            got = egnn_tiled.gcl_rows_cuda(gcl, h, x, x0, mask)
            want = egnn_tiled.gcl_rows_plain(gcl, h, x, x0, mask)
        torch.cuda.synchronize()
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= TILED_RTOL * scale, f"gcl_{j}"
        h = want
    with torch.no_grad():
        got = egnn_tiled.coord_rows_cuda(block.gcl_equiv, h, x, x0, mask)
        want = egnn_tiled.coord_rows_plain(block.gcl_equiv, h, x, x0, mask)
    torch.cuda.synchronize()
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= TILED_RTOL * scale, "coord"


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("n,n_real", [(9, (5, 9)), (65, (65, 49)), (100, (100, 83)),
                                      (181, (181, 150))])
def test_tiled_kernels_match_plain(card, variant, n, n_real):
    block = _block(card, **variant)
    _assert_stages_close(block, _inputs(card, 2, n, 32, n_real))


@pytest.mark.parametrize("n,n_real", [(9, (5, 9)), (65, (65, 49)), (100, (100, 83)),
                                      (181, (181, 150))])
def test_tiled_kernels_wide_hidden(card, n, n_real):
    block = _block(card, hidden=512)
    _assert_stages_close(block, _inputs(card, 2, n, 512, n_real))


def test_tiled_kernels_at_their_bound(card):
    block = _block(card)
    _assert_stages_close(block, _inputs(card, 1, egnn_tiled.MAX_TILED_NODES, 32,
                                        (egnn_tiled.MAX_TILED_NODES - 3,)))


@pytest.mark.parametrize("variant", VARIANTS)
def test_tiled_path_matches_block_kernel_at_64(card, variant):
    block = _block(card, **variant)
    args = _inputs(card, 3, 64, 32, (64, 57, 33))
    with torch.no_grad():
        h_k, x_k = egnn_block.block_forward_cuda(block, *args)
        h_t, x_t = egnn_tiled.tiled_block_forward(block, *args)
    torch.cuda.synchronize()
    np.testing.assert_allclose(h_t.cpu().numpy(), h_k.cpu().numpy(), atol=ATOL)
    np.testing.assert_allclose(x_t.cpu().numpy(), x_k.cpu().numpy(), atol=ATOL)


def test_block_past_64_nodes_counts_tiled_launches(card):
    block = _block(card, inv_sublayers=2)
    args = _inputs(card, 2, 96, 32, (96, 70))
    fwd = egnn_block.launches
    gcl, coord = egnn_tiled.gcl_rows_launches, egnn_tiled.coord_rows_launches
    with torch.no_grad():
        h, x = egnn_block.block_forward(block, *args)
        h_p, x_p = egnn_block.block_forward_plain(block, *args)
    assert egnn_block.launches == fwd
    assert (egnn_tiled.gcl_rows_launches, egnn_tiled.coord_rows_launches) == (gcl + 2, coord + 1)
    scale = max(1.0, float(h_p.abs().max()))
    assert float((h - h_p).abs().max()) <= TILED_RTOL * scale
    assert float((x - x_p).abs().max()) <= TILED_RTOL * scale


def test_tiled_kernels_refuse_what_they_cannot_hold(card):
    block = _block(card)
    n_big = egnn_tiled.MAX_TILED_NODES + 1
    with pytest.raises(ValueError, match=f"1 to {egnn_tiled.MAX_TILED_NODES} nodes"):
        egnn_tiled.gcl_rows_cuda(block.gcl_0, *_inputs(card, 1, n_big, 32, (n_big,)))
    h, x, x0, mask = _inputs(card, 1, 80, 32, (80,))
    for fn, mod in ((egnn_tiled.gcl_rows_cuda, block.gcl_0),
                    (egnn_tiled.coord_rows_cuda, block.gcl_equiv)):
        with pytest.raises(TypeError, match="float32"):
            fn(mod, h.double(), x, x0, mask)
        with pytest.raises(ValueError, match="contiguous"):
            fn(mod, h, torch.zeros(1, 80, 6, device=card)[..., :3], x0, mask)
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(mod, h.cpu(), x.cpu(), x0.cpu(), mask.cpu())


def test_block_past_64_nodes_refuses_grad(card):
    """The tiled backward (TPU kernel #5) is not ported: under grad a block
    of N > 64 raises on the card, never returning outputs without a
    grad_fn; under no_grad it runs."""
    block = _block(card)
    h, x, x0, mask = _inputs(card, 1, 72, 32, (72,))
    with pytest.raises(NotImplementedError, match="kernel #5"):
        egnn_block.block_forward(block, h, x, x0, mask)
    with torch.no_grad():
        h_out, _ = egnn_block.block_forward(block, h, x, x0, mask)
    assert h_out.shape == h.shape
