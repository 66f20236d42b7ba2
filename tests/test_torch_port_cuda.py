"""The EquivariantBlock CUDA kernels (forward and backward), the row-tiled
GCL and coordinate kernels and their backward, and the sequence-parallel
slab kernels (#6, #7) against their plain PyTorch versions on the card, at
small shapes and every block variant, the autograd Functions that join them,
the SP EGNN over two ranks sharing the card, and NCCL collectives on host
tensors. Imports no jax, so it runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_port_cuda.py -q -m cuda

Skips where torch.cuda is unavailable (the kernels have no CPU mode)."""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from geoldm_tpu_torch.config import EGNNConfig
from geoldm_tpu_torch.nn.egnn import EquivariantBlock, init_parameters
from geoldm_tpu_torch.ops import egnn_block, egnn_sp, egnn_tiled
from geoldm_tpu_torch.parallel import sharding, sp
import torch_port_sp_ranks
from torch_port_bf16_sites import (BWD_SITES, FLIP_SHARE, SITES, assert_separated, bf16_flips,
                                   bf16_grads_report, flips_allowed, unrounded)

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


# The multi-row edge tiles of #1/#2 (csrc/egnn_block_tile.cuh): R = 64 // N
# rows a tile, the last tile of a molecule ragged when R does not divide N
# (17: 3 rows, last 2; 29: 2, last 1; 33, 48, 64: one row of 33/48/64 edge
# rows), B*N never a multiple of 64 here; hidden widths padded to 64, 128,
# 256, 512 (32, 96 and 192 masked).
TILE_CASES = [
    (17, (17, 12, 3), 32, {}), (29, (29, 21, 29), 128, {}), (33, (33, 30, 17), 32, {}),
    (48, (48, 33, 40), 96, {"inv_sublayers": 2}), (64, (64, 49, 57), 32, {"attention": False}),
    (29, (29, 24), 512, {}), (17, (17, 9), 128, {"sin_embedding": True}),
    # The conditional QM9 recipe's width: 192 padded to 256, 64 channels masked.
    (29, (29, 21, 26), 192, {}), (16, (16, 9, 12), 192, {}),
]


def _tile_case(card, n, n_real, hidden, variant):
    block = _block(card, hidden=hidden, **variant)
    b = len(n_real)
    return block, _inputs(card, b, n, hidden, n_real), _cotangents(card, b, n, hidden)


@pytest.mark.parametrize("n,n_real,hidden,variant", TILE_CASES)
def test_block_kernels_on_ragged_tiles_match_plain(card, n, n_real, hidden, variant):
    block, args, cots = _tile_case(card, n, n_real, hidden, variant)
    with torch.no_grad():
        h_k, x_k = egnn_block.block_forward_cuda(block, *args)
        h_p, x_p = egnn_block.block_forward_plain(block, *args)
    scale = max(1.0, float(h_p.abs().max()), float(x_p.abs().max()))
    assert float((h_k - h_p).abs().max()) <= BWD_RTOL * scale
    assert float((x_k - x_p).abs().max()) <= BWD_RTOL * scale
    _assert_backward_close(block, args, cots)


def _flat(grads):
    return [*grads[:3], *grads[3]]


@pytest.mark.parametrize("n,n_real,hidden,variant", TILE_CASES[:5])
def test_block_backward_replays_and_saved_route_is_bit_identical(card, n, n_real, hidden,
                                                                 variant):
    """Two backward runs give the same bits (fixed reduction order, no
    atomics), and the backward from the forward's saved activations (the
    autograd Function's route) equals the one that recomputes them."""
    block, args, cots = _tile_case(card, n, n_real, hidden, variant)
    first = egnn_block.block_backward_cuda(block, *args, *cots)
    second = egnn_block.block_backward_cuda(block, *args, *cots)
    h_out, x_out, saved = egnn_block._forward_launch(block, *args, save=True)
    via_saved = egnn_block._backward_launch(block, *args, *cots, saved)
    with torch.no_grad():
        h_k, x_k = egnn_block.block_forward_cuda(block, *args)
    torch.cuda.synchronize()
    assert torch.equal(h_out, h_k) and torch.equal(x_out, x_k)
    assert saved.shape == (4, block.cfg.inv_sublayers, len(n_real) * n, hidden)
    for a, b, c in zip(_flat(first), _flat(second), _flat(via_saved)):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_block_function_saves_activations_only_under_grad(card, monkeypatch):
    """With grad the Function's forward saves the activations for the
    backward; under no_grad the forward saves and keeps nothing beyond its
    two outputs."""
    block, args, cots = _tile_case(card, 29, (29, 21, 29), 128, {})
    seen = []
    launch = egnn_block._forward_launch

    def spy(*a, save, **kw):
        seen.append(save)
        return launch(*a, save=save, **kw)

    monkeypatch.setattr(egnn_block, "_forward_launch", spy)
    h, x, x0, mask = args
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with torch.no_grad():
        h_out, x_out = egnn_block.block_forward(block, h, x, x0, mask)
    torch.cuda.synchronize()
    rounded = sum((t.numel() * 4 + 511) // 512 * 512 for t in (h_out, x_out))
    assert torch.cuda.memory_allocated() - before == rounded
    assert seen == [False]
    del h_out, x_out
    hg = h.detach().requires_grad_()
    h_out, x_out = egnn_block.block_forward(block, hg, x, x0, mask)
    assert seen == [False, True]
    torch.autograd.backward((h_out, x_out), cots)
    want = egnn_block.block_backward_cuda(block, h, x, x0, mask, *cots)
    assert torch.equal(hg.grad, want[0])
    for p, g in zip(egnn_block.block_params(block), want[3]):
        assert torch.equal(p.grad, g)


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


# The forward grid's 64-column windows (csrc/egnn_rows.cuh): N at and
# around window edges, real atoms ending inside a window, molecules of
# padding only (every window skipped), each padded hidden width (64, 128,
# 256, 512; 32 and 96 masked) and sin features.
WINDOW_CASES = [
    (65, (65, 64, 1), 64, {}), (127, (127, 70, 0), 128, {}),
    (128, (128, 100), 256, {"sin_embedding": True}),
    (129, (129, 0, 65), 32, {"aggregation_method": "mean", "tanh": False}),
    (191, (191, 150, 130), 512, {}), (191, (0, 0), 96, {"attention": False}),
]


@pytest.mark.parametrize("n,n_real,hidden,variant", WINDOW_CASES)
def test_tiled_kernels_on_column_windows_match_plain_and_replay(card, n, n_real, hidden,
                                                                variant):
    block = _block(card, hidden=hidden, **variant)
    args = _inputs(card, len(n_real), n, hidden, n_real)
    _assert_stages_close(block, args)
    with torch.no_grad():
        for fn, mod in ((egnn_tiled.gcl_rows_cuda, block.gcl_0),
                        (egnn_tiled.coord_rows_cuda, block.gcl_equiv)):
            first, second = fn(mod, *args), fn(mod, *args)
            assert torch.equal(first, second), fn.__name__


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


def _assert_stage_backward_close(module, stage, args, g_out):
    cuda_fn = getattr(egnn_tiled, f"{stage}_backward_cuda")
    plain_fn = getattr(egnn_tiled, f"{stage}_backward_plain")
    got = cuda_fn(module, *args, g_out)
    want = plain_fn(module, *args, g_out)
    torch.cuda.synchronize()
    assert len(got[3]) == len(want[3]) == len(list(module.parameters()))
    for name, g, w in zip(["dh", "dx", "dx0"] + [f"w{k}" for k in range(len(want[3]))],
                          [*got[:3], *got[3]], [*want[:3], *want[3]]):
        scale = max(1.0, float(w.abs().max()))
        err = float((g - w).abs().max())
        assert err <= BWD_RTOL * scale, f"{stage} {name}: max|d|={err:.3e} > {BWD_RTOL}*{scale:.3g}"
    return got


def _assert_block_stages_backward_close(block, args, seed=3):
    gh, gx = _cotangents(card=args[0].device, b=args[0].shape[0], n=args[0].shape[1],
                         hidden=args[0].shape[2], seed=seed)
    for j in range(block.cfg.inv_sublayers):
        _assert_stage_backward_close(getattr(block, f"gcl_{j}"), "gcl_rows", args, gh)
    _assert_stage_backward_close(block.gcl_equiv, "coord_rows", args, gx)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("n,n_real", [(9, (5, 9)), (65, (65, 49)), (100, (100, 83)),
                                      (181, (181, 150))])
def test_tiled_backward_matches_plain(card, variant, n, n_real):
    block = _block(card, **variant)
    _assert_block_stages_backward_close(block, _inputs(card, 2, n, 32, n_real))


@pytest.mark.parametrize("n,n_real", [(9, (5, 9)), (65, (65, 49)), (100, (100, 83)),
                                      (181, (181, 150))])
def test_tiled_backward_wide_hidden(card, n, n_real):
    block = _block(card, hidden=512)
    _assert_block_stages_backward_close(block, _inputs(card, 2, n, 512, n_real))


def test_tiled_backward_in_groups_replays_and_counts(card, monkeypatch):
    """Under a scratch cap of one molecule the stage backward runs the batch
    in groups and adds their weight gradients in order: the result stays
    within tolerance of the plain version, a rerun is bit-identical, and
    each call counts one launch."""
    block = _block(card)
    args = _inputs(card, 3, 80, 32, (80, 61, 72))
    gh, gx = _cotangents(card, 3, 80, 32)
    lib = egnn_tiled.cuda_build.library("egnn_tiled_bwd")
    one = 4 * lib.egnn_rows_backward_scratch_floats(1, 80, 32, block.cfg.edge_feat_nf, 0)
    monkeypatch.setattr(egnn_tiled, "MAX_BWD_SCRATCH_BYTES", one)
    gcl, coord = egnn_tiled.gcl_rows_bwd_launches, egnn_tiled.coord_rows_bwd_launches
    first = _assert_stage_backward_close(block.gcl_0, "gcl_rows", args, gh)
    again = egnn_tiled.gcl_rows_backward_cuda(block.gcl_0, *args, gh)
    for a, b in zip([*first[:3], *first[3]], [*again[:3], *again[3]]):
        assert torch.equal(a, b)
    _assert_stage_backward_close(block.gcl_equiv, "coord_rows", args, gx)
    assert (egnn_tiled.gcl_rows_bwd_launches, egnn_tiled.coord_rows_bwd_launches) == (gcl + 2,
                                                                                      coord + 1)


@pytest.mark.parametrize("n,n_real", [(80, (80, 64, 71)), (184, (184, 168, 177)),
                                      (184, tuple(168 + k % 17 for k in range(32)))])
def test_tiled_backward_tile_grid_at_geom_width(card, n, n_real):
    """The backward edge grid at the GEOM recipe's width (H=256, attention,
    tanh) and training pads 80 and 184 (64-column windows, the last one
    ragged, padding rows and columns), and at GEOM's largest training batch
    (B=32, N=184: 1.08 M edge rows, 529 splits of the W2-gradient GEMM): both
    stages, weight gradients included, within tolerance of the plain
    versions."""
    block = _block(card, hidden=256)
    _assert_block_stages_backward_close(block, _inputs(card, len(n_real), n, 256, n_real))


def test_wgrad_splits_match_the_library(card):
    """The CPU emulation's split count of the W2-gradient GEMM
    (``egnn_block.wgrad_splits``) is the library's."""
    lib = egnn_tiled.cuda_build.library("egnn_tiled_bwd")
    for edges in (1, 15, 9800, 64 * 29 * 29, 131072, 131073, 32 * 104 * 104, 32 * 184 * 184):
        for hidden in (32, 256, 512):
            chunk = ctypes.c_int()
            splits = lib.egnn_wgrad_splits(edges, hidden, ctypes.byref(chunk))
            assert (splits, chunk.value) == egnn_block.wgrad_splits(edges, hidden), (edges, hidden)


# The node GEMM (csrc/egnn_tc_gemm.cuh) alone, through egnn_node_gemm: every
# product within the split-TF32 gate of a float64 product (that of the
# bf16-rounded operands where the variant rounds them).
NODE_GEMM_GATE = 1e-4
_EPI = {"none": 0, "silu": 1, "resid_mask": 2}


def _bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


def _node_gemm(card, M, N, K, ta=0, tb=1, variant=0, epilogue="none", bias=False,
               accumulate=0, round_out=0, split=True, k1=None, ldb=None, offset=0, pair=False,
               seed=0):
    """Runs the node GEMM on random operands -> (outputs, float64 references
    before any output rounding): A(m, k) stored [K][M] (ta) or [M][K] (split
    at k1 into two buffers), B(k, n) stored [N][K] (tb) or [K][N] with row
    stride ldb, each operand ``offset`` floats into its buffer; with
    ``pair`` a second product of the same shape in the same launch."""
    gen = torch.Generator(device=card).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=card)

    lib = egnn_block.cuda_build.library("egnn_block_bwd")
    rows_b = N if tb else K
    ldb = ldb or (K if tb else N)
    k1 = K if k1 is None or ta else k1
    operands, refs = [], []
    for _ in range(2 if pair else 1):
        if ta:
            a1 = rnd(K * M + offset)
            a = a1[offset:].view(K, M).T
            a2, a_args = None, (a1[offset:], M, K, 0)
        else:
            a1, a2 = rnd(M * k1 + offset), rnd(M * (K - k1) + 1)
            a = torch.cat([a1[offset:].view(M, k1), a2[:M * (K - k1)].view(M, K - k1)], 1)
            a_args = (a1[offset:], k1, k1, K - k1)
        b_buf = rnd(rows_b * ldb + offset) * 0.1
        bmat = b_buf[offset:].view(rows_b, ldb)[:, :K if tb else N]
        b = bmat.T if tb else bmat
        c0 = rnd(M, N)
        operands.append((a_args, a2, b_buf[offset:], c0.clone()))
        a64, b64 = a.double(), b.double()
        if variant == 1:
            a64, b64 = _bf16(a.double()), _bf16(b.double())
        if variant == 2:
            b64 = _bf16(b).double()
        refs.append((a64 @ b64, c0))
    bias_t, resid, mask = rnd(N), rnd(M, N), (rnd(M) > 0).float()
    split_buf = torch.empty(32 * max(M, 64) * max(N, 64), device=card) if split else None
    (a_args, a2, b_ptr, c), = operands[:1]
    second = operands[1] if pair else None
    rc = lib.egnn_node_gemm(
        a_args[0].data_ptr(), a2.data_ptr() if (a2 is not None and K > k1) else None,
        b_ptr.data_ptr(), c.data_ptr(), second[0][0].data_ptr() if pair else None,
        second[2].data_ptr() if pair else None, second[3].data_ptr() if pair else None,
        bias_t.data_ptr() if bias else None, resid.data_ptr(), mask.data_ptr(),
        split_buf.data_ptr() if split else None, a_args[1], k1, max(K - k1, 1), ta, ldb, tb, N,
        N, M, N, K, _EPI[epilogue], accumulate, accumulate, round_out, variant,
        split_buf.numel() if split else 0, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0, lib.egnn_block_bwd_error_string(rc).decode()
    outs, wants = [c] + ([second[3]] if pair else []), []
    for prod, c0 in refs:
        v = prod + (bias_t.double() if bias else 0)
        if epilogue == "silu":
            v = v * torch.sigmoid(v)
        if epilogue == "resid_mask":
            v = (resid.double() + v) * mask.double()[:, None]
        wants.append((v, c0))
    return outs, wants


def _assert_node_gemm_close(outs, wants, accumulate, round_out=0):
    for out, (v, c0) in zip(outs, wants):
        base = c0.double() if accumulate else 0
        scale = float(v.abs().max())
        if round_out:  # the product rounded to bf16 (half an ulp: 2^-8), then stored or added
            err = (out.double() - base - v).abs()
            assert bool((err <= 2.0 ** -8 * v.abs() + NODE_GEMM_GATE * scale).all())
            assert accumulate or torch.equal(out, _bf16(out))
            continue
        err = float((out.double() - base - v).abs().max())
        assert err <= NODE_GEMM_GATE * scale, err


@pytest.mark.parametrize("accumulate", [0, 1])
@pytest.mark.parametrize("M,N,K", [(1857, 70, 45), (64, 96, 1000), (17, 130, 300)])
@pytest.mark.parametrize("ta,tb", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_node_gemm_layouts_splits_and_accumulate(card, ta, tb, M, N, K, accumulate):
    """Every operand layout, ragged M, N and K (K not a multiple of the
    64-row chunk), shapes the plan splits over K (64 x 96 over 1000 rows, 17
    x 130 over 300) and one it does not, writing or adding to c."""
    split = egnn_block.node_gemm_plan(M, N, K, 1, 32 * max(M, 64) * max(N, 64))[2]
    assert split == {45: 1, 1000: 8, 300: 3}[K]
    outs, wants = _node_gemm(card, M, N, K, ta, tb, accumulate=accumulate)
    _assert_node_gemm_close(outs, wants, accumulate)


@pytest.mark.parametrize("variant", [0, 1])
@pytest.mark.parametrize("epilogue", ["none", "silu", "resid_mask"])
@pytest.mark.parametrize("M", [1, 17, 1857])
def test_node_gemm_epilogues_and_bf16(card, M, epilogue, variant):
    """The forward's products (A [M][K] split at k1 into [h, agg], B an
    nn.Linear weight [N][K], a bias) with each epilogue, in f32 and in the
    bf16 variant (against the bf16-rounded operands)."""
    outs, wants = _node_gemm(card, M, 256, 512, 0, 1, variant=variant, epilogue=epilogue,
                             bias=True, k1=256)
    _assert_node_gemm_close(outs, wants, 0)


@pytest.mark.parametrize("accumulate", [0, 1])
@pytest.mark.parametrize("round_out", [0, 1])
@pytest.mark.parametrize("ta", [0, 1])
def test_node_gemm_grad16(card, ta, round_out, accumulate):
    """The bf16 backward's products: A (the cotangent) in split TF32, B
    rounded to bf16, the input gradients through W1's rows (stride 2H + E,
    not 16-byte aligned) rounded to bf16 before they are added."""
    M, K = (256, 1856) if ta else (1856, 256)
    outs, wants = _node_gemm(card, M, 256, K, ta, 0, variant=2, accumulate=accumulate,
                             round_out=round_out, ldb=None if ta else 2 * 256 + 2)
    _assert_node_gemm_close(outs, wants, accumulate, round_out)


@pytest.mark.parametrize("ta,tb", [(0, 0), (0, 1), (1, 0)])
def test_node_gemm_unaligned_operands(card, ta, tb):
    """Operands one float off a 16-byte boundary and row strides of 2H + 1
    (W1's at one edge feature): the 4-byte copies give the same product."""
    M, N, K = (256, 256, 1856) if ta else (1856, 256, 256)
    outs, wants = _node_gemm(card, M, N, K, ta, tb, ldb=(K if tb else N) + 1, offset=1)
    _assert_node_gemm_close(outs, wants, 0)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("M,N,K,ta", [(1856, 256, 256, 0), (256, 256, 1856, 1)])
def test_node_gemm_pair_is_two_products_and_replays(card, M, N, K, ta, split):
    """A grouped pair gives each product's bits as its own launch does where
    the two share a plan (else both within the gate), and a second run gives
    the same bits (splits summed in order, no atomics)."""
    first, wants = _node_gemm(card, M, N, K, ta, 0, split=split, pair=True, seed=3)
    again, _ = _node_gemm(card, M, N, K, ta, 0, split=split, pair=True, seed=3)
    alone, alone_wants = _node_gemm(card, M, N, K, ta, 0, split=split, seed=3)
    _assert_node_gemm_close(first, wants, 0)
    _assert_node_gemm_close(alone, alone_wants, 0)
    cap = 32 * M * N if split else 0
    if egnn_block.node_gemm_plan(M, N, K, 2, cap) == egnn_block.node_gemm_plan(M, N, K, 1, cap):
        assert torch.equal(first[0], alone[0])
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_node_gemm_plan_matches_the_library(card):
    """The CPU mirror of the node GEMM's plan (``egnn_block.node_gemm_plan``:
    tile, splits, K rows a split) is the library's."""
    lib = egnn_block.cuda_build.library("egnn_block_bwd")
    out = (ctypes.c_int * 4)()
    for m, n, k in [(1, 1, 1), (17, 70, 45), (64, 96, 1000), (1856, 256, 256),
                    (256, 256, 1856), (256, 256, 32 * 184), (192, 192, 1856),
                    (256, 256, 100000), (6400, 256, 512)]:
        for problems in (1, 2):
            for cap in (0, 32 * 256 * 256, 1000):
                for may_split in (0, 1):
                    lib.egnn_node_gemm_plan(m, n, k, problems, cap, may_split, out)
                    assert tuple(out) == egnn_block.node_gemm_plan(
                        m, n, k, problems, cap, bool(may_split)), (m, n, k, problems, cap)


def test_block_backward_at_the_qm9_recipe_replays_and_saved_route_is_bit_identical(card):
    """At the QM9 recipe's widths (B=64, N=29, H=256: 1856 node rows, the
    weight gradients split over K) the backward replays bit for bit, and the
    saved route equals the recompute route: the forward and #2's recompute
    run the same node GEMM."""
    n_real = tuple(29 - k % 11 for k in range(64))
    block, args, cots = _tile_case(card, 29, n_real, 256, {})
    first = egnn_block.block_backward_cuda(block, *args, *cots)
    second = egnn_block.block_backward_cuda(block, *args, *cots)
    _, _, saved = egnn_block._forward_launch(block, *args, save=True)
    via_saved = egnn_block._backward_launch(block, *args, *cots, saved)
    torch.cuda.synchronize()
    for a, b, c in zip(_flat(first), _flat(second), _flat(via_saved)):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("hidden,n,n_real", [(32, 65, (65, 49)), (256, 184, (184, 150)),
                                             (96, 129, (100, 129))])
def test_tiled_gcl_backward_from_the_forward_chain_is_bit_identical(card, monkeypatch, grouped,
                                                                     hidden, n, n_real):
    """#5 on a GCL from the node chain its forward (#3) kept (the training
    route) gives the same bits as #5 running the chain itself, also when the
    batch runs in groups; #3's output is the same whether it keeps the chain
    or not."""
    block = _block(card, hidden=hidden)
    args = _inputs(card, 2, n, hidden, n_real)
    gh, _ = _cotangents(card, 2, n, hidden)
    if grouped:
        lib = egnn_tiled.cuda_build.library("egnn_tiled_bwd")
        one = 4 * lib.egnn_rows_backward_scratch_floats(1, n, hidden, block.cfg.edge_feat_nf, 0)
        monkeypatch.setattr(egnn_tiled, "MAX_BWD_SCRATCH_BYTES", one)
    with torch.no_grad():
        h_out, chain = egnn_tiled.gcl_rows_cuda(block.gcl_0, *args, keep_chain=True)
        assert chain.shape == (3, 2, n, hidden)
        assert torch.equal(h_out, egnn_tiled.gcl_rows_cuda(block.gcl_0, *args))
    own = egnn_tiled.gcl_rows_backward_cuda(block.gcl_0, *args, gh)
    handed = egnn_tiled.gcl_rows_backward_cuda(block.gcl_0, *args, gh, chain=chain)
    torch.cuda.synchronize()
    for k, (a, b) in enumerate(zip([*own[:3], *own[3]], [*handed[:3], *handed[3]])):
        assert torch.equal(a, b), k


def test_tiled_backward_refuses_what_it_cannot_hold(card, monkeypatch):
    block = _block(card)
    h, x, x0, mask = _inputs(card, 1, 80, 32, (80,))
    gh, gx = _cotangents(card, 1, 80, 32)
    with pytest.raises(ValueError, match="g_out has shape"):
        egnn_tiled.gcl_rows_backward_cuda(block.gcl_0, h, x, x0, mask, gx)
    with pytest.raises(ValueError, match="chain has shape"):
        egnn_tiled.gcl_rows_backward_cuda(block.gcl_0, h, x, x0, mask, gh,
                                          chain=torch.zeros(2, 1, 80, 32, device=card))
    with pytest.raises(TypeError, match="float32"):
        egnn_tiled.coord_rows_backward_cuda(block.gcl_equiv, h, x, x0, mask, gx.double())
    with pytest.raises(ValueError, match="CUDA tensors"):
        egnn_tiled.coord_rows_backward_cuda(block.gcl_equiv, h.cpu(), x.cpu(), x0.cpu(),
                                            mask.cpu(), gx.cpu())
    monkeypatch.setattr(egnn_tiled, "MAX_BWD_SCRATCH_BYTES", 1 << 20)
    with pytest.raises(ValueError, match="MAX_BWD_SCRATCH_BYTES"):
        egnn_tiled.gcl_rows_backward_cuda(block.gcl_0, h, x, x0, mask, gh)


@pytest.mark.parametrize("variant", [{}, {"inv_sublayers": 2, "attention": False},
                                     {"sin_embedding": True, "aggregation_method": "mean"}])
def test_block_past_64_nodes_gives_the_weights_a_gradient(card, variant):
    """block_forward of N > 64 under grad goes through
    TiledEquivariantBlockFunction: every weight gets the kernels' gradient,
    which agrees with the Function's plain backward on the CPU, and the
    launch counts are #3 x inv (forward) + #3 x inv (recompute), #4 x 1,
    #5 x (inv + 1)."""
    block = _block(card, **variant)
    args = _inputs(card, 2, 72, 32, (72, 66))
    gh, gx = _cotangents(card, 2, 72, 32, seed=4)
    inv = block.cfg.inv_sublayers
    counts = lambda: (egnn_block.launches, egnn_block.bwd_launches,  # noqa: E731
                      egnn_tiled.gcl_rows_launches, egnn_tiled.coord_rows_launches,
                      egnn_tiled.gcl_rows_bwd_launches, egnn_tiled.coord_rows_bwd_launches)
    before = counts()
    grads = {}
    for dev in (card, torch.device("cpu")):
        blk = block.to(dev)
        blk.zero_grad(set_to_none=True)
        h, x, x0, mask = [a.detach().to(dev) for a in args]
        h.requires_grad_()
        x.requires_grad_()
        h_out, x_out = egnn_block.block_forward(blk, h, x, x0, mask)
        assert h_out.grad_fn is not None and x_out.grad_fn is not None
        (h_out * gh.to(dev)).sum().add((x_out * gx.to(dev)).sum()).backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            after = counts()
            assert [a - b for a, b in zip(after, before)] == [0, 0, 2 * inv, 1, inv, 1]
        grads[dev.type] = {"h": h.grad.cpu(), "x": x.grad.cpu(),
                           **{k: p.grad.cpu() for k, p in blk.named_parameters()}}
    for name, ref in grads["cpu"].items():
        got = grads["cuda"][name]
        assert float(got.abs().max()) > 0 or name.startswith("x"), name
        scale = max(1.0, float(ref.abs().max()))
        assert float((got - ref).abs().max()) <= BWD_RTOL * scale, name
    block.to(card)
    with torch.no_grad():
        h_out, _ = egnn_block.block_forward(block, *args)
    assert h_out.shape == args[0].shape and h_out.grad_fn is None


@pytest.mark.parametrize("sizes,pad", [((29, 25, 20), 29), ((80, 75, 66), 80)])
def test_seeded_train_step_replays_bit_for_bit(card, sizes, pad):
    """The kernels reduce without atomics: two seeded train-step gradients
    from the same weights on the same batch are bit-identical (pad 29 runs
    #1/#2, pad 80 #3-#5)."""
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.synthetic import synthetic_batch
    from geoldm_tpu_torch.models import factory
    from geoldm_tpu_torch.models.distributions import DistributionNodes
    from geoldm_tpu_torch.train.trainer import prepare_batch

    info = get_dataset_info("geom")
    cfg = factory.make_latent_diffusion_config(info, nf=32, n_layers=2, latent_nf=2,
                                               include_charges=False, diffusion_steps=50,
                                               trainable_ae=True)
    raw = synthetic_batch(info, len(sizes), pad, np.random.default_rng(0), include_charges=False,
                          n_atoms=sizes)
    nll_fn = factory.model_nll_fn(cfg, training=True)
    runs = []
    for _ in range(2):
        model = factory.build_model(cfg, card, torch.Generator().manual_seed(1))
        batch = prepare_batch(raw, DistributionNodes(info.n_nodes), card)
        gen = torch.Generator(device=card).manual_seed(2)
        nll = nll_fn(model, gen, batch["x"], batch["h_cat"], batch["h_int"], batch["node_mask"])
        loss = (nll - batch["log_pN"]).mean()
        loss.backward()
        runs.append([loss.detach()] + [p.grad for p in model.parameters() if p.grad is not None])
    assert len(runs[0]) > 20
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Sequence-parallel slab kernels (#6, #7) and the SP EGNN
# ---------------------------------------------------------------------------

# (N, slab rows S, first global row): first and later slabs, ragged S, a
# slab of one row's width past the 64-node bound of the whole-row kernels,
# and slabs whose rows start off the forward grid's 64-column windows.
SP_SLABS = [(24, 12, 0), (24, 12, 12), (81, 27, 27), (100, 25, 75), (9, 3, 6),
            (130, 65, 65), (191, 70, 121)]


def _sp_views(card, n, s, row0, n_real, seed=1):
    full = _inputs(card, 2, n, 32, n_real, seed)
    return full, [t[:, row0:row0 + s].contiguous() for t in full]


def _assert_within(got, want, rtol, name):
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= rtol * scale, f"{name}: max|d|={err:.3e} > {rtol}*{scale:.3g}"


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("n,s,row0", SP_SLABS)
def test_sp_kernels_match_plain(card, variant, n, s, row0):
    """#6 and #7 on the slab row0..row0+s (its diagonal at the global row)
    against their plain versions, 'mean' over an SP-padded N (n - 2)."""
    block = _block(card, **variant)
    full, rows = _sp_views(card, n, s, row0, (n, n - 7))
    mean_div = n - 2
    rng = np.random.default_rng(row0)
    for stage in (block.gcl_0, block.gcl_equiv):
        (fwd, bwd), (fwd_p, bwd_p) = egnn_sp.stage_fns(stage, True), egnn_sp.stage_fns(stage, False)
        with torch.no_grad():
            got = fwd(stage, full, rows, row0, mean_div)
            want = fwd_p(stage, full, rows, row0, mean_div)
        torch.cuda.synchronize()
        _assert_within(got, want, TILED_RTOL, f"{type(stage).__name__} forward")
        g = torch.from_numpy(rng.standard_normal(tuple(got.shape)).astype(np.float32)).to(card)
        got = bwd(stage, full, rows, row0, mean_div, g)
        want = bwd_p(stage, full, rows, row0, mean_div, g)
        torch.cuda.synchronize()
        assert len(got[6]) == len(want[6]) == len(list(stage.parameters()))
        names = ["dh", "dx", "dx0", "dh_rows", "dx_rows", "dx0_rows"] + \
            [f"w{k}" for k in range(len(want[6]))]
        for name, a, b in zip(names, [*got[:6], *got[6]], [*want[:6], *want[6]]):
            _assert_within(a, b, BWD_RTOL, f"{type(stage).__name__} {name}")


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("row0", [0, 15])
def test_sp_kernels_match_plain_at_the_conditional_width(card, variant, row0):
    """#6 and #7 at the conditional QM9 recipe's H=192 (64 of the tile's
    256 channels masked) on N=29 padded to 30 over 2 ranks, the slab at
    row0 (--conditioning under --sp), against their plain versions,
    'mean' over the unpadded 29, weight gradients included."""
    block = _block(card, hidden=192, **variant)
    full = _inputs(card, 3, 30, 192, (29, 22, 25))
    rows = [t[:, row0:row0 + 15].contiguous() for t in full]
    rng = np.random.default_rng(row0 + 192)
    for stage in (block.gcl_0, block.gcl_equiv):
        (fwd, bwd), (fwd_p, bwd_p) = egnn_sp.stage_fns(stage, True), egnn_sp.stage_fns(stage, False)
        with torch.no_grad():
            got = fwd(stage, full, rows, row0, 29)
            want = fwd_p(stage, full, rows, row0, 29)
        torch.cuda.synchronize()
        _assert_within(got, want, TILED_RTOL, f"{type(stage).__name__} forward")
        g = torch.from_numpy(rng.standard_normal(tuple(got.shape)).astype(np.float32)).to(card)
        got = bwd(stage, full, rows, row0, 29, g)
        want = bwd_p(stage, full, rows, row0, 29, g)
        torch.cuda.synchronize()
        names = ["dh", "dx", "dx0", "dh_rows", "dx_rows", "dx0_rows"] + \
            [f"w{k}" for k in range(len(want[6]))]
        for name, a, b in zip(names, [*got[:6], *got[6]], [*want[:6], *want[6]]):
            _assert_within(a, b, BWD_RTOL, f"{type(stage).__name__} {name}")


@pytest.mark.parametrize("variant", VARIANTS)
def test_sp_kernels_over_every_row_are_the_tiled_kernels(card, variant):
    """With the slab = every row (row0 0, S = N, its own copies of the
    tensors), #6 runs #3's and #4's arithmetic: bit-identical outputs; #7's
    weight gradients are #5's bit for bit, and its two views' dh, dx, dx0
    add up to #5's (there summed in another order)."""
    block = _block(card, **variant)
    n = 80
    full = _inputs(card, 3, n, 32, (80, 61, 72))
    rows = [t.clone() for t in full]
    gh, gx = _cotangents(card, 3, n, 32)
    for stage, tiled, g in ((block.gcl_0, "gcl_rows", gh), (block.gcl_equiv, "coord_rows", gx)):
        fwd, bwd = egnn_sp.stage_fns(stage, True)
        with torch.no_grad():
            assert torch.equal(fwd(stage, full, rows, 0, n),
                               getattr(egnn_tiled, f"{tiled}_cuda")(stage, *full)), tiled
        got = bwd(stage, full, rows, 0, n, g)
        want = getattr(egnn_tiled, f"{tiled}_backward_cuda")(stage, *full, g)
        torch.cuda.synchronize()
        for k, (a, b) in enumerate(zip(got[6], want[3])):
            assert torch.equal(a, b), f"{tiled} weight {k}"
        for k, name in enumerate(("dh", "dx", "dx0")):
            _assert_within(got[k] + got[3 + k], want[k], BWD_RTOL, f"{tiled} {name}")


@pytest.mark.parametrize("n,s,row0", SP_SLABS)
def test_sp_gcl_backward_from_the_forward_chain_is_bit_identical(card, n, s, row0):
    """#7 on a GCL from the slab's node chain #6 kept (the SP training route)
    gives the same bits as #7 running the chain itself; #6's output is the
    same whether it keeps the chain or not."""
    block = _block(card)
    full, rows = _sp_views(card, n, s, row0, (n, n - 7))
    fwd, bwd = egnn_sp.stage_fns(block.gcl_0, True)
    with torch.no_grad():
        h, chain = fwd(block.gcl_0, full, rows, row0, n, keep_chain=True)
        assert chain.shape == (3, 2, s, 32)
        assert torch.equal(h, fwd(block.gcl_0, full, rows, row0, n))
    g = torch.from_numpy(np.random.default_rng(n + row0).standard_normal(
        tuple(h.shape)).astype(np.float32)).to(card)
    own = bwd(block.gcl_0, full, rows, row0, n, g)
    handed = bwd(block.gcl_0, full, rows, row0, n, g, chain=chain)
    torch.cuda.synchronize()
    for k, (a, b) in enumerate(zip([*own[:6], *own[6]], [*handed[:6], *handed[6]])):
        assert torch.equal(a, b), k


def test_sp_kernels_count_launches_and_refuse_what_they_cannot_hold(card):
    block = _block(card)
    full, rows = _sp_views(card, 24, 12, 12, (24, 17))
    counts = (egnn_sp.sp_gcl_rows_launches, egnn_sp.sp_coord_rows_launches,
              egnn_sp.sp_gcl_rows_bwd_launches, egnn_sp.sp_coord_rows_bwd_launches)
    h = egnn_sp.sp_gcl_rows_cuda(block.gcl_0, full, rows, 12, 24)
    x = egnn_sp.sp_coord_rows_cuda(block.gcl_equiv, full, rows, 12, 24)
    egnn_sp.sp_gcl_rows_backward_cuda(block.gcl_0, full, rows, 12, 24, h)
    egnn_sp.sp_coord_rows_backward_cuda(block.gcl_equiv, full, rows, 12, 24, x)
    assert (egnn_sp.sp_gcl_rows_launches, egnn_sp.sp_coord_rows_launches,
            egnn_sp.sp_gcl_rows_bwd_launches, egnn_sp.sp_coord_rows_bwd_launches) == \
        tuple(c + 1 for c in counts)
    with pytest.raises(ValueError, match="must lie in the N=24 columns"):
        egnn_sp.sp_gcl_rows_cuda(block.gcl_0, full, rows, 13, 24)
    with pytest.raises(ValueError, match="mean_div"):
        egnn_sp.sp_coord_rows_cuda(block.gcl_equiv, full, rows, 12, 0)
    with pytest.raises(ValueError, match="x_rows has shape"):
        egnn_sp.sp_gcl_rows_cuda(block.gcl_0, full, [rows[0], rows[1][:, :6], *rows[2:]], 12, 24)
    with pytest.raises(ValueError, match="g_out has shape"):
        egnn_sp.sp_gcl_rows_backward_cuda(block.gcl_0, full, rows, 12, 24, x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        egnn_sp.sp_gcl_rows_cuda(block.gcl_0, [t.cpu() for t in full], rows, 12, 24)


@pytest.mark.parametrize("n,sizes", [(80, (80, 69)), (45, (45, 40))])
def test_sp_egnn_on_one_card_matches_one_rank(card, n, sizes):
    """Two ranks share the card over gloo (collectives staged through host
    memory) and run the EGNN's blocks with #6/#7: outputs and the gradients
    of h, x and every weight match the single-device card path (#3-#5 at
    N=80, #1/#2 at N=45), every rank alike."""
    from geoldm_tpu_torch.nn.egnn import EGNN

    d = dict(in_node_nf=6, out_node_nf=6, hidden_nf=32, n_layers=2, normalization_factor=100.0)
    egnn = EGNN(EGNNConfig(**d))
    init_parameters(egnn, torch.Generator().manual_seed(5))
    rng = np.random.default_rng(6)
    mask = (np.arange(n)[None] < np.asarray(sizes)[:, None]).astype(np.float32)[..., None]
    case = {"cfg": d, "state": {k: v.numpy() for k, v in egnn.state_dict().items()},
            "h": rng.standard_normal((2, n, 6)).astype(np.float32) * mask,
            "x": rng.standard_normal((2, n, 3)).astype(np.float32) * mask, "mask": mask,
            "gh": rng.standard_normal((2, n, 6)).astype(np.float32),
            "gx": rng.standard_normal((2, n, 3)).astype(np.float32)}
    (want,) = torch_port_sp_ranks.egnn_cases([case], "cuda")
    (got,) = sharding.spawn(1, 2, torch_port_sp_ranks.egnn_cases, ([case], "cuda"),
                            device="cuda")
    assert got["ranks_agree"]
    assert got["launches"]["sp_gcl_rows_bwd"] == got["launches"]["sp_coord_rows_bwd"] == 2
    for name in ("h", "x"):
        _assert_within(torch.from_numpy(got[name]), torch.from_numpy(want[name]), BWD_RTOL, name)
    for name, g in want["grads"].items():
        ref = torch.from_numpy(g)
        err = float((torch.from_numpy(got["grads"][name]) - ref).abs().max())
        assert err <= BWD_RTOL * max(1e-6, float(ref.abs().max())), (name, err)


def test_nccl_collectives_take_host_tensors(card, tmp_path):
    """An NCCL group of one rank on the card (the backend of one card per
    rank): a host tensor, as the packed NLL's totals are, is summed on the
    card and comes back to the host; slab rows are gathered alike."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
                            world_size=1)
    try:
        grp = sharding.RankGroup(0, 1, "nccl", torch.device("cuda", torch.cuda.current_device()))
        totals = torch.tensor([1.5, -2.25], dtype=torch.float64)
        out = sharding.all_reduce(totals, grp)
        assert out.device.type == "cpu" and torch.equal(out, totals)
        rows = torch.arange(6.0).reshape(1, 3, 2)
        out = sp.all_gather_rows(rows, grp)
        assert out.device.type == "cpu" and torch.equal(out, rows)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Evaluation and resume on the card
# ---------------------------------------------------------------------------


class _Replay:
    """A noise source replaying one numpy stream, so the card and the CPU
    draw the same numbers in the same order."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def __call__(self, shape):
        return self.rng.standard_normal(shape).astype(np.float32)

    def randint(self, low, high, shape):
        return self.rng.integers(low, high, shape)


def _qm9_tiny(seed=1):
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.models import factory

    info = get_dataset_info("qm9")
    cfg = factory.make_latent_diffusion_config(info, nf=32, n_layers=2, latent_nf=2,
                                               diffusion_steps=20, trainable_ae=True)
    return info, cfg, factory.build_model(cfg, "cpu", torch.Generator().manual_seed(seed))


def test_packed_nll_on_the_card_matches_the_cpu(card, tmp_path):
    """Two passes (augment noise on) over a 7-molecule split in batches of
    3 through kernel #1 against the same passes on the CPU with the same
    draws: per-pass means within the denoiser gate 2e-4 * max(1, |ref|)."""
    import copy

    from geoldm_tpu_torch.data.qm9 import load_qm9
    from geoldm_tpu_torch.data.synthetic import write_qm9_splits
    from geoldm_tpu_torch.models.distributions import DistributionNodes
    from geoldm_tpu_torch.train.trainer import evaluate_nll_packed

    info, cfg, model = _qm9_tiny()
    write_qm9_splits(str(tmp_path), info, {"train": 4, "valid": 7, "test": 4}, seed=5)
    split = load_qm9(str(tmp_path))[0]["valid"]
    means = {}
    for dev in ("cpu", card):
        launches = egnn_block.launches
        means[str(dev)] = evaluate_nll_packed(
            copy.deepcopy(model).to(dev), cfg, split, DistributionNodes(info.n_nodes),
            [_Replay(10), _Replay(11)], batch_size=3, pad_nodes=info.max_n_nodes,
            augment_noise=0.2)
        if dev is card:
            # 3 batches x 2 passes x (encoder 1 + decoder 2 + 2 denoiser passes x 2) blocks.
            assert egnn_block.launches - launches == 3 * 2 * 7
    for want, got in zip(means["cpu"], means["cuda"]):
        assert abs(got - want) <= 2e-4 * max(1.0, abs(want)), (got, want)


def test_resume_on_the_card_reproduces_the_saved_state(card, tmp_path):
    """Two train steps on the card, a checkpoint, then a state built from
    other weights loads it: the same digest (model, EMA, AdamW, clip, step);
    one more step on the same batch and noise keeps both bit-identical."""
    from geoldm_tpu_torch.cli.main_qm9 import parse_args
    from geoldm_tpu_torch.data.synthetic import synthetic_batch
    from geoldm_tpu_torch.models import factory
    from geoldm_tpu_torch.models.distributions import DistributionNodes
    from geoldm_tpu_torch.train.train_step import create_train_state, make_train_step
    from geoldm_tpu_torch.train.trainer import prepare_batch
    from geoldm_tpu_torch.utils import checkpoint as ckpt

    info, cfg, _ = _qm9_tiny()
    nodes = DistributionNodes(info.n_nodes)
    batches = [prepare_batch(synthetic_batch(info, 4, 29, np.random.default_rng(s)), nodes, card)
               for s in range(3)]
    states = [create_train_state(factory.build_model(cfg, card, torch.Generator().manual_seed(s)),
                                 cfg, 1e-3, ema_decay=0.99) for s in (1, 2)]
    step = make_train_step(cfg, 0.99)
    for batch in batches[:2]:
        step(states[0], batch, torch.Generator(device=card).manual_seed(3))
    ckpt.save_checkpoint(str(tmp_path), states[0],
                         parse_args(["--train_diffusion", "--trainable_ae"]), 0.99)
    ckpt.load_train_state(str(tmp_path), states[1])
    assert sp.state_digest(states[1]) == sp.state_digest(states[0])
    for s in states:
        step(s, batches[2], torch.Generator(device=card).manual_seed(4))
    assert states[1].step == 3 and sp.state_digest(states[1]) == sp.state_digest(states[0])


# ---------------------------------------------------------------------------
# The bf16 variants of #1, #3 and #4 (bf16 operands, f32 accumulation)
# against their plain versions (each product's operands rounded to bf16 on
# the card, f32 products). A rounding that sits at a tie flips by one bf16
# ulp (2^-8 relative) under another summation order, so the gate is
# BF16_RTOL * max(1, max|ref|), not the f32 kernels' 1e-4. That gate is
# loose against the rounding itself, so each case also holds the variant
# SEPARATION times closer, on the mean, to its plain bf16 version than to
# the plain f32 one (tests/torch_port_bf16_sites.py), and
# test_bf16_kernels_round_every_site than to a plain version that leaves
# one rounding site in f32.
# ---------------------------------------------------------------------------

BF16_RTOL = 5e-3
BF16 = torch.bfloat16


def _assert_bf16_close(got, want, what, want_f32=None):
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= BF16_RTOL * scale, f"{what}: max|d|={err:.3e} > {BF16_RTOL}*{scale:.3g}"
    if want_f32 is not None:
        assert_separated(got, want, want_f32, f"{what} vs the plain f32 version")


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("n,n_real,hidden", [(9, (5, 9), 32), (24, (24, 17), 64),
                                             (40, (33, 40), 256), (64, (64, 50), 512),
                                             (29, (29, 22), 192)])
def test_bf16_block_kernel_matches_plain(card, variant, n, n_real, hidden):
    block = _block(card, hidden=hidden, **variant)
    args = _inputs(card, 2, n, hidden, n_real)
    before = (egnn_block.launches, egnn_block.bf16_launches)
    with torch.no_grad():
        h_k, x_k = egnn_block.block_forward_cuda(block, *args, compute_dtype=BF16)
        h_p, x_p = egnn_block.block_forward_plain(block, *args, compute_dtype=BF16)
        h_f, _ = egnn_block.block_forward_plain(block, *args)
    torch.cuda.synchronize()
    assert (egnn_block.launches, egnn_block.bf16_launches) == (before[0], before[1] + 1)
    _assert_bf16_close(h_k, h_p, "h", h_f)
    _assert_bf16_close(x_k, x_p, "x")


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("n,n_real,hidden", [(9, (5, 9), 32), (65, (65, 49), 64),
                                             (100, (100, 83), 256), (184, (184, 150), 256),
                                             (130, (130, 70), 512)])
def test_bf16_tiled_kernels_match_plain(card, variant, n, n_real, hidden):
    block = _block(card, hidden=hidden, **variant)
    h, x, x0, mask = _inputs(card, 2, n, hidden, n_real)
    counts = (egnn_tiled.gcl_rows_launches, egnn_tiled.gcl_rows_bf16_launches,
              egnn_tiled.coord_rows_launches, egnn_tiled.coord_rows_bf16_launches)
    with torch.no_grad():
        got = egnn_tiled.gcl_rows_cuda(block.gcl_0, h, x, x0, mask, compute_dtype=BF16)
        want = egnn_tiled.gcl_rows_plain(block.gcl_0, h, x, x0, mask, compute_dtype=BF16)
        _assert_bf16_close(got, want, "gcl",
                           egnn_tiled.gcl_rows_plain(block.gcl_0, h, x, x0, mask))
        got = egnn_tiled.coord_rows_cuda(block.gcl_equiv, want, x, x0, mask, compute_dtype=BF16)
        want_f32 = egnn_tiled.coord_rows_plain(block.gcl_equiv, want, x, x0, mask)
        want = egnn_tiled.coord_rows_plain(block.gcl_equiv, want, x, x0, mask,
                                           compute_dtype=BF16)
    torch.cuda.synchronize()
    _assert_bf16_close(got, want, "coord", want_f32)
    assert (egnn_tiled.gcl_rows_launches, egnn_tiled.gcl_rows_bf16_launches,
            egnn_tiled.coord_rows_launches, egnn_tiled.coord_rows_bf16_launches) == (
        counts[0], counts[1] + 1, counts[2], counts[3] + 1)


@pytest.mark.parametrize("site", SITES)
@pytest.mark.parametrize("n,hidden", [(32, 256), (184, 256)])
def test_bf16_kernels_round_every_site(card, site, n, hidden):
    """Each variant rounds the edge features and the one-output products (the
    gate, the coordinate scale) as its plain version does: it is SEPARATION
    times closer to that than to a plain version that leaves the site in
    f32. normalization_factor 1 (the GEOM recipe's) keeps the coordinate
    updates large against x's own rounding; coordinates spread as a
    molecule's in Angstrom (std 3) give the edge features their weight.
    #1's x is held for the coordinate scale w3, which only x shows; its
    edge features come from the tile builder the GCLs share
    (csrc/egnn_block_tile.cuh), which h holds, while x also carries the
    coordinate path's own accumulation noise."""
    block = EquivariantBlock(EGNNConfig(in_node_nf=2, out_node_nf=2, hidden_nf=hidden,
                                        n_layers=1, normalization_factor=1.0))
    init_parameters(block, torch.Generator().manual_seed(0))
    block = block.to(card)
    E = block.cfg.edge_feat_nf
    h, x, x0, mask = _inputs(card, 4, n, hidden, (n, n - 3, n - 9, n - 16), seed=5)
    x, x0 = 3.0 * x, 3.0 * x0
    with torch.no_grad():
        if n <= egnn_block.MAX_NODES:
            got = egnn_block.block_forward_cuda(block, h, x, x0, mask, compute_dtype=BF16)
            want = egnn_block.block_forward_plain(block, h, x, x0, mask, compute_dtype=BF16)
            with unrounded(site, E):
                other = egnn_block.block_forward_plain(block, h, x, x0, mask, compute_dtype=BF16)
            cases = list(zip(("h", "x"), got, want, other))[:2 if site == "gate" else 1]
        else:
            got_h = egnn_tiled.gcl_rows_cuda(block.gcl_0, h, x, x0, mask, compute_dtype=BF16)
            got_x = egnn_tiled.coord_rows_cuda(block.gcl_equiv, h, x, x0, mask, compute_dtype=BF16)
            want, other = [], []
            for ctx, out in ((contextlib.nullcontext(), want), (unrounded(site, E), other)):
                with ctx:
                    out.append(egnn_tiled.gcl_rows_plain(block.gcl_0, h, x, x0, mask,
                                                         compute_dtype=BF16))
                    out.append(egnn_tiled.coord_rows_plain(block.gcl_equiv, h, x, x0, mask,
                                                           compute_dtype=BF16))
            cases = zip(("gcl", "coord"), (got_h, got_x), want, other)
    for what, g, w, o in cases:
        _assert_bf16_close(g, w, what)
        assert_separated(g, w, o, f"{what} vs the plain version with {site} in f32")


def test_bf16_variants_replay_and_refuse_autograd(card):
    """(Named for the refusal it held before bf16 training.) The bf16
    variants replay bit for bit, and under grad the block goes through its
    bf16 Function: the outputs carry a grad_fn and the backward, a bf16
    kernel (#2, or #5 past 64 nodes), gives every weight a gradient."""
    block = _block(card, hidden=64)
    for n in (29, 96):
        args = _inputs(card, 3, n, 64, (n, n - 7, 3))
        with torch.no_grad():
            first = egnn_block.block_forward(block, *args, compute_dtype=BF16)
            second = egnn_block.block_forward(block, *args, compute_dtype=BF16)
        assert all(torch.equal(a, b) for a, b in zip(first, second))
        block.zero_grad(set_to_none=True)
        counts = (egnn_block.bwd_bf16_launches, egnn_tiled.gcl_rows_bwd_bf16_launches)
        h_out, x_out = egnn_block.block_forward(block, *args, compute_dtype=BF16)
        assert h_out.grad_fn is not None and x_out.grad_fn is not None
        (h_out.square().sum() + x_out.square().sum()).backward()
        assert all(p.grad is not None and bool(p.grad.isfinite().all())
                   for p in block.parameters())
        assert (egnn_block.bwd_bf16_launches, egnn_tiled.gcl_rows_bwd_bf16_launches) == (
            (counts[0] + 1, counts[1]) if n <= 64 else (counts[0], counts[1] + 1))


def test_bf16_egnn_runs_the_bf16_kernels_only(card):
    from geoldm_tpu_torch.nn.egnn import EGNN
    from geoldm_tpu_torch.ops import kernel_launches, reset_kernel_launches

    cfg = EGNNConfig(in_node_nf=3, out_node_nf=3, hidden_nf=64, n_layers=3,
                     normalization_factor=1.0)
    egnn = EGNN(cfg)
    init_parameters(egnn, torch.Generator().manual_seed(2))
    egnn = egnn.to(card)
    for n in (24, 80):
        h, x, _, mask = _inputs(card, 2, n, 3, (n, n - 5))
        reset_kernel_launches()
        with torch.no_grad():
            h_k, x_k = egnn(h, x, mask, BF16)
            egnn_cpu = egnn.to("cpu")
            h_p, x_p = egnn_cpu(h.cpu(), x.cpu(), mask.cpu(), BF16)
            egnn = egnn_cpu.to(card)
        counts = {k: v for k, v in kernel_launches().items() if v}
        want = {"egnn_block_bf16": 3} if n <= 64 else {"gcl_rows_bf16": 3, "coord_rows_bf16": 3}
        assert counts == want, counts
        _assert_bf16_close(h_k.cpu(), h_p, "h")
        _assert_bf16_close(x_k.cpu(), x_p, "x")


# ---------------------------------------------------------------------------
# bf16 backward kernels (#2, #5, #7; #6's bf16 forward): each against its
# plain bf16 backward (autograd through the plain bf16 forward), every output
# within BF16_RTOL * max(1, max|ref|) (a weight gradient's one-step rounding
# flips excepted, tests/torch_port_bf16_sites.py:bf16_grads_report), on the
# mean SEPARATION times closer to it than to the plain f32 backward and, at
# the recipes' width H=256, to a plain backward that rounds each product's
# cotangent (site 'cotangent': that rounding moves a product's sum over its
# H terms by ~2^-9 / sqrt(H) before the result is rounded again, so its trace
# shrinks with H; at H=64 the coordinate stage's falls to ~8x the kernel's
# own sum-order noise); a replay and the training routes bit-identical.
# ---------------------------------------------------------------------------


def _assert_bf16_report(what, names, got, want, want_f32, want_cot=None):
    if want_cot is not None and got[0].shape[-1] < 256:
        want_cot = None  # the cotangent site is held at the recipes' width (above)
    r = bf16_grads_report(names, got, want, want_f32, want_cot, BF16_RTOL)
    assert not r["problems"], f"{what}: {r['problems']}"


def _flat_grads(r, k=3):
    return [*r[:k], *r[k]]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("n,n_real,hidden,b", [(9, (5, 9), 64, 4), (29, (29, 17, 24, 12), 256, 4),
                                               (29, (29, 20, 25, 16), 192, 4)])
def test_bf16_block_backward_kernel_matches_plain(card, variant, n, n_real, hidden, b):
    block = _block(card, hidden=hidden, **variant)
    args = _inputs(card, b, n, hidden, (n_real * b)[:b])
    cots = _cotangents(card, b, n, hidden)
    before = (egnn_block.bwd_launches, egnn_block.bwd_bf16_launches)
    got = _flat_grads(egnn_block.block_backward_cuda(block, *args, *cots, compute_dtype=BF16))
    assert (egnn_block.bwd_launches, egnn_block.bwd_bf16_launches) == (before[0], before[1] + 1)
    with torch.no_grad():
        _, _, saved = egnn_block._forward_launch(block, *args, save=True, bf16=True)
    via_saved = _flat_grads(egnn_block._backward_launch(block, *args, *cots, saved, True))
    again = _flat_grads(egnn_block.block_backward_cuda(block, *args, *cots, compute_dtype=BF16))
    assert all(torch.equal(a, c) and torch.equal(a, d) for a, c, d in zip(got, via_saved, again))
    want = _flat_grads(egnn_block.block_backward_plain(block, *args, *cots, compute_dtype=BF16))
    want_f32 = _flat_grads(egnn_block.block_backward_plain(block, *args, *cots))
    with unrounded("cotangent", block.cfg.edge_feat_nf):
        want_cot = _flat_grads(egnn_block.block_backward_plain(block, *args, *cots,
                                                               compute_dtype=BF16))
    names = ["dh", "dx", "dx0"] + egnn_block.block_param_names(block)
    _assert_bf16_report("#2 bf16", names, got, want, want_f32, want_cot)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("n,n_real,hidden", [(65, (65, 49, 60), 64), (184, (184, 150, 170), 256)])
def test_bf16_tiled_backward_kernels_match_plain(card, variant, n, n_real, hidden):
    block = _block(card, hidden=hidden, **variant)
    args = _inputs(card, 3, n, hidden, n_real)
    gh, gx = _cotangents(card, 3, n, hidden)
    E = block.cfg.edge_feat_nf
    for stage, mod, g in (("gcl_rows", block.gcl_0, gh), ("coord_rows", block.gcl_equiv, gx)):
        cuda_fn = getattr(egnn_tiled, f"{stage}_backward_cuda")
        plain_fn = getattr(egnn_tiled, f"{stage}_backward_plain")
        got = _flat_grads(cuda_fn(mod, *args, g, compute_dtype=BF16))
        assert all(torch.equal(a, b) for a, b in
                   zip(got, _flat_grads(cuda_fn(mod, *args, g, compute_dtype=BF16))))
        if stage == "gcl_rows":
            with torch.no_grad():
                chain = egnn_tiled.gcl_rows_cuda(mod, *args, keep_chain=True,
                                                 compute_dtype=BF16)[1]
            handed = _flat_grads(cuda_fn(mod, *args, g, chain=chain, compute_dtype=BF16))
            assert all(torch.equal(a, b) for a, b in zip(got, handed))
        want = _flat_grads(plain_fn(mod, *args, g, compute_dtype=BF16))
        want_f32 = _flat_grads(plain_fn(mod, *args, g))
        with unrounded("cotangent", E):
            want_cot = _flat_grads(plain_fn(mod, *args, g, compute_dtype=BF16))
        names = ["dh", "dx", "dx0"] + egnn_tiled.stage_weight_names(mod)
        _assert_bf16_report(f"#5 bf16 {stage}", names, got, want, want_f32, want_cot)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("n,s,row0,hidden", [(24, 12, 12, 64), (130, 65, 0, 64),
                                             (184, 92, 92, 256)])
def test_bf16_sp_kernels_match_plain(card, variant, n, s, row0, hidden):
    """#6 bf16 (forward) and #7 bf16 on the slab row0..row0+s, 'mean' over
    an SP-padded N (n - 2), against their plain bf16 versions."""
    block = _block(card, hidden=hidden, **variant)
    full = _inputs(card, 3, n, hidden, (n, n - 7, n - 20))
    rows = [t[:, row0:row0 + s].contiguous() for t in full]
    mean_div = n - 2
    rng = np.random.default_rng(row0 + n)
    E = block.cfg.edge_feat_nf
    for stage in (block.gcl_0, block.gcl_equiv):
        (fwd, bwd), (fwd_p, bwd_p) = egnn_sp.stage_fns(stage, True), egnn_sp.stage_fns(stage, False)
        with torch.no_grad():
            got = fwd(stage, full, rows, row0, mean_div, compute_dtype=BF16)
            want = fwd_p(stage, full, rows, row0, mean_div, compute_dtype=BF16)
            want_f32 = fwd_p(stage, full, rows, row0, mean_div)
        _assert_bf16_report("#6 bf16", ["out"], [got], [want], [want_f32])
        g = torch.from_numpy(rng.standard_normal(tuple(got.shape)).astype(np.float32)).to(card)
        got = _flat_grads(bwd(stage, full, rows, row0, mean_div, g, compute_dtype=BF16), 6)
        again = _flat_grads(bwd(stage, full, rows, row0, mean_div, g, compute_dtype=BF16), 6)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        if stage is block.gcl_0:
            with torch.no_grad():
                chain = fwd(stage, full, rows, row0, mean_div, keep_chain=True,
                            compute_dtype=BF16)[1]
            handed = _flat_grads(bwd(stage, full, rows, row0, mean_div, g, chain=chain,
                                     compute_dtype=BF16), 6)
            assert all(torch.equal(a, b) for a, b in zip(got, handed))
        want = _flat_grads(bwd_p(stage, full, rows, row0, mean_div, g, compute_dtype=BF16), 6)
        want_f32 = _flat_grads(bwd_p(stage, full, rows, row0, mean_div, g), 6)
        with unrounded("cotangent", E):
            want_cot = _flat_grads(bwd_p(stage, full, rows, row0, mean_div, g,
                                         compute_dtype=BF16), 6)
        names = ["dh", "dx", "dx0", "dh_rows", "dx_rows", "dx0_rows"] + \
            egnn_sp.stage_weight_names(stage)
        _assert_bf16_report(f"#7 bf16 {type(stage).__name__}", names, got, want, want_f32,
                            want_cot)


@pytest.mark.parametrize("site", BWD_SITES)
@pytest.mark.parametrize("n", [32, 184])
def test_bf16_backward_kernels_round_every_site(card, site, n):
    """Each bf16 backward rounds what its plain version rounds: on the mean
    SEPARATION times closer to it than to a plain backward that leaves the
    edge features or the one-output products in f32, or that rounds the
    cotangents (bf16_grads_report's separation, with the site's version in
    the f32 version's place). GEOM recipe width, normalization_factor 1,
    coordinates spread as a molecule's (std 3)."""
    block = EquivariantBlock(EGNNConfig(in_node_nf=2, out_node_nf=2, hidden_nf=256,
                                        n_layers=1, normalization_factor=1.0))
    init_parameters(block, torch.Generator().manual_seed(0))
    block = block.to(card)
    E = block.cfg.edge_feat_nf
    h, x, x0, mask = _inputs(card, 4, n, 256, (n, n - 3, n - 9, n - 16), seed=5)
    x, x0 = 3.0 * x, 3.0 * x0
    gh, gx = _cotangents(card, 4, n, 256)
    if n <= egnn_block.MAX_NODES:
        runs = [("#2", ["dh", "dx", "dx0"] + egnn_block.block_param_names(block),
                 lambda: egnn_block.block_backward_cuda(block, h, x, x0, mask, gh, gx,
                                                        compute_dtype=BF16),
                 lambda: egnn_block.block_backward_plain(block, h, x, x0, mask, gh, gx,
                                                         compute_dtype=BF16))]
    else:
        runs = [(f"#5 {stage}", ["dh", "dx", "dx0"] + egnn_tiled.stage_weight_names(mod),
                 lambda m=mod, s=stage, g=g: getattr(egnn_tiled, f"{s}_backward_cuda")(
                     m, h, x, x0, mask, g, compute_dtype=BF16),
                 lambda m=mod, s=stage, g=g: getattr(egnn_tiled, f"{s}_backward_plain")(
                     m, h, x, x0, mask, g, compute_dtype=BF16))
                for stage, mod, g in (("gcl_rows", block.gcl_0, gh),
                                      ("coord_rows", block.gcl_equiv, gx))]
    for what, names, kernel, plain in runs:
        got, want = _flat_grads(kernel()), _flat_grads(plain())
        with unrounded(site, E):
            other = _flat_grads(plain())
        _assert_bf16_report(f"{what} vs the plain version with {site} otherwise", names, got,
                            want, other)


def test_bf16_egnn_under_grad_runs_the_bf16_kernels_only(card):
    """An EGNN in bf16 under grad launches the bf16 forward and backward
    kernels and no f32 one: per block one #1 bf16 and one #2 bf16 (N <= 64),
    or #3 bf16 twice (the backward's re-run keeps the chain), #4 bf16 once
    and #5 bf16 once per stage; its gradients match the CPU's plain bf16
    path within the bf16 gate (weight gradients but for their one-step
    rounding flips, at most ``flips_allowed`` at FLIP_SHARE: 27.6 % of a
    192-element weight read on an H100 80GB HBM3 at 700 W)."""
    from geoldm_tpu_torch.nn.egnn import EGNN
    from geoldm_tpu_torch.ops import kernel_launches, reset_kernel_launches

    cfg = EGNNConfig(in_node_nf=3, out_node_nf=3, hidden_nf=64, n_layers=3,
                     normalization_factor=1.0)
    egnn = EGNN(cfg)
    init_parameters(egnn, torch.Generator().manual_seed(2))
    for n in (24, 80):
        h, x, _, mask = _inputs(card, 2, n, 3, (n, n - 5))
        grads = {}
        for dev in (card, torch.device("cpu")):
            model = egnn.to(dev)
            model.zero_grad(set_to_none=True)
            reset_kernel_launches()
            h_o, x_o = model(h.to(dev), x.to(dev), mask.to(dev), BF16)
            (h_o.square().sum() + x_o.square().sum()).backward()
            grads[dev.type] = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
            if dev.type == "cuda":
                counts = {k: v for k, v in kernel_launches().items() if v}
        want = ({"egnn_block_bf16": 3, "egnn_block_bwd_bf16": 3} if n <= 64 else
                {"gcl_rows_bf16": 6, "coord_rows_bf16": 3, "gcl_rows_bwd_bf16": 3,
                 "coord_rows_bwd_bf16": 3})
        assert counts == want, counts
        for k, g in grads["cpu"].items():
            got = grads["cuda"][k]
            flips = bf16_flips(got, g) if k.endswith("weight") else torch.zeros_like(g, dtype=bool)
            assert int(flips.sum()) <= flips_allowed(g.numel(), FLIP_SHARE), k
            _assert_bf16_close(got.masked_fill(flips, 0.0), g.masked_fill(flips, 0.0), k)


# ---------------------------------------------------------------------------
# The conditional model: context channels through the denoiser's blocks
# ---------------------------------------------------------------------------


def test_conditional_denoiser_on_the_card_matches_the_cpu(card):
    """A conditional denoiser at the conditional recipe's width (nf=192, two
    layers, alpha and the guidance indicator as context) through #1 on the
    card against the plain path on the CPU, within the denoiser gate 2e-4 *
    max(1, max|ref|); guided at w=2 it calls the denoiser twice (2 * 2
    launches of #1), at w=1 once, and the guided eps agrees too."""
    import copy

    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.diffusion import vdm
    from geoldm_tpu_torch.models import factory
    from geoldm_tpu_torch.ops.com import remove_mean_with_mask

    cfg = factory.make_latent_diffusion_config(
        get_dataset_info("qm9"), nf=192, n_layers=2, latent_nf=1, diffusion_steps=20,
        context_node_nf=1, context_indicator=True)
    model = factory.build_model(cfg, "cpu", torch.Generator().manual_seed(3))
    rng = np.random.default_rng(4)
    b, n = 6, 29
    mask = (np.arange(n)[None, :] < rng.integers(18, n + 1, size=b)[:, None]).astype(
        np.float32)[..., None]
    z = torch.from_numpy(rng.standard_normal((b, n, 4)).astype(np.float32) * mask)
    mask_t = torch.from_numpy(mask)
    z[:, :, :3] = remove_mean_with_mask(z[:, :, :3], mask_t)
    ctx = np.concatenate([np.broadcast_to(rng.standard_normal((b, 1, 1)), (b, n, 1)),
                          np.ones((b, n, 1))], axis=2).astype(np.float32) * mask
    t = torch.from_numpy(rng.uniform(0, 1, (b, 1)).astype(np.float32))
    ctx_t = torch.from_numpy(ctx)
    on_card = copy.deepcopy(model).to(card)
    args_card = (t.to(card), z.to(card), mask_t.to(card))
    with torch.no_grad():
        for w, calls in ((1.0, 1), (2.0, 2)):
            before = egnn_block.launches
            got = vdm.guided_eps(on_card.dynamics, *args_card, ctx_t.to(card), None, w)
            torch.cuda.synchronize()
            assert egnn_block.launches - before == calls * 2
            want = vdm.guided_eps(model.dynamics, t, z, mask_t, ctx_t, None, w)
            scale = max(1.0, float(want.abs().max()))
            assert float((got.cpu() - want).abs().max()) <= 2e-4 * scale, w
