"""The low-precision variants of the EquivariantBlock kernels (#1/#2 with the
edge chain in bf16: ``nn.core.BF16_EDGE_LOWP``, JAX's
``GEOLDM_PALLAS_EDGE_LOWP=1`` under ``bfloat16_pallas``) against their plain
versions on the card, every block variant at small shapes; the saved-chain
route, replays and the autograd Function; the routing that keeps the bf16
kernels where JAX routes a molecule to its row-tiled kernels. Imports no
jax:

    python -m pytest tests/test_torch_port_cuda_lowp.py -q -m cuda

Skips where torch.cuda is unavailable (the kernels have no CPU mode).

Gates (tests/torch_port_bf16_sites.py, as the bf16 variants'): every output
within RTOL * max(1, max|ref|) of the plain low-precision version, the
one-step bf16 flips of a gradient rounded once (the weights', and b2's and
the gate bias's, LOWP_ROUNDED) counted apart (FLIP_SHARE); on the mean
LOWP_SEPARATION times closer to it than to the plain bf16 version without
the chain. That factor is below the bf16 variants' 10: the plain versions
with and without the chain lie only about as far apart as bf16 from f32,
while a kernel's bf16 rounding flips (the f32 sum orders deciding ties)
count in the mean. Readings on an H100 over these cases: forward 6.7x at
the least (sin features, N=29, H=128; the sin/cos arguments carry the
largest f32 differences into the rounded pre-activation), backward 5.3x
(sin, N=40, H=96); at the QM9 recipe's shapes 23-42x and 8.5-11x
(chip_smoke.py phase 38)."""

import numpy as np
import pytest
import torch

from geoldm_tpu_torch.config import EGNNConfig
from geoldm_tpu_torch.nn.core import BF16_EDGE_LOWP
from geoldm_tpu_torch.nn.egnn import EquivariantBlock, init_parameters
from geoldm_tpu_torch.ops import egnn_block
from torch_port_bf16_sites import LOWP_ROUNDED, bf16_grads_report, mean_abs

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)

RTOL = 5e-3
LOWP_SEPARATION = 4.0
BF16 = torch.bfloat16
VARIANTS = [
    {}, {"attention": False}, {"sin_embedding": True}, {"inv_sublayers": 2},
    {"aggregation_method": "mean", "tanh": False}, {"normalization_factor": 100.0},
]
CASES = [(9, (5, 9), 32), (24, (24, 17), 64), (29, (29, 12, 21), 128), (40, (33, 40), 96)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(card, n, n_real, hidden, variant, seed=1):
    cfg = EGNNConfig(**{"in_node_nf": 2, "out_node_nf": 2, "hidden_nf": hidden, "n_layers": 1,
                        "normalization_factor": 1.0, **variant})
    block = EquivariantBlock(cfg)
    init_parameters(block, torch.Generator().manual_seed(seed))
    block = block.to(card)
    rng = np.random.default_rng(seed)
    b = len(n_real)
    mask = (np.arange(n)[None, :] < np.asarray(n_real)[:, None]).astype(np.float32)[..., None]
    arrays = [rng.standard_normal((b, n, hidden)) * mask, rng.standard_normal((b, n, 3)) * mask,
              rng.standard_normal((b, n, 3)) * mask, mask,
              rng.standard_normal((b, n, hidden)), rng.standard_normal((b, n, 3))]
    ts = [torch.from_numpy(a.astype(np.float32)).to(card) for a in arrays]
    return block, ts[:4], ts[4:]


def _flat(grads):
    return [*grads[:3], *grads[3]]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("n,n_real,hidden", CASES)
def test_lowp_forward_matches_plain(card, variant, n, n_real, hidden):
    block, args, _ = _case(card, n, n_real, hidden, variant)
    with torch.no_grad():
        got = egnn_block.block_forward_cuda(block, *args, compute_dtype=BF16_EDGE_LOWP)
        want = egnn_block.block_forward_plain(block, *args, compute_dtype=BF16_EDGE_LOWP)
        other = egnn_block.block_forward_plain(block, *args, compute_dtype=BF16)
    for g, w in zip(got, want):
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= RTOL * scale
    err = sum(mean_abs(g, w) for g, w in zip(got, want))
    dist = sum(mean_abs(g, o) for g, o in zip(got, other))
    assert LOWP_SEPARATION * err <= dist, (err, dist)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("n,n_real,hidden", CASES)
def test_lowp_backward_matches_plain(card, variant, n, n_real, hidden):
    block, args, cots = _case(card, n, n_real, hidden, variant)
    names = ["dh", "dx", "dx0"] + egnn_block.block_param_names(block)
    got = _flat(egnn_block.block_backward_cuda(block, *args, *cots,
                                               compute_dtype=BF16_EDGE_LOWP))
    want = _flat(egnn_block.block_backward_plain(block, *args, *cots,
                                                 compute_dtype=BF16_EDGE_LOWP))
    other = _flat(egnn_block.block_backward_plain(block, *args, *cots, compute_dtype=BF16))
    r = bf16_grads_report(names, got, want, other, rtol=RTOL, separation=LOWP_SEPARATION,
                          rounded=LOWP_ROUNDED)
    assert not r["problems"], r["problems"]


@pytest.mark.parametrize("n,n_real,hidden", CASES)
def test_lowp_saved_route_and_replay_are_bit_identical(card, n, n_real, hidden):
    """The forward saving its chain gives the forward's outputs; #2 from the
    saved chain, its recompute and a replay give the same bits."""
    block, args, cots = _case(card, n, n_real, hidden, {"inv_sublayers": 2})
    first = egnn_block.block_backward_cuda(block, *args, *cots, compute_dtype=BF16_EDGE_LOWP)
    second = egnn_block.block_backward_cuda(block, *args, *cots, compute_dtype=BF16_EDGE_LOWP)
    h_out, x_out, saved = egnn_block._forward_launch(block, *args, save=True, bf16=True,
                                                     lowp=True)
    via_saved = egnn_block._backward_launch(block, *args, *cots, saved, True, True)
    with torch.no_grad():
        h_k, x_k = egnn_block.block_forward_cuda(block, *args, compute_dtype=BF16_EDGE_LOWP)
    torch.cuda.synchronize()
    assert torch.equal(h_out, h_k) and torch.equal(x_out, x_k)
    for a, b, c in zip(_flat(first), _flat(second), _flat(via_saved)):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_lowp_function_launches_the_lowp_kernels(card):
    """Under grad a whole molecule runs the low-precision #1 (saving its
    chain) and #2; a size JAX routes to its row-tiled kernels (n=44) the bf16
    ones; every other counter stays."""
    from geoldm_tpu_torch.ops import kernel_launches, reset_kernel_launches

    for n, kernels in ((29, ("egnn_block_lowp", "egnn_block_bwd_lowp")),
                       (44, ("egnn_block_bf16", "egnn_block_bwd_bf16"))):
        block, (h, x, x0, mask), cots = _case(card, n, (n, n - 5), 64, {})
        reset_kernel_launches()
        hg = h.detach().requires_grad_()
        out = egnn_block.block_forward(block, hg, x, x0, mask, BF16_EDGE_LOWP)
        torch.autograd.backward(out, cots)
        torch.cuda.synchronize()
        counts = kernel_launches()
        assert {k: v for k, v in counts.items() if v} == dict.fromkeys(kernels, 1), (n, counts)
        want = egnn_block.block_backward_cuda(block, h, x, x0, mask, *cots,
                                              compute_dtype=egnn_block.block_operand(
                                                  n, 64, BF16_EDGE_LOWP))
        assert torch.equal(hg.grad, want[0])
