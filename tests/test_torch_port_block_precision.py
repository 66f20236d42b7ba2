"""The precision scheme of the whole-molecule EquivariantBlock kernels (#1,
#2): their edge-MLP products run on the tensor cores in split TF32 (each
operand x = hi + lo, both rounded to TF32; hi*hi + hi*lo + lo*hi summed in
float32, ``csrc/egnn_block_tile.cuh``). ``egnn_block.split_tf32_matmul``
emulates that rounding on the CPU. On the activations of the plain block at
the QM9 recipe widths (H=256, N=29, B=2, numpy-seeded inputs), each product
the kernels run -- silu(pre) W2^T (forward and the backward's recompute),
d(mm) W2 (backward) and the W2 gradient d(mm)^T silu(pre) over every edge --
stays within the kernels' gate, 1e-4 * max(1, max|ref|) of the float64
product, and within 1e-4 * max|ref| without the floor of 1, for the GCL and
the coordinate stage. One TF32 product alone keeps about 2^-11: measured
against its own size (1e-4 * max|ref|) it fails the gate on the forward and
the transposed products, and on the W2 gradient, a sum over every edge, its
error is still more than 100 times the split scheme's."""

import functools

import numpy as np
import pytest
import torch

from geoldm_tpu_torch.config import EGNNConfig
from geoldm_tpu_torch.nn.egnn import EquivariantBlock, init_parameters
from geoldm_tpu_torch.ops import egnn_block

GATE = 1e-4  # chip_smoke.py's _KERNEL_RTOL: kernel vs plain, per output tensor


def _one_tf32(a, b):
    return egnn_block.tf32_round(a) @ egnn_block.tf32_round(b)


@functools.lru_cache(maxsize=1)
def _activations():
    """{stage: (silu(pre) [E, H], d(mm) [E, H], W2 [H, H])} of the plain
    block at the recipe widths, E = B*N*N edges."""
    torch.manual_seed(0)
    B, N, H = 2, 29, 256
    cfg = EGNNConfig(in_node_nf=2, out_node_nf=2, hidden_nf=H, n_layers=9, attention=True,
                     normalization_factor=1.0)
    block = EquivariantBlock(cfg)
    init_parameters(block, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(2)
    n_real = np.array([29, 21])
    mask = (np.arange(N)[None, :] < n_real[:, None]).astype(np.float32)[..., None]
    h, x, x0 = (torch.from_numpy(rng.standard_normal((B, N, f)).astype(np.float32) * mask)
                for f in (H, 3, 3))
    gh, gx = (torch.from_numpy(rng.standard_normal((B, N, f)).astype(np.float32))
              for f in (H, 3))
    seen = {}

    def hook(name):
        def fn(lin, inputs, out):
            out.retain_grad()
            seen[name] = (inputs[0], out, lin.weight)
        return fn

    handles = [block.gcl_0.edge_mlp[2].register_forward_hook(hook("gcl")),
               block.gcl_equiv.coord_mlp[2].register_forward_hook(hook("coord"))]
    h_out, x_out = egnn_block.block_forward_plain(block, h, x, x0, torch.from_numpy(mask))
    (h_out * gh).sum().add_((x_out * gx).sum()).backward()
    for hd in handles:
        hd.remove()
    return {name: (a.detach().reshape(-1, H), mm.grad.reshape(-1, H), w.detach())
            for name, (a, mm, w) in seen.items()}


@pytest.fixture(scope="module")
def activations():
    return _activations()


def _products(acts, stage):
    """The three products of one edge stage as (a, b) operand pairs."""
    a, dmm, w2 = acts[stage]
    return {"forward silu(pre) W2^T": (a, w2.T), "backward d(mm) W2": (dmm, w2),
            "weight gradient d(mm)^T silu(pre)": (dmm.T, a)}


def _err(got, a, b):
    """(max|got - ref|, max|ref|) against the float64 product."""
    ref = a.double() @ b.double()
    return float((got.double() - ref).abs().max()), float(ref.abs().max())


@pytest.mark.parametrize("stage", ["gcl", "coord"])
@pytest.mark.parametrize("product", ["forward silu(pre) W2^T", "backward d(mm) W2",
                                     "weight gradient d(mm)^T silu(pre)"])
def test_split_tf32_product_passes_the_gate(activations, stage, product):
    a, b = _products(activations, stage)[product]
    assert a.dtype == torch.float32 and float(a.abs().max()) > 0 and float(b.abs().max()) > 0
    err, ref = _err(egnn_block.split_tf32_matmul(a, b), a, b)
    assert err <= GATE * max(1.0, ref), f"{stage} {product}: split TF32 max|d|={err:.3e}"
    assert err <= GATE * ref, f"{stage} {product}: split TF32 max|d|={err:.3e}, max|ref|={ref:.3e}"
    # It keeps about f32's accuracy.
    err32, _ = _err(a @ b, a, b)
    assert err <= 10 * err32, f"split TF32 {err:.3e} vs f32 {err32:.3e}"


@pytest.mark.parametrize("stage", ["gcl", "coord"])
@pytest.mark.parametrize("product", ["forward silu(pre) W2^T", "backward d(mm) W2"])
def test_one_tf32_product_fails_the_gate(activations, stage, product):
    a, b = _products(activations, stage)[product]
    err, ref = _err(_one_tf32(a, b), a, b)
    assert err > GATE * ref, f"{stage} {product}: one TF32 max|d|={err:.3e}, max|ref|={ref:.3e}"


@pytest.mark.parametrize("stage", ["gcl", "coord"])
def test_one_tf32_weight_gradient_is_far_less_accurate(activations, stage):
    a, b = _products(activations, stage)["weight gradient d(mm)^T silu(pre)"]
    err1, _ = _err(_one_tf32(a, b), a, b)
    err3, _ = _err(egnn_block.split_tf32_matmul(a, b), a, b)
    assert err1 > 100 * err3, f"{stage}: one TF32 {err1:.3e}, split TF32 {err3:.3e}"


def test_tf32_round_keeps_ten_mantissa_bits_ties_away_from_zero():
    one = 1.0
    ulp = 2.0 ** -10  # TF32's spacing at 1
    t = torch.tensor([one, one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2.0 ** -23,
                      one + 3 * ulp / 4, 3.0e-39, 0.0], dtype=torch.float32)
    want = [one, one + ulp, -(one + ulp), one, one + ulp]
    got = egnn_block.tf32_round(t)
    assert got[:5].tolist() == want
    assert float(got[6]) == 0.0
    bits = got.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    hi = egnn_block.tf32_round(t)
    lo = egnn_block.tf32_round(t - hi)
    # hi + lo recovers the float32 value to within 2^-22 of it.
    assert float(((hi.double() + lo.double()) - t.double()).abs().max()) <= 2.0 ** -22
