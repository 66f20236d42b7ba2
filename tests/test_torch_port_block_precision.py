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
error is still more than 100 times the split scheme's.

The row-tiled forward stages (#3 GCL, #4 coordinate update, and #6 on a
slab) run the same split-TF32 W2 product over 64-column windows of a row
(``csrc/egnn_rows.cuh``), and their projections and node MLP on the split-TF32
node GEMM (``csrc/egnn_tc_gemm.cuh``). At a GEOM shape (H=256, attention,
tanh, N=70 so a row crosses a window, ragged molecules, 'sum' and 'mean')
the stage emulated in the grid's order -- the W2 product, the projections
and the node MLP in split TF32 and each row's sums added window by window in
column order -- stays within the gate of the JAX row-tiled Pallas kernel run
in interpret mode, while one TF32 product fails the gate on the stage's W2
product there.

The row-tiled stage backward (#5, and #7 on a slab) runs its second layer,
its transposed product d(mm) W2 and its node products in split TF32 over
the same windows, and the W2 gradient as a split-K product over the edges
(``csrc/egnn_rows_bwd.cuh``, ``egnn_tc_gemm.cuh``). Emulated in that order,
with the row sums and the partials added window by window, every output of
the stage backward stays within the gate of the JAX kernel #5 (interpret
mode) at the same GEOM shape; one TF32 transposed product puts an output
outside it, and one TF32 product per split of the W2 gradient is more than
50 times less accurate (still inside the gate at this shape's 9800
edges)."""

import functools

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from geoldm_tpu.config import EGNNConfig as JaxEGNNConfig
from geoldm_tpu.nn.egnn import egnn_init
from geoldm_tpu_torch.config import EGNNConfig
from geoldm_tpu_torch.nn.egnn import EGNN, EquivariantBlock, init_parameters
from geoldm_tpu_torch.ops import egnn_block, egnn_tiled
from tests.test_torch_port_tiled import _jax_stage
from tests.test_torch_port_tiled_grad import _jax_stage_bwd
from tests.torch_port_utils import load_egnn_from_jax, masked_inputs, t

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


# ---------------------------------------------------------------------------
# The row-tiled forward grid (#3/#4/#6) at a GEOM shape.
# ---------------------------------------------------------------------------

WINDOW = 64  # columns of one window of the row grid (csrc/egnn_rows.cuh)
GEOM_H, GEOM_N = 256, 70


@functools.lru_cache(maxsize=2)
def _geom_stages(aggregation):
    """(port EGNN, JAX config, JAX block params, numpy stage inputs) at the
    GEOM recipe's block (H=256, attention, tanh, 'sum' over factor 1, or
    'mean'), the same weights in both packages; B=2 molecules of 70 and 51
    atoms padded to 70."""
    d = dict(in_node_nf=3, out_node_nf=3, hidden_nf=GEOM_H, n_layers=1, inv_sublayers=1,
             attention=True, tanh=True, coords_range=15.0, norm_constant=1.0,
             sin_embedding=False, normalization_factor=1.0, aggregation_method=aggregation)
    params = egnn_init(jax.random.key(0), JaxEGNNConfig(**d))
    egnn = load_egnn_from_jax(EGNN(EGNNConfig(**d)), params, True)
    _, x, x0, mask = masked_inputs(3, 2, GEOM_N, 1, (GEOM_N, 51))
    h = np.random.default_rng(4).standard_normal((2, GEOM_N, GEOM_H)).astype(np.float32) * mask
    return egnn, JaxEGNNConfig(**d), jax.tree.map(lambda a: a[0], params["blocks"]), (h, x, x0,
                                                                                       mask)


def _stage_module(egnn, stage):
    block = egnn.e_block_0
    return block.gcl_0 if stage == "gcl" else block.gcl_equiv


def _edge_pre(lin0, full, product):
    """(pre [B,N,N,H], the distance features [r(x), r(x0)] [B,N,N,2], diff,
    diff0 [B,N,N,3]) of every edge as the row grids build them: the src and
    dst projections through ``product``, the edge-feature term in f32."""
    h, x, x0, _ = full
    b, n, hid = h.shape
    w1 = lin0.weight
    diff = x[:, :, None] - x[:, None]
    diff0 = x0[:, :, None] - x0[:, None]
    feats = torch.cat([(diff * diff).sum(-1, keepdim=True),
                       (diff0 * diff0).sum(-1, keepdim=True)], dim=-1)
    hh = h.reshape(-1, hid)
    pre = ((product(hh, w1[:, :hid].T).reshape(b, n, 1, hid)
            + product(hh, w1[:, hid:2 * hid].T).reshape(b, 1, n, hid))
           + feats @ w1[:, 2 * hid:].T + lin0.bias)
    return pre, feats, diff, diff0


def _w2_operands(module, stage, full, product):
    """(silu(pre) of every edge [B,N,N,H], its projections through
    ``product``, W2^T, coord_diff, edge mask) of one stage."""
    lin0, lin2 = ((module.edge_mlp[0], module.edge_mlp[2]) if stage == "gcl"
                  else (module.coord_mlp[0], module.coord_mlp[2]))
    n = full[0].shape[1]
    _, coord_diff, emask = egnn_tiled._row_slab(module.cfg, lin0, full, full, 0, 0, n)
    return F.silu(_edge_pre(lin0, full, product)[0]), lin2.weight.T, coord_diff, emask


def _row_grid_stage(module, stage, full, product):
    """One stage's output as the row grid computes it: the projections, the
    W2 product and the node MLP through ``product``, each row's sums added
    window by window, in column order."""
    cfg = module.cfg
    act, w2t, coord_diff, emask = _w2_operands(module, stage, full, product)
    h, x, _, mask = full
    n, hidden = h.shape[1], act.shape[-1]
    bias = (module.edge_mlp if stage == "gcl" else module.coord_mlp)[2].bias
    m = F.silu(product(act.reshape(-1, hidden), w2t).reshape(act.shape) + bias)
    if stage == "gcl":
        terms = (m * module.att_mlp(m) if cfg.attention else m) * emask
    else:
        s = module.coord_mlp[4](m)
        if cfg.tanh:
            s = torch.tanh(s) * cfg.coords_range_layer
        terms = coord_diff * s * emask
    total = torch.zeros_like(terms[:, :, 0])
    for j0 in range(0, n, WINDOW):
        for j in range(j0, min(j0 + WINDOW, n)):
            total = total + terms[:, :, j]
    total = total / egnn_tiled._divisor(cfg, n)
    if stage == "gcl":
        nl0, nl2 = module.node_mlp[0], module.node_mlp[2]
        hag = torch.cat([h, total], dim=-1).reshape(-1, 2 * hidden)
        u = F.silu(product(hag, nl0.weight.T) + nl0.bias)
        return (h + (product(u, nl2.weight.T) + nl2.bias).reshape(h.shape)) * mask
    return (x + total) * mask


@functools.lru_cache(maxsize=4)
def _pallas_stage(aggregation, stage):
    _, jcfg, block_params, arrays = _geom_stages(aggregation)
    return _jax_stage(jcfg, block_params, stage, GEOM_N, arrays)


@pytest.mark.parametrize("aggregation", ["sum", "mean"])
@pytest.mark.parametrize("stage", ["gcl", "coord"])
def test_row_grid_stage_in_split_tf32_matches_the_pallas_kernel(stage, aggregation):
    egnn, _, _, arrays = _geom_stages(aggregation)
    want = _pallas_stage(aggregation, stage)
    with torch.no_grad():
        got = _row_grid_stage(_stage_module(egnn, stage), stage, tuple(t(a) for a in arrays),
                              egnn_block.split_tf32_matmul).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    err, scale = float(np.abs(got - want).max()), max(1.0, float(np.abs(want).max()))
    assert err <= GATE * scale, f"{stage} {aggregation}: max|d|={err:.3e} > {GATE}*{scale:.3g}"


@pytest.mark.parametrize("stage", ["gcl", "coord"])
def test_row_grid_w2_product_in_one_tf32_fails_the_gate(stage):
    """The W2 product over the windows of every row (its real and padded
    columns): split TF32 within 1e-4 * max(1, max|ref|) of the float64
    product, one TF32 product outside it."""
    egnn, _, _, arrays = _geom_stages("sum")
    with torch.no_grad():
        act, w2t, _, _ = _w2_operands(_stage_module(egnn, stage), stage,
                                      tuple(t(a) for a in arrays), egnn_block.split_tf32_matmul)
        a = act.reshape(-1, GEOM_H)
        err3, ref = _err(egnn_block.split_tf32_matmul(a, w2t), a, w2t)
        err1, _ = _err(_one_tf32(a, w2t), a, w2t)
    assert err3 <= GATE * max(1.0, ref), f"{stage}: split TF32 max|d|={err3:.3e}"
    assert err1 > GATE * max(1.0, ref), f"{stage}: one TF32 max|d|={err1:.3e}, max|ref|={ref:.3e}"


# ---------------------------------------------------------------------------
# The row-tiled stage backward (#5, and #7 on a slab) at a GEOM shape.
# ---------------------------------------------------------------------------

def _split_k(d, a, product):
    """d^T a over the edge rows as wgrad_tc sums it: the rows in the
    consecutive chunks ``egnn_block.wgrad_splits`` gives (the library's
    split count, which the card tests hold it to), each chunk's product
    through ``product``, the partials added in chunk order."""
    _, chunk = egnn_block.wgrad_splits(d.shape[0], d.shape[1])
    total = torch.zeros(d.shape[1], a.shape[1])
    for e0 in range(0, d.shape[0], chunk):
        total = total + product(d[e0:e0 + chunk].T, a[e0:e0 + chunk])
    return total


@pytest.mark.parametrize("edges,hidden,splits", [
    (9800, 256, 62), (64 * 29 * 29, 256, 64), (32 * 64 * 64, 256, 64),
    (32 * 104 * 104, 256, 169), (32 * 184 * 184, 256, 529), (2 * 184 * 184, 512, 34)])
def test_wgrad_splits_cap_each_split_at_2048_edges(edges, hidden, splits):
    """The W2-gradient GEMM's splits: 64 at H=256 for #2's shapes (QM9 pad
    29, GEOM pad 64), so #2's sums keep their order, and as many as keep a
    split to 2048 edge rows past that (GEOM pads 104, 184 at B=32), each a
    multiple of 16 rows, together covering every edge row once."""
    got, chunk = egnn_block.wgrad_splits(edges, hidden)
    assert got == splits
    assert got >= -(-edges // 2048) and chunk <= 2048 and chunk % 16 == 0
    assert (got - 1) * chunk < edges <= got * chunk


# The node GEMM's plan (egnn_block.node_gemm_plan, the library's; the card
# tests hold the two equal). Its split buffer at H=256 holds kMaxSplits = 32
# partial [H, H] tiles.
NODE_GEMM_CAP = 32 * 256 * 256


@pytest.mark.parametrize("m,n,k,problems,splits,chunk", [
    (256, 256, 1856, 1, 15, 128),       # QM9 (B=64, pad 29): the Wn2 gradient
    (256, 256, 1856, 2, 15, 128),       # W1's src / dst columns, Wn1's halves: one launch
    (256, 256, 32 * 184, 1, 31, 192),   # #5 at pad 184, B=32: as many splits as the buffer holds
    (256, 256, 32 * 184, 2, 16, 384),
    (192, 192, 1856, 2, 15, 128),       # the conditional recipe's width
    (256, 256, 2048 * 40, 1, 32, 2560),  # past what the buffer holds: 32 splits
    (1856, 256, 256, 1, 1, 256),        # an input gradient: its tiles fill the card
    (64, 96, 1000, 1, 8, 128),          # two chunks a split
])
def test_node_gemm_plan_splits(m, n, k, problems, splits, chunk):
    """The weight gradients (few output tiles, K the node rows) split into
    splits of two 64-row chunks while the buffer holds that many, else into
    as many as it holds, each a multiple of the chunk, together covering K
    once; the forward-sized products are not split."""
    tm, tn, got, got_chunk = egnn_block.node_gemm_plan(m, n, k, problems, NODE_GEMM_CAP)
    assert (tm, tn, got, got_chunk) == (64, 64, splits, chunk)
    assert got_chunk % 64 == 0 and (got - 1) * got_chunk < k <= got * got_chunk
    assert got == 1 or problems * got * m * n <= NODE_GEMM_CAP
    tiles = -(-m // tm) * -(-n // tn) * problems
    if 2 * tiles <= 132 and problems * -(-k // 128) * m * n <= NODE_GEMM_CAP:
        assert got_chunk <= 128
    else:
        assert got == 1 or got_chunk > 128


@pytest.mark.parametrize("m,n,k", [(1, 1, 1), (17, 70, 45), (1857, 130, 300), (256, 256, 1856),
                                   (6400, 256, 512)])
@pytest.mark.parametrize("problems", [1, 2])
def test_node_gemm_plan_grid_covers_the_output_and_k_once(m, n, k, problems):
    """The launch grid of the plan (ceil(N / tile) x ceil(M / tile) x
    problems * splits) covers every output element of every product, and
    the splits every K row, each once; without a split buffer, or where the
    output is rounded or has an epilogue (may_split false), K is not
    split."""
    tm, tn, splits, chunk = egnn_block.node_gemm_plan(m, n, k, problems, NODE_GEMM_CAP)
    rows = [r for y in range(-(-m // tm)) for r in range(y * tm, min(m, y * tm + tm))]
    cols = [c for x in range(-(-n // tn)) for c in range(x * tn, min(n, x * tn + tn))]
    ks = [q for z in range(splits) for q in range(z * chunk, min(k, z * chunk + chunk))]
    assert rows == list(range(m)) and cols == list(range(n)) and ks == list(range(k))
    for cap, may_split in ((0, True), (NODE_GEMM_CAP, False)):
        assert egnn_block.node_gemm_plan(m, n, k, problems, cap, may_split)[2] == 1


def _by_window(terms, dim):
    """Sum over the column axis ``dim`` window by window (64 columns), each
    window's terms in column order, the windows in order."""
    total = torch.zeros_like(terms.select(dim, 0))
    n = terms.shape[dim]
    for j0 in range(0, n, WINDOW):
        part = torch.zeros_like(total)
        for j in range(j0, min(j0 + WINDOW, n)):
            part = part + terms.select(dim, j)
        total = total + part
    return total


def _row_grid_stage_bwd(module, stage, full, g_out, transposed=egnn_block.split_tf32_matmul,
                        wgrad=egnn_block.split_tf32_matmul):
    """One stage backward as the new #5 computes it, explicitly: the second
    layer, the transposed product d(mm) W2 (``transposed``) and the node
    products in split TF32, the W2 gradient split over the edges
    (``wgrad`` per chunk, chunks summed in order), the row sums of d(pre) and
    the CTA partials window by window -> (dh, dx, dx0, [weight gradients in
    ``stage_weight_names`` order])."""
    mm_ = egnn_block.split_tf32_matmul
    cfg = module.cfg
    h, x, x0, mask = full
    b, n, hid = h.shape
    lin0, lin2 = ((module.edge_mlp[0], module.edge_mlp[2]) if stage == "gcl"
                  else (module.coord_mlp[0], module.coord_mlp[2]))
    w1, w2 = lin0.weight, lin2.weight
    w1s, w1d, w1e = w1[:, :hid], w1[:, hid:2 * hid], w1[:, 2 * hid:]
    div = egnn_tiled._divisor(cfg, n)
    _, cd, emask = egnn_tiled._row_slab(cfg, lin0, full, full, 0, 0, n)
    pre, feats, diff, diff0 = _edge_pre(lin0, full, mm_)
    r = feats[..., :1]
    a = F.silu(pre)
    mmv = mm_(a.reshape(-1, hid), w2.T).reshape(a.shape) + lin2.bias
    m = F.silu(mmv)
    sig = torch.sigmoid(mmv)
    dsilu_mm = sig * (1 + mmv * (1 - sig))
    sp = torch.sigmoid(pre)
    dsilu_pre = sp * (1 + pre * (1 - sp))
    grads = {}
    if stage == "gcl":
        wa = module.att_mlp[0].weight[0] if cfg.attention else None
        gate = torch.sigmoid(m @ wa + module.att_mlp[0].bias) if cfg.attention else None
        terms = (m * gate[..., None] if cfg.attention else m) * emask
        agg = _by_window(terms, 2) / div
        nl0, nl2 = module.node_mlp[0], module.node_mlp[2]
        hag = torch.cat([h, agg], dim=-1).reshape(-1, 2 * hid)
        z = mm_(hag, nl0.weight.T) + nl0.bias
        u = F.silu(z)
        dupd = (g_out * mask).reshape(-1, hid)
        grads["node_mlp.2.bias"] = dupd.sum(0)
        grads["node_mlp.2.weight"] = mm_(dupd.T, u)
        su = torch.sigmoid(z)
        dz = mm_(dupd, nl2.weight) * (su * (1 + z * (1 - su)))
        grads["node_mlp.0.bias"] = dz.sum(0)
        grads["node_mlp.0.weight"] = mm_(dz.T, hag)
        dh = dupd + mm_(dz, nl0.weight[:, :hid])
        dg = (mm_(dz, nl0.weight[:, hid:]) / div).reshape(b, n, 1, hid)
        if cfg.attention:
            s2 = (m * dg).sum(-1)
            rs2 = gate * (1 - gate) * emask[..., 0] * s2
            dm = dg * emask * gate[..., None] + rs2[..., None] * wa
            grads["att_mlp.0.weight"] = (rs2[..., None] * m).reshape(-1, hid).sum(0)[None]
            grads["att_mlp.0.bias"] = rs2.sum().reshape(1)
        else:
            dm = dg * emask
        dx = torch.zeros_like(x)
    else:
        w3 = module.coord_mlp[4].weight[0]
        logit = m @ w3
        th = torch.tanh(logit)
        scale = th * cfg.coords_range_layer if cfg.tanh else logit
        daggx = (g_out * mask / div)[:, :, None]  # [B, N, 1, 3]
        ds = emask[..., 0] * (daggx * cd).sum(-1)
        rs2 = ds * cfg.coords_range_layer * (1 - th * th) if cfg.tanh else ds
        dm = rs2[..., None] * w3
        grads["coord_mlp.4.weight"] = (rs2[..., None] * m).reshape(-1, hid).sum(0)[None]
        dcd = daggx * (scale * emask[..., 0])[..., None]
        dh = torch.zeros(b * n, hid)
        dx = g_out * mask
    dmm = dm * dsilu_mm
    prefix = "edge_mlp" if stage == "gcl" else "coord_mlp"
    grads[f"{prefix}.2.bias"] = _by_window(dmm, 2).sum((0, 1))
    grads[f"{prefix}.2.weight"] = _split_k(dmm.reshape(-1, hid), a.reshape(-1, hid), wgrad)
    dpre = transposed(dmm.reshape(-1, hid), w2).reshape(dmm.shape) * dsilu_pre
    rowsum = _by_window(dpre, 2)  # [B, N(i), H]
    colsum = dpre.sum(1)  # [B, N(j), H], rows in order
    grads[f"{prefix}.0.bias"] = rowsum.sum((0, 1))
    we = torch.cat([_by_window(dpre * feats[..., k:k + 1], 2).sum((0, 1))[:, None]
                    for k in range(feats.shape[-1])], dim=1)
    grads[f"{prefix}.0.weight"] = torch.cat(
        [mm_(rowsum.reshape(-1, hid).T, h.reshape(-1, hid)),
         mm_(colsum.reshape(-1, hid).T, h.reshape(-1, hid)), we], dim=1)
    dh = (dh + mm_(rowsum.reshape(-1, hid), w1s) + mm_(colsum.reshape(-1, hid), w1d)).reshape(
        b, n, hid)
    dr = (dpre * w1e[:, 0]).sum(-1, keepdim=True)
    dr0 = (dpre * w1e[:, 1]).sum(-1, keepdim=True)
    if stage == "gcl":
        g_pair = 2 * diff * dr
    else:
        norm = torch.sqrt(r + 1e-8)
        cc = norm + cfg.norm_constant
        dlr = dr - (dcd * diff).sum(-1, keepdim=True) / (cc * cc) / (2 * norm)
        g_pair = dcd / cc + 2 * diff * dlr
    g0 = 2 * diff0 * dr0
    dx = dx + g_pair.sum(2) - g_pair.sum(1)
    dx0 = g0.sum(2) - g0.sum(1)
    return dh, dx, dx0, [grads[name] for name in egnn_tiled.stage_weight_names(module)]


def _geom_cotangents(stage):
    rng = np.random.default_rng(11 if stage == "gcl" else 12)
    return rng.standard_normal((2, GEOM_N, GEOM_H if stage == "gcl" else 3)).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _pallas_stage_bwd(aggregation, stage):
    _, jcfg, block_params, arrays = _geom_stages(aggregation)
    return _jax_stage_bwd(jcfg, block_params, stage, GEOM_N, arrays, _geom_cotangents(stage))


def _bwd_errors(stage, aggregation, **products):
    """{output: (max|d|, max(1, max|ref|))} of the emulated backward against
    the JAX kernel #5 (interpret mode)."""
    egnn, _, _, arrays = _geom_stages(aggregation)
    want_in, want_w = _pallas_stage_bwd(aggregation, stage)
    module = _stage_module(egnn, stage)
    with torch.no_grad():
        dh, dx, dx0, dws = _row_grid_stage_bwd(module, stage, tuple(t(a) for a in arrays),
                                               t(_geom_cotangents(stage)), **products)
    names = ["dh", "dx", "dx0"] + egnn_tiled.stage_weight_names(module)
    out = {}
    for name, g, w in zip(names, [dh, dx, dx0, *dws], [*want_in, *want_w]):
        g = g.numpy().reshape(w.shape)
        assert np.isfinite(g).all(), name
        out[name] = (float(np.abs(g - w).max()), max(1.0, float(np.abs(w).max())))
    return out


@pytest.mark.parametrize("aggregation", ["sum", "mean"])
@pytest.mark.parametrize("stage", ["gcl", "coord"])
def test_row_grid_stage_backward_in_split_tf32_matches_the_pallas_kernel(stage, aggregation):
    """Every output of the stage backward emulated in the new grid's order
    (split-TF32 edge and node products, window-by-window sums, the split-K
    W2 gradient summed in order) within 1e-4 * max(1, max|ref|) of the JAX
    kernel #5."""
    for name, (err, scale) in _bwd_errors(stage, aggregation).items():
        assert err <= GATE * scale, f"{stage} {aggregation} {name}: max|d|={err:.3e}"


@pytest.mark.parametrize("stage", ["gcl", "coord"])
def test_row_grid_stage_backward_with_one_tf32_transposed_product_fails_the_gate(stage):
    """One TF32 product in place of the split one for the transposed product
    d(mm) W2 puts some output of the stage backward outside the gate."""
    errs = _bwd_errors(stage, "sum", transposed=_one_tf32)
    worst = max(errs, key=lambda k: errs[k][0] / errs[k][1])
    err, scale = errs[worst]
    assert err > GATE * scale, f"{stage}: worst {worst} max|d|={err:.3e} <= {GATE}*{scale:.3g}"


@pytest.mark.parametrize("stage", ["gcl", "coord"])
def test_row_grid_w2_gradient_in_one_tf32_is_far_less_accurate(stage):
    """The W2 gradient with one TF32 product per split: at this shape (9800
    edges) it stays inside the gate, but its error against the JAX kernel is
    more than 50 times the split scheme's."""
    name = ("edge_mlp" if stage == "gcl" else "coord_mlp") + ".2.weight"
    err3, scale = _bwd_errors(stage, "sum")[name]
    err1, _ = _bwd_errors(stage, "sum", wgrad=_one_tf32)[name]
    assert err3 <= GATE * scale and err1 > 50 * err3, f"{stage}: {err1:.3e} vs {err3:.3e}"
