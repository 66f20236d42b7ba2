"""Port parity on CPU for the row-tiled backward (TPU kernel #5): the plain
stage backwards (``torch.autograd.grad`` of the plain GCL and coordinate
stages) against the JAX ``_call_rows_bwd``, i.e. ``_make_rows_bwd_kernel`` in
interpret mode; ``TiledEquivariantBlockFunction`` on the CPU against
``jax.vjp`` of ``tiled_block_apply(..., bwd_mode="pallas")``; the EGNN routed
past 64 nodes under grad against ``egnn_apply_pallas``; and the Function's
wiring by ``gradcheck``. The CUDA kernel is held against the plain versions in
``test_torch_port_cuda.py``, which needs a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoldm_tpu.config import EGNNConfig as JaxEGNNConfig
from geoldm_tpu.nn.egnn import egnn_init
from geoldm_tpu.ops import pallas_egnn
from geoldm_tpu.ops import pallas_egnn_tiled as jtiled
from geoldm_tpu.utils.torch_convert import egnn_state_dict_from_params
from geoldm_tpu_torch.config import EGNNConfig
from geoldm_tpu_torch.nn.egnn import EGNN, EquivariantBlock, init_parameters
from geoldm_tpu_torch.ops import egnn_block, egnn_tiled
from tests.torch_port_utils import (assert_routes_agree, block_grads_by_name, load_egnn_from_jax,
                                    masked_inputs, t)

torch.set_num_threads(1)

BASE = dict(in_node_nf=6, out_node_nf=6, hidden_nf=32, n_layers=1, inv_sublayers=1,
            attention=True, tanh=True, coords_range=15.0, norm_constant=1.0,
            sin_embedding=False, normalization_factor=100.0, aggregation_method="sum")
# Gradients through two frameworks' f32 op orders, each output tensor within
# RTOL * max(1, max|ref|).
RTOL = 2e-5
JAX_TILE = 8
VARIANTS = {
    "sum": {},
    "no_attention": {"attention": False},
    "sin": {"sin_embedding": True},
    # N=20 is padded to 24 inside the JAX kernels: 'mean' divides by 20.
    "mean": {"aggregation_method": "mean", "normalization_factor": 1.0, "tanh": False},
}


def _pair(variant, seed=0):
    d = {**BASE, **VARIANTS[variant]}
    pcfg, jcfg = EGNNConfig(**d), JaxEGNNConfig(**d)
    params = egnn_init(jax.random.key(seed), jcfg)
    egnn = load_egnn_from_jax(EGNN(pcfg), params, pcfg.attention)
    return egnn, jcfg, params


def _assert_close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{name}: max|d|={err:.3e} > {RTOL}*{scale:.3g}"


def _stage_arrays(n, seed):
    """Stage inputs (h at hidden width, x, x0, mask) for B=2 ragged molecules
    and the cotangents of both stages' outputs."""
    _, x, x0, mask = masked_inputs(seed, 2, n, 1, (n, n - 7))
    rng = np.random.default_rng(seed + 10)
    h = rng.standard_normal((2, n, 32)).astype(np.float32) * mask
    return (h, x, x0, mask), (rng.standard_normal((2, n, 32)).astype(np.float32),
                              rng.standard_normal((2, n, 3)).astype(np.float32))


def _jax_stage_bwd(jcfg, block_params, stage, n, arrays, cot):
    """One stage's backward through the JAX kernel #5 (interpret mode), N
    padded to a multiple of the tile and 'mean' told the caller's N."""
    pad = -(-n // JAX_TILE) * JAX_TILE - n
    padded = [jnp.pad(jnp.asarray(a), ((0, 0), (0, pad), (0, 0))) for a in (*arrays, cot)]
    if stage == "gcl":
        gw, keys = jtiled._gcl_weight_dict(jcfg, block_params["gcls"][0])
        math_fn, cot_feat = jtiled._gcl_rows_math, jcfg.hidden_nf
    else:
        gw, keys = jtiled._coord_weight_dict(block_params), jtiled._COORD_KEYS
        math_fn, cot_feat = jtiled._coord_rows_math, 3
    dws, dh, dx, dx0 = jtiled._call_rows_bwd(
        jcfg, n + pad, JAX_TILE, None, keys, math_fn, cot_feat, True, padded[:4], padded[4],
        [gw[k] for k in keys], n)
    # JAX weights are [in, out]: the port's nn.Linear layout is the transpose.
    dws = [np.asarray(w).T if np.ndim(w) == 2 else np.asarray(w) for w in dws]
    return [np.asarray(a)[:, :n] for a in (dh, dx, dx0)], dws


@pytest.mark.parametrize("n", [72, 20])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_stage_backward_plain_matches_pallas_rows_bwd(variant, n):
    egnn, jcfg, params = _pair(variant)
    bp = jax.tree.map(lambda a: a[0], params["blocks"])
    arrays, (gh, gx) = _stage_arrays(n, seed=1)
    block = egnn.e_block_0
    for stage, module, fn, cot in (
            ("gcl", block.gcl_0, egnn_tiled.gcl_rows_backward_plain, gh),
            ("coord", block.gcl_equiv, egnn_tiled.coord_rows_backward_plain, gx)):
        want_in, want_w = _jax_stage_bwd(jcfg, bp, stage, n, arrays, cot)
        dh, dx, dx0, dws = fn(module, *[t(a) for a in arrays], t(cot))
        for name, g, w in zip(("dh", "dx", "dx0"), (dh, dx, dx0), want_in):
            _assert_close(g.numpy(), w, f"{stage} {name}")
        assert len(dws) == len(want_w) == len(list(module.parameters()))
        for k, (g, w) in enumerate(zip(dws, want_w)):
            _assert_close(g.numpy().reshape(w.shape), w, f"{stage} weight {k}")


@pytest.mark.parametrize("variant", ["sum", "sin", "mean"])
def test_tiled_block_function_matches_jax_vjp(variant):
    """The Function on the CPU (GCL chain re-run, coordinate stage, GCL
    stages in reverse) against jax.vjp of the JAX tiled block with the fused
    tiled backward, exact dx0 included."""
    egnn, jcfg, params = _pair(variant, seed=2)
    block = egnn.e_block_0
    bp = jax.tree.map(lambda a: a[0], params["blocks"])
    n = 72
    arrays, (gh, gx) = _stage_arrays(n, seed=3)
    hj, xj, x0j, mj = map(jnp.asarray, arrays)
    _, vjp = jax.vjp(lambda p, h_, x_, x0_: jtiled.tiled_block_apply(
        jcfg, p, h_, x_, x0_, mj, None, True, JAX_TILE, "pallas", n), bp, hj, xj, x0j)
    dbp, dh_j, dx_j, dx0_j = vjp((jnp.asarray(gh), jnp.asarray(gx)))

    inputs = [t(a).requires_grad_() for a in arrays[:3]]
    ws = [w.detach().clone().requires_grad_() for w in egnn_block.block_params(block)]
    outs = egnn_tiled.TiledEquivariantBlockFunction.apply(block, None, *inputs, t(arrays[3]),
                                                          *ws)
    grads = torch.autograd.grad(outs, inputs + ws, (t(gh), t(gx)))
    for name, g, w in zip(("dh", "dx", "dx0"), grads[:3], (dh_j, dx_j, dx0_j)):
        _assert_close(g.numpy(), w, name)
    want = block_grads_by_name(dbp, jcfg.attention)
    names = egnn_block.block_param_names(block)
    assert set(want) == set(names)
    for name, g in zip(names, grads[3:]):
        _assert_close(g.numpy(), want[name], name)


def test_egnn_past_64_nodes_under_grad_matches_jax():
    """EGNN.forward at N=72 under grad routes every block through the
    Function; its gradients, the exact x0 path included (x0 = the input x),
    match jax.vjp of the JAX Pallas EGNN, which runs its tiled kernels at that
    pad (interpret mode)."""
    egnn, jcfg, params = _pair("sum", seed=4)
    n = 72
    assert pallas_egnn.dispatch_to_tiled(n, jcfg.hidden_nf)
    h, x, _, mask = masked_inputs(5, 2, n, 6, (72, 66))
    rng = np.random.default_rng(6)
    gh = rng.standard_normal((2, n, 6)).astype(np.float32) * mask
    gx = rng.standard_normal((2, n, 3)).astype(np.float32)
    mj = jnp.asarray(mask)
    _, vjp = jax.vjp(lambda p, h_, x_: pallas_egnn.egnn_apply_pallas(p, jcfg, h_, x_, mj,
                                                                    interpret=True),
                     params, jnp.asarray(h), jnp.asarray(x))
    dparams, dh_j, dx_j = vjp((jnp.asarray(gh), jnp.asarray(gx)))

    fn_calls = []
    apply = egnn_tiled.TiledEquivariantBlockFunction.apply
    egnn_tiled.TiledEquivariantBlockFunction.apply = lambda *a: fn_calls.append(1) or apply(*a)
    try:
        hp, xp = t(h).requires_grad_(), t(x).requires_grad_()
        h_out, x_out = egnn(hp, xp, t(mask))
    finally:
        egnn_tiled.TiledEquivariantBlockFunction.apply = apply
    assert len(fn_calls) == jcfg.n_layers
    names, ps = zip(*egnn.named_parameters())
    grads = torch.autograd.grad((h_out, x_out), [hp, xp, *ps], (t(gh), t(gx)))
    _assert_close(grads[0].numpy(), dh_j, "dh")
    _assert_close(grads[1].numpy(), dx_j, "dx")
    want = {}
    egnn_state_dict_from_params(want, "", jax.tree.map(np.asarray, dparams), jcfg.attention)
    for name, g in zip(names, grads[2:]):
        _assert_close(g.numpy(), want[name], name)


@pytest.mark.parametrize("variant", [{"inv_sublayers": 2, "attention": False},
                                     {"sin_embedding": True, "aggregation_method": "mean"}])
def test_tiled_block_function_gradcheck(variant):
    """The Function's wiring (argument order, None for the mask, weight
    gradients in block_params order, the recompute and the reverse stage
    order) in float64 through the plain versions at N=66, past the routing
    bound. With sin features, which carry no gradient by design, only h and
    the weights are checked."""
    cfg = EGNNConfig(in_node_nf=2, out_node_nf=2, hidden_nf=8, n_layers=1,
                     normalization_factor=3.0, **variant)
    block = EquivariantBlock(cfg)
    init_parameters(block, torch.Generator().manual_seed(0))
    block = block.double()
    gen = torch.Generator().manual_seed(1)
    n = 66
    mask = (torch.arange(n)[None, :] < torch.tensor([66, 40])[:, None]).double()[..., None]
    h, x, x0 = (torch.randn(2, n, f, generator=gen, dtype=torch.float64) * mask
                for f in (8, 3, 3))
    ws = [w.detach().clone().requires_grad_() for w in egnn_block.block_params(block)]
    h.requires_grad_()
    if cfg.sin_embedding:
        def f(h_, *w):
            return egnn_tiled.TiledEquivariantBlockFunction.apply(block, None, h_, x, x0, mask, *w)
        inputs = (h, *ws)
    else:
        def f(h_, x_, x0_, *w):
            return egnn_tiled.TiledEquivariantBlockFunction.apply(block, None, h_, x_, x0_, mask,
                                                                 *w)
        inputs = (h, x.requires_grad_(), x0.requires_grad_(), *ws)
    assert torch.autograd.gradcheck(f, inputs, eps=1e-6, atol=1e-5, fast_mode=True)


@pytest.mark.parametrize("variant", ["sum", "no_attention", "mean"])
def test_gcl_stage_backward_from_the_forward_chain_matches_its_recompute(variant):
    """The plain GCL stage backward (kernel #5's contract) given the node
    chain its forward kept (the aggregate, z and silu(z)) agrees with the
    whole-stage autograd within f32 sum order, and both match the JAX
    kernel #5; the chain is the forward's own node MLP input and
    activations."""
    egnn, jcfg, params = _pair(variant)
    bp = jax.tree.map(lambda a: a[0], params["blocks"])
    n = 72
    arrays, (gh, _) = _stage_arrays(n, seed=7)
    gcl = egnn.e_block_0.gcl_0
    h, x, x0, mask = map(t, arrays)
    with torch.no_grad():
        h_out, chain = egnn_tiled.gcl_rows_plain(gcl, h, x, x0, mask, keep_chain=True)
        assert torch.equal(h_out, egnn_tiled.gcl_rows_plain(gcl, h, x, x0, mask))
        agg, z, u = chain
        assert torch.equal(z, gcl.node_mlp[0](torch.cat([h, agg], dim=-1)))
        assert torch.equal(u, torch.nn.functional.silu(z))
    own = egnn_tiled.gcl_rows_backward_plain(gcl, h, x, x0, mask, t(gh))
    handed = egnn_tiled.gcl_rows_backward_plain(gcl, h, x, x0, mask, t(gh), chain=chain)
    assert_routes_agree([*own[:3], *own[3]], [*handed[:3], *handed[3]])
    want_in, want_w = _jax_stage_bwd(jcfg, bp, "gcl", n, arrays, gh)
    for name, g, w in zip(("dh", "dx", "dx0"), handed[:3], want_in):
        _assert_close(g.numpy(), w, name)
    for k, (g, w) in enumerate(zip(handed[3], want_w)):
        _assert_close(g.numpy().reshape(w.shape), w, f"weight {k}")


@pytest.mark.parametrize("variant", ["sum", "no_attention"])
def test_tiled_block_function_hands_each_gcl_its_chain(variant, monkeypatch):
    """The Function's backward hands each GCL stage the node chain its re-run
    of the GCL kept: every gradient agrees within f32 sum order with the
    chain withheld (each stage backward then runs the whole-stage
    autograd)."""
    cfg = EGNNConfig(**{**BASE, **VARIANTS[variant], "inv_sublayers": 2})
    block = EquivariantBlock(cfg)
    init_parameters(block, torch.Generator().manual_seed(3))
    arrays, (gh, gx) = _stage_arrays(72, seed=8)
    plain = egnn_tiled.gcl_rows_backward_plain
    handed = []

    def grads(withhold):
        def stage_bwd(*a, chain=None, **kw):
            handed.append(chain)
            return plain(*a, chain=None if withhold else chain, **kw)

        monkeypatch.setattr(egnn_tiled, "gcl_rows_backward_plain", stage_bwd)
        inputs = [t(a).requires_grad_() for a in arrays[:3]]
        ws = [w.detach().clone().requires_grad_() for w in egnn_block.block_params(block)]
        outs = egnn_tiled.TiledEquivariantBlockFunction.apply(block, None, *inputs,
                                                              t(arrays[3]), *ws)
        return torch.autograd.grad(outs, inputs + ws, (t(gh), t(gx)))

    withheld, given = grads(True), grads(False)
    assert len(handed) == 4 and all(c is not None and c.shape == (3, 2, 72, 32) for c in handed)
    assert_routes_agree(withheld, given)
