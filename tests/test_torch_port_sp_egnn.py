"""Port parity on CPU for the sequence-parallel (SP) EGNN: the port's SP
EGNN over 2 and 4 gloo ranks on the CPU (the plain versions of the slab
kernels #6/#7 and the autograd collectives of ``parallel.sp``) against JAX's
``egnn_apply_sp`` (row-tiled Pallas slabs in interpret mode on the virtual CPU
mesh) in the forward and against ``jax.grad`` of the dense ``egnn_apply`` in
the gradients of a sum-loss with respect to the inputs and every weight
(SP's semantics are the dense path's; JAX's own SP gradient tests through
interpret mode are marked slow)."""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_sp_ranks
from geoldm_tpu.config import EGNNConfig as JaxEGNNConfig
from geoldm_tpu.nn.egnn import egnn_apply, egnn_init
from geoldm_tpu.ops.distance import build_edge_mask
from geoldm_tpu.parallel.sp import egnn_apply_sp, make_sp_mesh
from geoldm_tpu.utils.torch_convert import egnn_state_dict_from_params
from geoldm_tpu_torch.parallel import sharding
from tests.torch_port_utils import masked_inputs

torch.set_num_threads(1)

BASE = dict(in_node_nf=6, out_node_nf=6, hidden_nf=32, n_layers=2, inv_sublayers=1,
            attention=True, tanh=True, coords_range=15.0, norm_constant=1.0,
            sin_embedding=False, normalization_factor=100.0, aggregation_method="sum")
VARIANTS = {"sum": {}, "sin": {"sin_embedding": True},
            "mean": {"aggregation_method": "mean", "normalization_factor": 1.0, "tanh": False}}
# Two frameworks' f32 op orders: each tensor within RTOL * max(1, max|ref|).
RTOL = 2e-5


def _assert_close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{name}: max|d|={err:.3e} > {RTOL}*{scale:.3g}"


# The SP EGNN over gloo ranks: (variant, N, atoms per molecule). N=19 pads to
# 20 (S=2, 4) inside the port, 32 inside JAX.
EGNN_CASES = {"sum-n16": ("sum", 16, (16, 11)), "mean-n20": ("mean", 20, (20, 15)),
              "sin-n19": ("sin", 19, (19, 12))}


def _egnn_case(name):
    variant, n, n_real = EGNN_CASES[name]
    d = {**BASE, **VARIANTS[variant]}
    jcfg = JaxEGNNConfig(**d)
    params = egnn_init(jax.random.key(3), jcfg)
    h, x, _, mask = masked_inputs(4, 2, n, 6, n_real)
    rng = np.random.default_rng(5)
    gh = rng.standard_normal((2, n, 6)).astype(np.float32)
    gx = rng.standard_normal((2, n, 3)).astype(np.float32)
    state = {}
    egnn_state_dict_from_params(state, "", jax.tree.map(np.asarray, params), jcfg.attention)
    port = {"cfg": d, "state": {k: np.array(v) for k, v in state.items()}, "h": h, "x": x,
            "mask": mask, "gh": gh, "gx": gx}
    return jcfg, params, port


@functools.lru_cache(maxsize=None)
def _dense_grads(name):
    """jax.grad of the dense egnn_apply's sum-loss -> {port name: gradient}."""
    jcfg, params, c = _egnn_case(name)
    mask = jnp.asarray(c["mask"])

    def loss(p, h_, x_):
        hh, xx = egnn_apply(p, jcfg, h_, x_, mask, build_edge_mask(mask))
        return jnp.sum(hh * c["gh"]) + jnp.sum(xx * c["gx"])

    dp, dh, dx = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(params, c["h"], c["x"])
    grads = {"h": np.asarray(dh), "x": np.asarray(dx)}
    egnn_state_dict_from_params(grads, "", jax.tree.map(np.asarray, dp), jcfg.attention)
    return grads


def _jax_sp_forward(name, sp_size):
    jcfg, params, c = _egnn_case(name)
    mesh = make_sp_mesh(dp=1, sp=sp_size)
    h_sp, x_sp = jax.jit(lambda p, h, x, m: egnn_apply_sp(p, jcfg, h, x, m, mesh, use_pallas=True,
                                                          interpret=True))(
        params, c["h"], c["x"], c["mask"])
    return np.asarray(h_sp), np.asarray(x_sp)


@pytest.fixture(scope="module", params=[2, 4], ids=["sp2", "sp4"])
def sp_run(request):
    """The port's SP EGNN over ``request.param`` gloo ranks on every case (one
    spawn, running while the JAX references are computed)."""
    got = []
    ranks = threading.Thread(target=lambda: got.extend(sharding.spawn(
        1, request.param, torch_port_sp_ranks.egnn_cases,
        ([_egnn_case(name)[2] for name in EGNN_CASES], "cpu"), device="cpu")))
    ranks.start()
    refs = {name: (*_jax_sp_forward(name, request.param), _dense_grads(name))
            for name in EGNN_CASES}
    ranks.join()
    assert len(got) == len(EGNN_CASES), "the SP ranks failed (their error is above)"
    return request.param, {name: (g, refs[name]) for name, g in zip(EGNN_CASES, got)}


@pytest.mark.parametrize("case", list(EGNN_CASES))
def test_sp_egnn_over_gloo_ranks_matches_jax(sp_run, case):
    size, runs = sp_run
    got, (h_sp, x_sp, grads) = runs[case]
    assert got["ranks_agree"], "the ranks' replicated outputs or gradients differ"
    _assert_close(got["h"], h_sp, f"S={size} h vs egnn_apply_sp")
    _assert_close(got["x"], x_sp, f"S={size} x vs egnn_apply_sp")
    assert set(got["grads"]) == set(grads)
    for name, g in got["grads"].items():
        _assert_close(g, grads[name], f"S={size} d{name}")
