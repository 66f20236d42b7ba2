"""Port parity on CPU for the GEOM-Drugs serving slice: the row-tiled GCL and
coordinate stages' plain versions (kernels #3 and #4) against the JAX
row-tiled Pallas kernels in interpret mode, the routed EGNN past 64 nodes,
a zero-noise GEOM-format latent-diffusion sample through both packages, and
the GEOM dataset info, buckets, checkpoint round trip, stability check and
server. The CUDA kernels themselves are held against the plain versions in
``test_torch_port_cuda.py``, which needs a card."""

import dataclasses
import functools
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoldm_tpu import config as jconfig
from geoldm_tpu.config import EGNNConfig as JaxEGNNConfig
from geoldm_tpu.data import datasets_config as jdatasets
from geoldm_tpu.diffusion import latent as jlatent
from geoldm_tpu.diffusion import vdm as jvdm
from geoldm_tpu.evalsuite.analyze import check_stability as jax_check_stability
from geoldm_tpu.models import factory as jfactory
from geoldm_tpu.nn.egnn import egnn_init
from geoldm_tpu.ops import com as jcom
from geoldm_tpu.ops import pallas_egnn
from geoldm_tpu.ops import pallas_egnn_tiled as jtiled
from geoldm_tpu.ops.distance import build_edge_mask
from geoldm_tpu.train import sampling as jsampling
from geoldm_tpu.utils.torch_convert import params_from_reference_state_dict, state_dict_from_params
from geoldm_tpu_torch import config as pconfig
from geoldm_tpu_torch.config import EGNNConfig
from geoldm_tpu_torch.data import datasets_config as pdatasets
from geoldm_tpu_torch.diffusion import latent as platent
from geoldm_tpu_torch.evalsuite.analyze import check_stability
from geoldm_tpu_torch.models import factory as pfactory
from geoldm_tpu_torch.nn.egnn import EGNN
from geoldm_tpu_torch.ops import egnn_tiled
from geoldm_tpu_torch.train import sampling as psampling
from geoldm_tpu_torch.utils.buckets import covering_buckets
from geoldm_tpu_torch.utils.convert import load_reference_checkpoint, save_reference_checkpoint
from tests.test_torch_port_serve import _request
from tests.torch_port_utils import load_egnn_from_jax, masked_inputs, t

torch.set_num_threads(1)

BASE = dict(in_node_nf=6, out_node_nf=6, hidden_nf=32, n_layers=2, inv_sublayers=1,
            attention=True, tanh=True, coords_range=15.0, norm_constant=1.0,
            sin_embedding=False, normalization_factor=100.0, aggregation_method="sum")
ATOL = 2e-5  # as tests/test_pallas_tiled.py holds the tiled kernels to the XLA path
JAX_TILE = 8
# (N, config); N=12 is padded to 16 inside the JAX kernels, N=20 to 24, so
# 'mean' checks that the divisor is the caller's N.
CASES = {
    "sum": (12, {}),
    "mean": (12, {"aggregation_method": "mean", "normalization_factor": 1.0}),
    "sin_no_attention": (20, {"sin_embedding": True, "attention": False}),
    "inv_sublayers_2": (12, {"inv_sublayers": 2}),
}
GEOM = pdatasets.get_dataset_info("geom")
GEOM_KW = dict(nf=32, n_layers=1, latent_nf=2, include_charges=False, diffusion_steps=4)


def _pair(case, seed=0):
    """(N, port EGNN, JAX cfg, JAX params) with the same weights."""
    n, kw = CASES[case]
    d = {**BASE, **kw}
    pcfg, jcfg = EGNNConfig(**d), JaxEGNNConfig(**d)
    params = egnn_init(jax.random.key(seed), jcfg)
    return n, load_egnn_from_jax(EGNN(pcfg), params, pcfg.attention), jcfg, params


def _stage_inputs(n, seed=1):
    """Hidden-width h and x, x0, node_mask for B=2 ragged molecules."""
    _, x, x0, mask = masked_inputs(seed, 2, n, 1, (n - 5, n))
    h = np.random.default_rng(seed + 10).standard_normal((2, n, 32)).astype(np.float32) * mask
    return h, x, x0, mask


def _jax_stage(jcfg, block_params, stage, n, arrays, gcl_index=0):
    """One stage through the JAX row-tiled Pallas kernel (interpret mode),
    N padded to a multiple of the tile and 'mean' told the caller's N."""
    pad = -(-n // JAX_TILE) * JAX_TILE - n
    args = [jnp.pad(jnp.asarray(a), ((0, 0), (0, pad), (0, 0))) for a in arrays]
    b, n_pad = args[0].shape[0], n + pad
    if stage == "gcl":
        gw, keys = jtiled._gcl_weight_dict(jcfg, block_params["gcls"][gcl_index])
        kernel = jtiled._make_gcl_rows_kernel(jcfg, n_pad, JAX_TILE, None, keys, n)
        out = jtiled._call_rows(kernel, b, n_pad, JAX_TILE, jcfg.hidden_nf, jnp.float32, True,
                                args, [gw[k] for k in keys])
    else:
        cw = jtiled._coord_weight_dict(block_params)
        kernel = jtiled._make_coord_rows_kernel(jcfg, n_pad, JAX_TILE, None, n)
        out = jtiled._call_rows(kernel, b, n_pad, JAX_TILE, 3, jnp.float32, True, args,
                                [cw[k] for k in jtiled._COORD_KEYS])
    return np.asarray(out)[:, :n]


@pytest.mark.parametrize("tile", [5, egnn_tiled.PLAIN_TILE])
@pytest.mark.parametrize("case", list(CASES))
def test_gcl_rows_plain_matches_pallas_tiled(case, tile):
    n, egnn, jcfg, params = _pair(case)
    block_params = jax.tree.map(lambda a: a[0], params["blocks"])
    arrays = _stage_inputs(n)
    for j in range(jcfg.inv_sublayers):
        want = _jax_stage(jcfg, block_params, "gcl", n, arrays, gcl_index=j)
        with torch.no_grad():
            got = egnn_tiled.gcl_rows_plain(getattr(egnn.e_block_0, f"gcl_{j}"),
                                            *[t(a) for a in arrays], tile=tile)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("tile", [5, egnn_tiled.PLAIN_TILE])
@pytest.mark.parametrize("case", list(CASES))
def test_coord_rows_plain_matches_pallas_tiled(case, tile):
    n, egnn, jcfg, params = _pair(case)
    block_params = jax.tree.map(lambda a: a[0], params["blocks"])
    arrays = _stage_inputs(n, seed=2)
    want = _jax_stage(jcfg, block_params, "coord", n, arrays)
    with torch.no_grad():
        got = egnn_tiled.coord_rows_plain(egnn.e_block_0.gcl_equiv, *[t(a) for a in arrays],
                                          tile=tile)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def _tiled_egnn(egnn, h, x, node_mask):
    """EGNN.forward with every block through ``tiled_block_forward``."""
    x0 = x
    h = egnn.embedding(h)
    for i in range(egnn.cfg.n_layers):
        h, x = egnn_tiled.tiled_block_forward(getattr(egnn, f"e_block_{i}"), h, x, x0, node_mask)
    return egnn.embedding_out(h) * node_mask, x


@pytest.mark.parametrize("case", list(CASES))
def test_tiled_block_forward_matches_pallas_tiled_egnn(case):
    n, egnn, jcfg, params = _pair(case)
    h, x, _, mask = masked_inputs(3, 2, n, 6, (n - 5, n))
    want_h, want_x = jtiled.egnn_apply_pallas_tiled(params, jcfg, jnp.asarray(h), jnp.asarray(x),
                                                    jnp.asarray(mask), interpret=True,
                                                    tile=JAX_TILE)
    with torch.no_grad():
        got_h, got_x = _tiled_egnn(egnn, t(h), t(x), t(mask))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=ATOL)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=ATOL)


@pytest.mark.parametrize("case", ["sum", "mean"])
def test_egnn_past_64_nodes_routes_to_tiled(case, monkeypatch):
    """EGNN.forward at N=72 runs every block through the row-tiled stages
    and matches the JAX Pallas EGNN, which dispatches to its tiled kernels at
    that pad (interpret mode)."""
    _, egnn, jcfg, params = _pair(case)
    n = 72
    calls = []
    real = egnn_tiled.tiled_block_forward
    monkeypatch.setattr(egnn_tiled, "tiled_block_forward",
                        lambda *a: calls.append(a[1].shape) or real(*a))
    assert pallas_egnn.dispatch_to_tiled(n, jcfg.hidden_nf)
    h, x, _, mask = masked_inputs(4, 2, n, 6, (66, 72))
    want_h, want_x = pallas_egnn.egnn_apply_pallas(params, jcfg, jnp.asarray(h), jnp.asarray(x),
                                                   jnp.asarray(mask), interpret=True)
    with torch.no_grad():
        got_h, got_x = egnn(t(h), t(x), t(mask))
    assert len(calls) == jcfg.n_layers
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=ATOL)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=ATOL)


# ---------------------------------------------------------------------------
# The slice: GEOM-format latent diffusion
# ---------------------------------------------------------------------------


def _geom_models(seed=0, remove_h=False):
    info_p = pdatasets.get_dataset_info("geom", remove_h)
    info_j = jdatasets.get_dataset_info("geom", remove_h)
    pcfg = pfactory.make_latent_diffusion_config(info_p, **GEOM_KW)
    jcfg = jfactory.make_latent_diffusion_config(info_j, **GEOM_KW)
    model = pfactory.build_model(pcfg, "cpu", torch.Generator().manual_seed(seed))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return model, jcfg, params_from_reference_state_dict(sd, jcfg)


def test_geom_configs_match_jax():
    for remove_h in (False, True):
        info_p = pdatasets.get_dataset_info("geom", remove_h)
        info_j = jdatasets.get_dataset_info("geom", remove_h)
        assert dataclasses.asdict(info_p) == dataclasses.asdict(info_j)
        assert info_p.max_n_nodes == (91 if remove_h else 181)
        for kw in (GEOM_KW, dict(nf=256, n_layers=4, latent_nf=2, include_charges=False)):
            pcfg = pfactory.make_latent_diffusion_config(info_p, **kw)
            jcfg = jfactory.make_latent_diffusion_config(info_j, **kw)
            assert pconfig.dumps(pcfg, sort_keys=True) == jconfig.dumps(jcfg, sort_keys=True)
            assert pcfg.vae.in_node_nf == len(info_p.atom_decoder) == (15 if remove_h else 16)
            assert pcfg.vae.include_charges is False and pcfg.dynamics.in_node_nf == 2


def test_geom_zero_noise_ldm_sample_matches_jax(monkeypatch):
    """A zero-noise sample at pad 72: the JAX side runs the Pallas EGNN in
    interpret mode (its tiled kernels at that pad), the port its routed
    plain path; no charge channel on either side."""
    monkeypatch.setattr(pallas_egnn, "egnn_apply_pallas",
                        functools.partial(pallas_egnn.egnn_apply_pallas, interpret=True))
    model, jcfg, params = _geom_models(seed=1)
    n = 72
    _, _, _, mask = masked_inputs(0, 2, n, 1, (72, 61))
    rng = np.random.default_rng(3)
    z_T = rng.standard_normal((2, n, 5)).astype(np.float32) * mask
    z_T[:, :, :3] = np.asarray(jcom.remove_mean_with_mask(jnp.asarray(z_T[:, :, :3]),
                                                          jnp.asarray(mask)))
    monkeypatch.setattr(jvdm, "sample_combined_position_feature_noise",
                        lambda key, node_mask, n_dims, feat_nf: jnp.asarray(z_T))
    monkeypatch.setattr(jvdm, "sample_normal",
                        lambda key, mu, sigma, node_mask, n_dims, feat_nf, fix_noise=False: mu)
    mj = jnp.asarray(mask)
    x_j, cat_j, int_j = jlatent.ldm_sample(params, jcfg.diffusion, jcfg.dynamics, jcfg.vae,
                                           jax.random.key(0), mj, build_edge_mask(mj),
                                           compute_dtype="pallas")
    draws = iter([z_T[:, :, :3], z_T[:, :, 3:]])
    noise = lambda shape: next(draws, np.zeros(shape, dtype=np.float32))  # noqa: E731
    x_p, cat_p, int_p = platent.ldm_sample(model, noise, t(mask))

    assert cat_p.shape == (2, n, 16) and int_p.shape == (2, n, 0) == np.asarray(int_j).shape
    x_j = np.asarray(x_j)
    scale = max(float(np.abs(x_j).max()), 1.0)
    np.testing.assert_allclose(x_p.numpy() / scale, x_j / scale, atol=5e-3)
    real = mask[:, :, 0] > 0
    np.testing.assert_array_equal(cat_p.numpy().argmax(-1)[real],
                                  np.asarray(cat_j).argmax(-1)[real])


def test_default_buckets_match_jax():
    for name, remove_h in (("qm9", False), ("geom", False), ("geom", True)):
        info_p = pdatasets.get_dataset_info(name, remove_h)
        info_j = jdatasets.get_dataset_info(name, remove_h)
        assert psampling.default_buckets(info_p) == jsampling.default_buckets(info_j)
    assert covering_buckets(psampling.default_buckets(GEOM), 181) == (32, 48, 64, 96, 136, 184)
    assert covering_buckets(psampling.default_buckets(GEOM), 91) == (32, 48, 64, 96)


@pytest.mark.parametrize("batch_size", [1, 4, 16])
def test_n_chunks_counts_the_chunks_sample_bucketed_dispatches(batch_size, monkeypatch):
    sizes = np.concatenate([np.random.default_rng(0).integers(3, 182, 40), [181, 32, 33, 64, 65]])
    dispatched = []

    def fake_sample(model, noise, dataset_info, nodesxsample, fix_noise=False, pad_nodes=None,
                    **sampler_settings):
        b = len(nodesxsample)
        dispatched.append((pad_nodes, b, int(np.max(nodesxsample))))
        mask = (np.arange(pad_nodes)[None] < np.asarray(nodesxsample)[:, None])
        return (torch.zeros(b, pad_nodes, 16), torch.zeros(b, pad_nodes, 0),
                torch.zeros(b, pad_nodes, 3), mask.astype(np.float32)[..., None])

    monkeypatch.setattr(psampling, "sample", fake_sample)
    buckets = psampling.default_buckets(GEOM)
    one_hot, _, _, node_mask = psampling.sample_bucketed(torch.nn.Linear(1, 1), 0, GEOM, sizes,
                                                         batch_size, buckets)
    assert len(dispatched) == psampling.n_chunks(sizes, batch_size, buckets)
    assert [d[0] for d in dispatched] == psampling.chunk_pads(sizes, batch_size, buckets)
    for pad, b, largest in dispatched:
        assert pad in buckets and largest <= pad and b <= batch_size
    assert one_hot.shape == (len(sizes), 184, 16)
    np.testing.assert_array_equal(node_mask[:, :, 0].sum(axis=1), sizes)


def test_geom_checkpoint_round_trip(tmp_path):
    model, jcfg, _ = _geom_models(seed=2)
    save_reference_checkpoint(model, str(tmp_path), dataset="geom")
    with open(tmp_path / "args.pickle", "rb") as f:
        args = pickle.load(f)
    assert args.dataset == "geom" and args.include_charges is False and args.latent_nf == 2
    loaded, cfg, _ = load_reference_checkpoint(str(tmp_path), "cpu")
    assert cfg == model.cfg
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    # JAX GEOM-config params load strict into the port's GEOM model.
    params = jfactory.init_params(jax.random.key(5), jcfg)
    sd = state_dict_from_params(jax.tree.map(np.asarray, params), jcfg)
    fresh = pfactory.build_model(cfg, "cpu")
    fresh.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    w = params["dynamics"]["egnn"]["embedding"]["w"]
    np.testing.assert_array_equal(fresh.dynamics.egnn.embedding.weight.detach().numpy(),
                                  np.asarray(w).T)


def _molecule(rng, n):
    """A GEOM-decoder molecule of n atoms on a jittered 1.4 A grid, so most
    atoms have bonded neighbours."""
    side = int(np.ceil(n ** (1 / 3)))
    grid = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pos = grid[rng.permutation(len(grid))[:n]] * 1.4 + rng.normal(0, 0.08, (n, 3))
    types = rng.choice(len(GEOM.atom_decoder), size=n,
                       p=[0.45, 0.005, 0.33, 0.08, 0.08, 0.02] + [0.0035] * 10)
    return pos, types


@pytest.mark.parametrize("n", [150, 163, 177, 181])
def test_geom_check_stability_matches_jax(n):
    rng = np.random.default_rng(n)
    results = []
    for _ in range(3):
        pos, types = _molecule(rng, n)
        got = check_stability(pos, types, GEOM)
        assert got == jax_check_stability(pos, types, jdatasets.get_dataset_info("geom"))
        results.append(got)
    assert all(r[2] == n for r in results) and max(r[1] for r in results) > 0


# ---------------------------------------------------------------------------
# The server with --dataset geom, on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def geom_model_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("port_serve_geom") / "ckpt"
    cfg = pfactory.make_latent_diffusion_config(GEOM, nf=16, n_layers=1, latent_nf=2,
                                                include_charges=False, diffusion_steps=3)
    model = pfactory.build_model(cfg, "cpu", torch.Generator().manual_seed(0))
    save_reference_checkpoint(model, str(path), dataset="geom")
    return str(path)


@pytest.fixture(scope="module")
def geom_server(geom_model_dir):
    from geoldm_tpu_torch.cli import serve

    srv, service = serve.main(["--model_path", geom_model_dir, "--dataset", "geom", "--port", "0",
                               "--batch_max", "4", "--device", "cpu"], serve_forever=False)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", service
    srv.shutdown()
    srv.server_close()


def test_geom_server_health_lists_the_geom_buckets(geom_server, geom_model_dir):
    from geoldm_tpu_torch.cli import serve

    base, _ = geom_server
    code, body = _request(base, "/health")
    assert code == 200 and body["dataset"] == "geom"
    assert body["buckets"] == [32, 48, 64, 96, 136, 184]
    no_h = serve.SamplerService(serve.parse_args(["--model_path", geom_model_dir, "--dataset",
                                                  "geom", "--remove_h", "--device", "cpu"]))
    assert no_h.buckets == (32, 48, 64, 96) and no_h.max_request_size == 91


def test_geom_server_seeded_request_in_every_bucket_replays(geom_server, monkeypatch):
    base, _ = geom_server
    calls = []
    real = egnn_tiled.tiled_block_forward
    monkeypatch.setattr(egnn_tiled, "tiled_block_forward",
                        lambda *a: calls.append(a[1].shape[1]) or real(*a))
    req = {"sizes": [20, 40, 60, 90, 130, 181], "seed": 11}
    code, a = _request(base, "/sample", req)
    assert code == 200 and a["n"] == 6 and a["seed"] == 11
    assert [len(m) for m in a["molecules"]] == req["sizes"]
    for mol in a["molecules"]:
        for el, *xyz in mol:
            assert el in GEOM.atom_decoder and np.all(np.isfinite(xyz))
    # Chunks padded to 96, 136 and 184 ran the row-tiled stages: 3 steps + 1
    # final denoiser call and 1 decoder block each.
    assert sorted(set(calls)) == [96, 136, 184] and len(calls) == 3 * (3 + 1 + 1)
    code, b = _request(base, "/sample", req)
    assert code == 200 and b["molecules"] == a["molecules"] and b["stable"] == a["stable"]


def test_geom_server_refuses_sizes_past_181(geom_server):
    base, service = geom_server
    errors = service.errors
    code, body = _request(base, "/sample", {"sizes": [40, 182]})
    assert code == 400 and "181" in body["error"]
    assert service.errors == errors + 1
