"""Port parity on CPU for the evaluation slice: the packed multi-pass NLL,
the canonical SMILES writer and parser, the validity/uniqueness/novelty
triple (with the training-set and the external novelty bases), the native
stability batch, and the eval_analyze / check_data CLIs, each against the
JAX package on the same numpy-seeded inputs. JAX's draws are rebuilt from
its keys (tests/torch_port_utils.py) and handed to the port's noise
sources."""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from geoldm_tpu.data.datasets_config import get_dataset_info as jax_info
from geoldm_tpu.evalsuite import analyze as jan
from geoldm_tpu.evalsuite import rdkit_metrics as jrm
from geoldm_tpu.evalsuite import smiles as jsm
from geoldm_tpu.models import factory as jfactory
from geoldm_tpu.models.distributions import DistributionNodes as JNodes
from geoldm_tpu.train import trainer as jtrainer
from geoldm_tpu_torch.cli import check_data, eval_analyze
from geoldm_tpu_torch.data.datasets_config import get_dataset_info
from geoldm_tpu_torch.data.qm9 import load_qm9
from geoldm_tpu_torch.data.synthetic import write_qm9_splits
from geoldm_tpu_torch.evalsuite import analyze as pan
from geoldm_tpu_torch.evalsuite import native as pnative
from geoldm_tpu_torch.evalsuite import rdkit_metrics as prm
from geoldm_tpu_torch.evalsuite import smiles as psm
from geoldm_tpu_torch.models import factory as pfactory
from geoldm_tpu_torch.models.distributions import DistributionNodes
from geoldm_tpu_torch.train import trainer as ptrainer
from geoldm_tpu_torch.utils.convert import save_reference_checkpoint, state_dict_from_jax_params
from tests.torch_port_utils import Feed, jax_ldm_draws

torch.set_num_threads(1)

INFO = get_dataset_info("qm9")
JINFO = jax_info("qm9")
# Per-pass NLL means: f32 through two frameworks' op orders (the port's RTOL).
RTOL = 2e-5
KW = dict(nf=16, n_layers=1, latent_nf=2, diffusion_steps=10, trainable_ae=True)


@pytest.fixture(scope="module")
def datadir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("qm9_eval"))
    write_qm9_splits(path, INFO, {"train": 16, "valid": 7, "test": 5}, seed=3)
    return path


@pytest.fixture(scope="module")
def pair():
    jcfg = jfactory.make_latent_diffusion_config(JINFO, **KW)
    pcfg = pfactory.make_latent_diffusion_config(INFO, **KW)
    params = jfactory.init_params(jax.random.key(5), jcfg)
    model = pfactory.build_model(pcfg, "cpu")
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params), pcfg),
                          strict=True)
    return jcfg, pcfg, params, model


def _pass_feeds(key, n_passes, steps, b, n, augment):
    """The port's per-pass noise sources replaying JAX's packed-NLL draws:
    pass keys split from ``key``, ``fold_in(pass_key, step)`` per batch, the
    augment noise from ``fold_in(k, 0x5EED)`` before the NLL's own draws."""
    feeds = []
    for _ in range(n_passes):
        key, sub = jax.random.split(key)
        draws = []
        for s in range(steps):
            k = jax.random.fold_in(sub, s)
            if augment:
                eps = jax.random.normal(jax.random.fold_in(k, 0x5EED), (b, n, 3))
                draws.append(("n", np.asarray(eps)))
            draws += jax_ldm_draws(k, b, n, KW["latent_nf"], KW["diffusion_steps"], True)
        feeds.append(Feed(draws))
    return feeds


@pytest.mark.parametrize("split,batch,passes,stage_bytes,augment", [
    ("valid", 3, 2, 2 << 30, 0.0),   # 7 molecules: a tail of 1, padded by 2 repeats
    ("test", 8, 1, 2 << 30, 0.0),    # 5 molecules: smaller than one batch
    ("valid", 2, 2, 1, 0.0),         # one batch a segment: 4 segments, passes inner
    ("test", 2, 2, 2 << 30, 0.3),    # augment noise on 3 batches
])
def test_packed_nll_matches_jax(datadir, pair, split, batch, passes, stage_bytes, augment):
    jcfg, pcfg, params, model = pair
    splits, _ = load_qm9(datadir)
    d = splits[split]
    n = INFO.max_n_nodes
    key = jax.random.key(11)
    want = jtrainer.evaluate_nll_packed(params, jcfg, d, JNodes(JINFO.n_nodes), key,
                                        batch_size=batch, pad_nodes=n, n_passes=passes,
                                        augment_noise=augment, stage_bytes=stage_bytes)
    steps = -(-len(d["num_atoms"]) // batch)
    feeds = _pass_feeds(key, passes, steps, batch, n, augment > 0)
    got = ptrainer.evaluate_nll_packed(model, pcfg, d, DistributionNodes(INFO.n_nodes), feeds,
                                       batch_size=batch, pad_nodes=n, augment_noise=augment,
                                       stage_bytes=stage_bytes)
    assert all(not f.draws for f in feeds), "a pass left draws unused"
    assert len(got) == passes
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_packed_nll_of_an_empty_split(pair):
    _, pcfg, _, model = pair
    empty = {"num_atoms": np.zeros(0, np.int64), "positions": np.zeros((0, 29, 3), np.float32),
             "one_hot": np.zeros((0, 29, 5), np.float32), "charges": np.zeros((0, 29))}
    got = ptrainer.evaluate_nll_packed(model, pcfg, empty, DistributionNodes(INFO.n_nodes),
                                       [None, None, None])
    assert got == [0.0, 0.0, 0.0]


def _mol(bonds, symbols, charges=None):
    orders = np.zeros((len(symbols), len(symbols)), dtype=np.int64)
    for i, j, o in bonds:
        orders[i, j] = orders[j, i] = o
    return symbols, orders, charges


def _random_graph(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 10))
    symbols = [str(s) for s in rng.choice(["C", "N", "O", "H"], n)]
    bonds = [(i, int(rng.integers(0, i)), int(rng.integers(1, 3))) for i in range(1, n)]
    return _mol(bonds, symbols)


CYCLOPROPANE = _mol([(0, 1, 1), (1, 2, 1), (2, 0, 1)] + [(i, 3 + 2 * i, 1) for i in range(3)]
                    + [(i, 4 + 2 * i, 1) for i in range(3)], ["C"] * 3 + ["H"] * 6)
RING11 = _mol([(i, (i + 1) % 11, 1) for i in range(11)], ["C"] * 11)
GRAPHS = [
    _mol([(0, 1, 1), (0, 2, 1), (0, 3, 1), (0, 4, 1)], ["C", "H", "H", "H", "H"]),
    _mol([(0, 1, 1), (0, 2, 1)], ["O", "H", "H"]),
    _mol([(0, 1, 2), (0, 2, 2)], ["C", "O", "O"]),
    _mol([(0, 1, 1), (1, 2, 3)], ["H", "C", "N"]),
    CYCLOPROPANE, RING11, *(_random_graph(s) for s in range(6)),
]


@pytest.mark.parametrize("k", range(len(GRAPHS)))
def test_canonical_smiles_match_jax(k):
    """The writer on known and random graphs, permuted, and with a branch
    budget that runs out (the WL fallback key)."""
    symbols, orders, charges = GRAPHS[k]
    perm = np.random.default_rng(k).permutation(len(symbols))
    permuted = ([symbols[i] for i in perm], orders[np.ix_(perm, perm)], None)
    for mol in ((symbols, orders, charges), permuted):
        assert psm.canonical_smiles(*mol) == jsm.canonical_smiles(*mol)
        assert psm.canonical_smiles(*mol, branch_budget=2) == \
            jsm.canonical_smiles(*mol, branch_budget=2)


@pytest.mark.parametrize("text", [
    "CCO", "COC", "CCCC", "CC(C)C", "C(=O)O", "N#Cc1ccccc1", "c1ccccc1", "C1=CC=CC=C1",
    "C1CCCCC1", "c1ccncc1", "c1cc[nH]c1", "[NH4+]", "[O-]C", "c1ccc2ccccc2c1",
    "c1cc2ccc3cccc4ccc(c1)c2c34", "Cn1cnc2c1c(=O)n(C)c(=O)n2C", "O=C(O)c1ccccc1O",
    "C%10CCCCCCCCC%10", "C.C", "C/C=C/C", "[13C]", "C@H", "C1CC",
])
def test_smiles_parse_and_recanonicalize_match_jax(text):
    """The parser and re-canonicalization on the JAX tests' strings; the
    unsupported ones raise in both."""
    try:
        want = jsm.recanonicalize(text)
    except jsm.SmilesError:
        with pytest.raises(psm.SmilesError):
            psm.recanonicalize(text)
        return
    assert psm.recanonicalize(text) == want
    ps, po, pc = psm.parse_smiles(text)
    js, jo, jc = jsm.parse_smiles(text)
    assert ps == js and np.array_equal(po, jo) and list(pc) == list(jc)


# QM9 decoder order (H, C, N, O, F); the JAX metric tests' geometries.
_H, _O = 0, 3
WATER = (np.array([[0.0, 0.0, 0.0], [0.96, 0.0, 0.0], [0.0, 0.96, 0.0]]), np.array([_O, _H, _H]))
WATER_PERM = (np.array([[2.0, 2.96, 0.0], [2.0, 2.0, 0.0], [2.96, 2.0, 0.0]]),
              np.array([_H, _O, _H]))
H2 = (np.array([[0.0, 0.0, 0.0], [0.74, 0.0, 0.0]]), np.array([_H, _H]))
BAD_O3H = (np.array([[0.0, 0.0, 0.0], [0.96, 0.0, 0.0], [-0.96, 0.0, 0.0], [0.0, 0.96, 0.0]]),
           np.array([_O, _H, _H, _H]))


def _generated(datadir):
    """The JAX tests' molecules, then the fabricated test split (random
    geometries: radicals, over-valent atoms and fragments), scaled so that
    bonds form."""
    splits, _ = load_qm9(datadir)
    d = splits["test"]
    mols = [WATER, WATER_PERM, H2, BAD_O3H]
    for scale in (0.6, 0.8):
        mols += [(d["positions"][i, :n] * scale, np.argmax(d["one_hot"][i, :n], -1))
                 for i, n in enumerate(d["num_atoms"])]
    return mols


@pytest.mark.parametrize("base", ["training set", "external", "none"])
def test_fallback_triple_matches_jax(datadir, base):
    mols = _generated(datadir)
    if base == "training set":
        # The port computes (and caches) the base from this datadir's train
        # split; JAX computes it from the same split.
        want_base = jrm.compute_dataset_fallback_smiles(JINFO, datadir)
        got = prm.FallbackMolecularMetrics(INFO, datadir=datadir)
        assert got.dataset_smiles_list == want_base
        want = jrm.FallbackMolecularMetrics(JINFO, dataset_keys_list=want_base)
    elif base == "external":
        external = ["O", "[H][H]", "C1CC", "CCO", "[13C]"]
        got = prm.FallbackMolecularMetrics(INFO, external_smiles=external)
        want = jrm.FallbackMolecularMetrics(JINFO, external_smiles=external)
    else:
        got = prm.FallbackMolecularMetrics(INFO, datadir=os.path.join(datadir, "absent"))
        want = jrm.FallbackMolecularMetrics(JINFO, datadir=os.path.join(datadir, "absent"))
        assert got.dataset_smiles_list is want.dataset_smiles_list is None
    assert got.source == want.source == "valence-fallback"
    for i, (pos, types) in enumerate(mols):
        assert prm.molecule_fallback_smiles(pos, types, INFO) == \
            jrm.molecule_fallback_smiles(pos, types, JINFO), i
    (g_triple, g_unique), (w_triple, w_unique) = got.evaluate(mols), want.evaluate(mols)
    assert g_triple == w_triple and sorted(g_unique) == sorted(w_unique)
    assert 0 < g_triple[0] < 1 and 0 < g_triple[1] <= 1


def test_novelty_cache_is_keyed_on_the_split(tmp_path):
    """Two datadirs, and the same datadir rewritten with another split, never
    share the cached training-set SMILES (JAX keys its cache on the dataset
    name alone)."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    write_qm9_splits(a, INFO, {"train": 6, "valid": 2, "test": 2}, seed=1)
    write_qm9_splits(b, INFO, {"train": 6, "valid": 2, "test": 2}, seed=2)
    first = prm.retrieve_qm9_fallback_smiles(INFO, a)
    assert prm.retrieve_qm9_fallback_smiles(INFO, b) == \
        jrm.compute_dataset_fallback_smiles(JINFO, b) != first
    write_qm9_splits(a, INFO, {"train": 6, "valid": 2, "test": 2}, seed=2)
    assert prm.retrieve_qm9_fallback_smiles(INFO, a) == \
        jrm.compute_dataset_fallback_smiles(JINFO, a)
    assert len(os.listdir(os.path.join(a, "cache"))) == 2
    assert all(f.startswith("geoldm_tpu_torch_qm9_") for f in os.listdir(os.path.join(a, "cache")))


def _padded_set(seed, m=30, n_max=14):
    rng = np.random.default_rng(seed)
    x = np.zeros((m, n_max, 3), np.float32)
    one_hot = np.zeros((m, n_max, 5), np.float32)
    node_mask = np.zeros((m, n_max), np.float32)
    for i in range(m):
        n = int(rng.integers(2, n_max + 1))
        x[i, :n] = rng.standard_normal((n, 3)) * 1.1
        one_hot[i, np.arange(n), rng.integers(0, 5, n)] = 1
        node_mask[i, :n] = 1
    x[0, :3], one_hot[0, :3], node_mask[0, :3] = WATER[0], np.eye(5)[WATER[1]], 1
    return {"x": x, "one_hot": one_hot, "node_mask": node_mask}


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ to build native/stability.cpp")
def test_native_stability_counts_match_python_and_jax(tmp_path):
    mols = _padded_set(7)
    args = (mols["x"], mols["one_hot"], mols["node_mask"], INFO)
    native = pan.stability_counts(*args, use_native=True)
    python = pan.stability_counts(*args, use_native=False)
    assert native[3] == "native" and python[3] == "python"
    assert native[:3] == python[:3]
    assert pnative.build_info["path"].startswith(str(pnative.BUILD_DIR))
    assert os.path.basename(pnative.build_info["path"]) == pnative.library_path().name
    report = {}
    got = pan.analyze_stability_for_molecules(mols, INFO, datadir=str(tmp_path), report=report)
    want = jan.analyze_stability_for_molecules(mols, JINFO, datadir=str(tmp_path))
    assert report["stability_path"] == "native" and report["triple_backend"] == "valence-fallback"
    assert got == want
    assert got[0]["mol_stable"] * 30 == native[0]


@pytest.fixture(scope="module")
def checkpoint(pair, tmp_path_factory):
    _, _, _, model = pair
    path = str(tmp_path_factory.mktemp("eval_ckpt") / "run")
    save_reference_checkpoint(model, os.path.join(path, "best"))
    return path


def test_eval_analyze_on_cpu(datadir, checkpoint, capsys):
    """Generation, stability (native), the triple, the packed NLL on valid
    and 5 test passes; eval_log.txt and generated_smiles.txt beside the
    run directory given."""
    summary = eval_analyze.main(["--model_path", checkpoint, "--datadir", datadir,
                                 "--n_samples", "10", "--batch_size_nll", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert summary["n_samples"] == 10 and len(summary["nll_tests"]) == 5
    assert all(0.0 <= v <= 1.0 for v in summary["rdkit"])
    assert np.isfinite(summary["nll_val"]) and np.all(np.isfinite(summary["nll_tests"]))
    if shutil.which("g++"):
        assert summary["report"]["stability_path"] == "native"
    for i in range(5):
        assert f"test[{i}] NLL: " in out
    log = open(os.path.join(checkpoint, "eval_log.txt")).read().splitlines()
    assert [ln.split()[0] for ln in log] == ["n_samples", "secs/sample", "mol_stable",
                                             "atm_stable", "validity", "nll_val", "nll_test"]
    smiles = open(os.path.join(checkpoint, "generated_smiles.txt")).read().split()
    assert smiles == sorted(summary["unique_smiles"])


def test_eval_analyze_prints_and_writes_jax_lines(monkeypatch, tmp_path, capsys):
    """Both CLIs driven with the same stubbed results (checkpoint,
    generation, packed NLL) print the same result lines and write the same
    eval_log.txt and generated_smiles.txt."""
    validity = {"mol_stable": 0.25, "atm_stable": 0.75}
    rdkit = ([0.5, 1.0, 0.5], ["[H][O][H]", "[C]"])
    molecules = {"x": np.zeros((4, 3, 3)), "n_atoms": np.ones(4), "report": {}}
    splits = {"valid": {}, "test": {}}
    passes = [[1.5], [2.0, 3.0, 4.0, 5.0, 6.0]]

    import geoldm_tpu.data.qm9 as jqm9
    import geoldm_tpu.utils.checkpoint as jckpt
    import geoldm_tpu_torch.cli.eval_analyze as pcli
    import geoldm_tpu_torch.utils.convert as pconvert
    from geoldm_tpu.cli import eval_analyze as jcli

    jnll, pnll = iter([passes[0], passes[1]]), iter([passes[0], passes[1]])
    monkeypatch.setenv("GEOLDM_NO_COMPILE_CACHE", "1")
    monkeypatch.setattr(jckpt, "load_config", lambda path: None)
    monkeypatch.setattr(jckpt, "load_checkpoint", lambda *a, **k: {"params": 0, "ema_params": 0})
    monkeypatch.setattr(jfactory, "init_params", lambda *a, **k: 0)
    monkeypatch.setattr(jtrainer, "analyze_and_save",
                        lambda *a, **k: (validity, rdkit, {"x": molecules["x"]}))
    monkeypatch.setattr(jtrainer, "evaluate_nll_packed", lambda *a, **k: next(jnll))
    monkeypatch.setattr(jqm9, "load_qm9", lambda *a, **k: (splits, 9.0))
    cfg = pfactory.make_latent_diffusion_config(INFO, nf=8, n_layers=1, diffusion_steps=4)
    monkeypatch.setattr(pconvert, "load_reference_checkpoint",
                        lambda *a, **k: (torch.nn.Linear(1, 1), cfg, None))
    monkeypatch.setattr(pcli, "load_eval_splits", lambda *a: splits)
    monkeypatch.setattr(ptrainer, "analyze_and_save", lambda *a, **k: (validity, rdkit, molecules))
    monkeypatch.setattr(ptrainer, "evaluate_nll_packed", lambda *a, **k: next(pnll))
    outputs = {}
    for name, main in (("jax", jcli.main), ("port", pcli.main)):
        path = tmp_path / name
        path.mkdir()
        (path / "args.pickle").write_bytes(b"")
        main(["--model_path", str(path), "--device", "cpu"] if name == "port"
             else ["--model_path", str(path)])
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith(("stability:", "validity", "final test NLL", "wrote"))]
        files = {f: (path / f).read_text().replace(str(path), "<dir>")
                 for f in ("eval_log.txt", "generated_smiles.txt")}
        outputs[name] = ([ln.split("; NLL phase")[0].replace(str(path), "<dir>")
                          for ln in lines], files)
    assert outputs["port"] == outputs["jax"]
    assert len(outputs["port"][0]) == 4


@pytest.mark.parametrize("flags,name", [
    (["--dp", "2", "--compute_dtype", "bfloat16_nope"], "'bfloat16_nope'"),
    (["--dp", "4", "--n_steps", "50", "--compute_dtype", "float16"], "'float16'"),
    (["--dp", "2", "--compute_dtype", "tf32"], "'tf32'"),
])
def test_eval_analyze_refuses_what_is_not_ported(flags, name):
    """``--dp`` runs (tests/test_torch_port_dp_cli.py); a compute dtype
    outside the port is refused before any rank starts."""
    with pytest.raises(ValueError) as e:
        eval_analyze.main(["--model_path", "unused", "--device", "cpu", *flags])
    assert str(e.value).startswith(f"unknown compute dtype {name}")


def test_check_data_prints_jax_lines(datadir, capsys):
    from geoldm_tpu.cli import check_data as jcheck

    summary = check_data.main(["--datadir", datadir, "--split", "valid"])
    got = capsys.readouterr().out
    jcheck.main(["--datadir", datadir, "--split", "valid"])
    want = capsys.readouterr().out
    assert got == want and len(got.splitlines()) == 4
    assert summary["n_molecules"] == 7 and summary["kl_js"] is not None


def test_eval_analyze_runs_on_the_card_by_default(checkpoint):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        eval_analyze.main(["--model_path", checkpoint, "--skip_nll"])
