"""The data-parallel CLIs on the CPU over gloo ranks: ``cli.main_qm9 --dp 2``
against the one-rank run (the same losses, NLLs and stability samples, the
replicas bit-identical) and its ``--resume``; ``cli.main_geom_drugs --dp 2
--sp 2`` (four ranks; the size buckets' uneven tails trimmed); and
``cli.eval_analyze --dp 2`` against ``--dp 1``: the same molecules, bit for
bit, and the same NLL up to the sum order. Tolerances as
tests/test_torch_port_dp.py (loss 1e-5 relative); the NLLs 1e-5 relative."""

import os

import numpy as np
import pytest
import torch

from geoldm_tpu_torch.cli import eval_analyze, main_geom_drugs, main_qm9
from geoldm_tpu_torch.data.datasets_config import get_dataset_info
from geoldm_tpu_torch.data.synthetic import write_geom_conformers, write_qm9_splits
from geoldm_tpu_torch.models import factory
from geoldm_tpu_torch.utils.convert import save_reference_checkpoint

torch.set_num_threads(1)

QM9 = get_dataset_info("qm9")
RTOL = 1e-5


@pytest.fixture(scope="module")
def qm9_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dp_qm9"))
    write_qm9_splits(path, QM9, {"train": 24, "valid": 16, "test": 7}, seed=2)
    return path


def _argv(datadir, outdir, name):
    return ["--datadir", datadir, "--outdir", outdir, "--exp_name", name, "--train_diffusion",
            "--trainable_ae", "--nf", "16", "--n_layers", "1", "--diffusion_steps", "6",
            "--batch_size", "8", "--test_epochs", "1", "--n_stability_samples", "5",
            "--ema_decay", "0.99", "--device", "cpu", "--no_wandb"]


def test_main_qm9_dp2_matches_one_rank_and_resumes(qm9_dir, tmp_path):
    """Three steps of 8 molecules over 2 data ranks: the losses and the valid
    NLL (16 molecules, no tail) of the one-rank run, the same stability
    samples (their chunks fanned out over the ranks), the replicas
    bit-identical; resumed with --dp 2, every rank loads the same latest/
    and the replicas stay bit-identical."""
    out = str(tmp_path)
    one = main_qm9.main(_argv(qm9_dir, out, "one") + ["--n_epochs", "1"])
    dp = main_qm9.main(_argv(qm9_dir, out, "dp") + ["--n_epochs", "1", "--dp", "2"])
    np.testing.assert_allclose(dp["losses"][0], one["losses"][0], rtol=RTOL)
    np.testing.assert_allclose(dp["nll_val"], one["nll_val"], rtol=RTOL)
    assert dp["stability"] == one["stability"]
    assert dp["sample_sizes"][0].tolist() == one["sample_sizes"][0].tolist()
    replicas = dp["replicas"]
    assert [r["rank"] for r in replicas] == [0, 1]
    assert len({r["digest"] for r in replicas}) == 1, "the replicas differ"
    assert replicas[0]["stability"] == replicas[1]["stability"] == dp["stability"]
    # Rank 0 alone writes: metrics.jsonl holds the one-rank run's lines.
    lines = [open(os.path.join(out, name, "metrics.jsonl")).read().count("\n")
             for name in ("one", "dp")]
    assert lines[0] == lines[1] > 0
    assert os.path.isdir(os.path.join(out, "dp", "latest"))
    resumed = main_qm9.main(_argv(qm9_dir, out, "dp") + [
        "--n_epochs", "2", "--start_epoch", "1", "--dp", "2",
        "--resume", os.path.join(out, "dp")])
    replicas = resumed["replicas"]
    assert len({r["resumed_digest"] for r in replicas}) == 1
    assert len({r["digest"] for r in replicas}) == 1
    assert replicas[0]["digest"] != replicas[0]["resumed_digest"]
    assert len(resumed["losses"][0]) == 3 and np.all(np.isfinite(resumed["losses"][0]))


def test_main_geom_drugs_dp2_x_sp2_keeps_the_replicas_in_step(tmp_path, capsys):
    """Four ranks (data index r // 2, seq index r % 2): one epoch of the
    size-bucketed GEOM batches, each batch trimmed to an even size, NLLs
    over the grid, the four replicas bit-identical."""
    geom = get_dataset_info("geom")
    write_geom_conformers(str(tmp_path), geom, 20, seed=4, sizes=[20, 25, 30, 28, 33, 22, 27])
    summary = main_geom_drugs.main([
        "--datadir", str(tmp_path), "--outdir", str(tmp_path / "out"), "--exp_name", "grid",
        "--dp", "2", "--sp", "2", "--train_diffusion", "--trainable_ae", "--n_epochs", "1",
        "--test_epochs", "1", "--batch_size", "4", "--nf", "16", "--n_layers", "1",
        "--diffusion_steps", "6", "--n_stability_samples", "3", "--ema_decay", "0.99",
        "--device", "cpu", "--no_wandb"])
    out = capsys.readouterr().out
    assert "dp x sp: 4 ranks on the CPU, backend gloo" in out
    assert np.all(np.isfinite(summary["losses"][0])) and summary["losses"][0]
    assert np.isfinite(summary["nll_val"][0]) and np.isfinite(summary["nll_test"][0])
    replicas = summary["replicas"]
    assert [r["rank"] for r in replicas] == [0, 1, 2, 3]
    assert len({r["digest"] for r in replicas}) == 1, "the replicas differ"
    assert all(r["stability"] == summary["stability"] for r in replicas)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    cfg = factory.make_latent_diffusion_config(QM9, nf=16, n_layers=1, latent_nf=2,
                                               diffusion_steps=8)
    model = factory.build_model(cfg, "cpu", torch.Generator().manual_seed(3))
    path = str(tmp_path_factory.mktemp("dp_eval") / "run")
    save_reference_checkpoint(model, os.path.join(path, "best"))
    return path


def test_eval_analyze_dp2_equals_dp1(qm9_dir, checkpoint):
    """``--dp 2`` fans 9 molecules' chunks out over two ranks and splits
    every packed NLL batch (4 rows; the 7 test molecules padded with a
    weight-0 row) over them: the molecules of ``--dp 1``, bit for bit, the
    same scores, and the NLLs within 1e-5 relative; rank 0 writes the log."""
    argv = ["--model_path", checkpoint, "--datadir", qm9_dir, "--n_samples", "9",
            "--batch_size_gen", "2", "--batch_size_nll", "4", "--n_test_passes", "2",
            "--device", "cpu"]
    one = eval_analyze.main(argv)
    log_one = open(os.path.join(checkpoint, "eval_log.txt")).read().splitlines()
    os.remove(os.path.join(checkpoint, "eval_log.txt"))
    two = eval_analyze.main(argv + ["--dp", "2"])
    for k in ("one_hot", "x", "node_mask", "n_atoms"):
        np.testing.assert_array_equal(two["molecules"][k], one["molecules"][k])
    assert two["stability"] == one["stability"] and two["rdkit"] == one["rdkit"]
    for got, want in zip([two["nll_val"], *two["nll_tests"]], [one["nll_val"], *one["nll_tests"]]):
        assert abs(got - want) <= RTOL * abs(want)
    log_two = open(os.path.join(checkpoint, "eval_log.txt")).read().splitlines()
    assert [ln.split()[0] for ln in log_two] == [ln.split()[0] for ln in log_one]
