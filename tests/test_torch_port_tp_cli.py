"""The tensor-parallel CLIs on the CPU over gloo ranks: ``cli.main_qm9 --tp
2`` against ``--tp 1`` (the same losses, NLLs, stability samples and
checkpoint files; the replicas in step), checkpoints resumed across
``--tp``, ``cli.main_geom_drugs --dp 2 --tp 2`` and the refusal of an
``--nf`` that ``--tp`` does not divide. Tolerances as
tests/test_torch_port_dp_cli.py (losses and NLLs 1e-5 relative); the
checkpoint tensors within 1e-3 * max|ref| (PERF.md §2's f32 gate)."""

import os

import numpy as np
import pytest
import torch

from geoldm_tpu_torch.cli import main_geom_drugs, main_qm9
from geoldm_tpu_torch.data.datasets_config import get_dataset_info
from geoldm_tpu_torch.data.synthetic import write_geom_conformers, write_qm9_splits

torch.set_num_threads(1)

QM9 = get_dataset_info("qm9")
RTOL, GATE = 1e-5, 1e-3
FILES = ("generative_model.npy", "generative_model_ema.npy", "optim.npy", "train_state.npy",
         "args.pickle")


@pytest.fixture(scope="module")
def qm9_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tp_qm9"))
    write_qm9_splits(path, QM9, {"train": 24, "valid": 16, "test": 7}, seed=2)
    return path


def _argv(datadir, outdir, name, *extra):
    return ["--datadir", datadir, "--outdir", outdir, "--exp_name", name, "--train_diffusion",
            "--trainable_ae", "--nf", "16", "--n_layers", "1", "--diffusion_steps", "6",
            "--batch_size", "8", "--test_epochs", "1", "--n_stability_samples", "5",
            "--ema_decay", "0.99", "--device", "cpu", "--no_wandb", *extra]


def _load(path, name):
    return torch.load(os.path.join(path, name), map_location="cpu", weights_only=True)


def _tensors(path):
    """Every tensor of a checkpoint directory by (file, key)."""
    out = {}
    for name in ("generative_model.npy", "generative_model_ema.npy"):
        out.update({(name, k): v for k, v in _load(path, name).items()})
    for i, entry in _load(path, "optim.npy")["state"].items():
        out.update({("optim.npy", i, k): torch.as_tensor(v) for k, v in entry.items()})
    out[("train_state.npy", "norms")] = _load(path, "train_state.npy")["clip"]["norms"]
    return out


def _equal_to_files(snapshot, path):
    """The state a run resumed (``full_state``'s CPU copy) equals the files
    it resumed from, tensor for tensor."""
    for key, name in (("model", "generative_model.npy"), ("ema", "generative_model_ema.npy")):
        want = _load(path, name)
        assert set(snapshot[key]) == set(want)
        assert all(torch.equal(snapshot[key][k], want[k]) for k in want), name
    want = _load(path, "optim.npy")
    assert snapshot["optim"]["param_groups"] == want["param_groups"]
    got = snapshot["optim"]["state"]
    assert got.keys() == want["state"].keys()
    for i, entry in want["state"].items():
        assert all(torch.equal(torch.as_tensor(got[i][k]).cpu(), torch.as_tensor(v))
                   for k, v in entry.items()), i
    extra = _load(path, "train_state.npy")
    assert snapshot["step"] == extra["step"]
    assert torch.equal(snapshot["clip"]["norms"], extra["clip"]["norms"])


def test_main_qm9_tp2_matches_tp1_and_resumes_across_tp(qm9_dir, tmp_path):
    """Three steps of 8 molecules with two model ranks against one rank:
    the losses, the valid and test NLLs, the stability samples and their
    sizes, and the checkpoint (the same five files, the same keys, every
    tensor within the f32 gate; AdamW's state dict keyed by the full
    model's order); the gathered train states bit-identical on both ranks,
    their shards not, each rank holding its share of the optimizer and EMA
    state. Then each checkpoint resumes under the other --tp, loading a
    state equal to its latest/ tensor for tensor."""
    out = str(tmp_path)
    one = main_qm9.main(_argv(qm9_dir, out, "one", "--n_epochs", "1"))
    tp = main_qm9.main(_argv(qm9_dir, out, "tp", "--n_epochs", "1", "--tp", "2"))
    np.testing.assert_allclose(tp["losses"][0], one["losses"][0], rtol=RTOL)
    np.testing.assert_allclose(tp["nll_val"], one["nll_val"], rtol=RTOL)
    np.testing.assert_allclose(tp["nll_test"], one["nll_test"], rtol=RTOL)
    assert tp["stability"] == one["stability"] and tp["rdkit"] == one["rdkit"]
    assert tp["sample_sizes"][0].tolist() == one["sample_sizes"][0].tolist()
    replicas = tp["replicas"]
    assert [r["rank"] for r in replicas] == [0, 1]
    assert len({r["digest"] for r in replicas}) == 1, "the gathered states differ"
    assert replicas[0]["shard_digest"] != replicas[1]["shard_digest"]
    assert replicas[0]["state_elements"] == replicas[1]["state_elements"]
    assert all(r["stability"] == tp["stability"] for r in replicas)
    for sub in ("latest", "best"):
        a, b = os.path.join(out, "one", sub), os.path.join(out, "tp", sub)
        assert sorted(os.listdir(a)) == sorted(os.listdir(b)) == sorted(FILES)
        want, got = _tensors(a), _tensors(b)
        assert set(got) == set(want)
        for key, ref in want.items():
            err = float((got[key].float() - ref.float()).abs().max())
            assert err <= GATE * max(float(ref.abs().max()), 1e-30), (sub, key, err)
    assert _load(os.path.join(out, "tp", "latest"), "optim.npy")["param_groups"] == \
        _load(os.path.join(out, "one", "latest"), "optim.npy")["param_groups"]
    # A --tp 1 checkpoint under --tp 2, and the reverse.
    for name, flags in (("one", ["--tp", "2"]), ("tp", [])):
        resumed = main_qm9.main(_argv(qm9_dir, out, f"{name}_resumed", "--n_epochs", "2",
                                      "--start_epoch", "1", "--resume", os.path.join(out, name),
                                      *flags))
        _equal_to_files(resumed["resumed"], os.path.join(out, name, "latest"))
        assert len(resumed["losses"][0]) == 3 and np.all(np.isfinite(resumed["losses"][0]))
        if flags:
            assert len({r["resumed_digest"] for r in resumed["replicas"]}) == 1
            assert len({r["digest"] for r in resumed["replicas"]}) == 1


def test_main_geom_drugs_dp2_x_tp2_keeps_the_replicas_in_step(tmp_path, capsys):
    """Four ranks (data index r // 2, model index r % 2): one epoch of the
    size-bucketed GEOM batches, NLLs over the grid, the gathered states of
    all four bit-identical and the shards of each model index equal."""
    geom = get_dataset_info("geom")
    write_geom_conformers(str(tmp_path), geom, 20, seed=4, sizes=[20, 25, 30, 28, 33, 22, 27])
    summary = main_geom_drugs.main([
        "--datadir", str(tmp_path), "--outdir", str(tmp_path / "out"), "--exp_name", "grid",
        "--dp", "2", "--tp", "2", "--train_diffusion", "--trainable_ae", "--n_epochs", "1",
        "--test_epochs", "1", "--batch_size", "4", "--nf", "16", "--n_layers", "1",
        "--diffusion_steps", "6", "--n_stability_samples", "3", "--ema_decay", "0.99",
        "--device", "cpu", "--no_wandb"])
    out = capsys.readouterr().out
    assert ("dp x tp: 4 ranks on the CPU, backend gloo (data index r // 2, model index r % 2)"
            in out)
    assert np.all(np.isfinite(summary["losses"][0])) and summary["losses"][0]
    assert np.isfinite(summary["nll_val"][0]) and np.isfinite(summary["nll_test"][0])
    replicas = summary["replicas"]
    assert [r["rank"] for r in replicas] == [0, 1, 2, 3]
    assert len({r["digest"] for r in replicas}) == 1, "the replicas differ"
    shards = [r["shard_digest"] for r in replicas]
    assert shards[0] == shards[2] and shards[1] == shards[3] and shards[0] != shards[1]
    assert all(r["stability"] == summary["stability"] for r in replicas)


@pytest.mark.parametrize("main", [main_qm9.main, main_geom_drugs.main])
def test_nf_that_tp_does_not_divide_is_refused(main, tmp_path):
    with pytest.raises(SystemExit) as e:
        main(["--datadir", str(tmp_path), "--device", "cpu", "--nf", "30", "--tp", "4"])
    assert str(e.value.code) == ("--tp 4 shards every --nf-wide parameter over 4 model ranks, "
                                 "but --nf 30 does not divide by 4")
