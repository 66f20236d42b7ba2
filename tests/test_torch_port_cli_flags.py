"""Every flag of the JAX package's CLIs parses in the port's counterpart, the
flag sets taken from JAX's own parser objects; ``--trace`` writes one
``torch.profiler`` trace a rank and epoch; ``--visualize_every_batch`` is
accepted (and unused, as in JAX); ``main_qm9 --force_download`` prepares
QM9 from the raw files. JAX's two JAX-format checkpoint converters
(``convert_torch_checkpoint``, ``export_torch_checkpoint``) have no port: the
port reads and writes the upstream layout itself."""

import argparse
import importlib
import json
import os

import numpy as np
import pytest

from geoldm_tpu_torch.cli import main_qm9
from geoldm_tpu_torch.data import qm9 as pqm9
from geoldm_tpu_torch.data.datasets_config import get_dataset_info
from geoldm_tpu_torch.data.synthetic import write_gdb9_raw, write_qm9_splits

CLIS = ("main_qm9", "main_geom_drugs", "main_qm9_prop", "eval_analyze", "eval_sample",
        "eval_conditional_qm9", "serve", "check_data", "bench_train", "build_geom_dataset")
_PARSE = argparse.ArgumentParser.parse_args


class _Parser(Exception):
    def __init__(self, parser):
        super().__init__("parser captured")
        self.parser = parser


def _parser(module, monkeypatch):
    """The ArgumentParser a CLI module builds, caught at its parse_args."""
    def capture(self, *a, **k):
        raise _Parser(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        entry = getattr(module, "parse_args", None) or module.main
        with pytest.raises(_Parser) as caught:
            entry([])
    return caught.value.parser


def _value(action) -> list:
    """Command-line words giving ``action`` a value of its kind."""
    if action.nargs == 0:
        return []
    if action.choices:
        return [str(list(action.choices)[-1])]
    default = action.default
    if action.nargs in ("+", "*"):
        return [str(v) for v in default] if default else ["alpha"]
    if default is None:
        return {int: ["3"], float: ["0.5"], eval: ["None"]}.get(action.type, ["x"])
    return [str(default)]


def _full_argv(parser) -> list:
    argv = []
    for action in parser._actions:
        if isinstance(action, argparse._HelpAction) or not action.option_strings:
            continue
        flag = max(action.option_strings, key=len)
        argv += [flag, *_value(action)]
    return argv


@pytest.mark.parametrize("cli", CLIS)
def test_every_jax_flag_parses_in_the_port(cli, monkeypatch):
    jax_parser = _parser(importlib.import_module(f"geoldm_tpu.cli.{cli}"), monkeypatch)
    port_parser = _parser(importlib.import_module(f"geoldm_tpu_torch.cli.{cli}"), monkeypatch)
    argv = _full_argv(jax_parser)
    jax_args = _PARSE(jax_parser, argv)
    args = _PARSE(port_parser, argv)
    for name, value in vars(jax_args).items():
        assert getattr(args, name) == value, (cli, name)


def test_trace_writes_one_trace_a_rank_and_epoch(tmp_path):
    """Two data ranks on the CPU, one epoch: a Chrome trace of the train loop
    from each rank, naming its epoch and rank, holding the training's ops
    and the program's train-step spans; ``--visualize_every_batch 3``
    accepted."""
    data = str(tmp_path / "data")
    write_qm9_splits(data, get_dataset_info("qm9"), {"train": 16, "valid": 4, "test": 4}, seed=5)
    trace = tmp_path / "trace"
    summary = main_qm9.main([
        "--datadir", data, "--outdir", str(tmp_path / "out"), "--exp_name", "traced",
        "--train_diffusion", "--trainable_ae", "--n_epochs", "1", "--test_epochs", "1",
        "--batch_size", "8", "--nf", "16", "--n_layers", "1", "--diffusion_steps", "4",
        "--n_stability_samples", "2", "--device", "cpu", "--dp", "2", "--no_wandb",
        "--trace", str(trace), "--visualize_every_batch", "3"])
    assert [r["rank"] for r in summary["replicas"]] == [0, 1]
    assert sorted(os.listdir(trace)) == ["trace_epoch0_rank0.json", "trace_epoch0_rank1.json"]
    for name in os.listdir(trace):
        events = json.load(open(trace / name))["traceEvents"]
        assert any("addmm" in e.get("name", "") or "linear" in e.get("name", "")
                   for e in events), name
        names = {e.get("name") for e in events}
        assert {"geoldm.train.step", "geoldm.train.grad_reduce"} <= names, name


def test_force_download_prepares_qm9_from_the_raw_files(tmp_path, monkeypatch):
    """``main_qm9 --force_download`` on a datadir holding the raw GDB9 files
    (and stale splits): the splits rebuilt from them, then one epoch; the
    network refused."""
    def refuse(url, filename=None, *a, **k):
        raise OSError(f"network refused in tests: {url}")

    monkeypatch.setattr(pqm9.urllib.request, "urlretrieve", refuse)
    data = str(tmp_path / "data")
    write_gdb9_raw(data, 64, seed=6)
    for split in ("train", "valid", "test"):
        np.savez_compressed(os.path.join(data, "qm9", f"{split}.npz"), num_atoms=np.zeros(1))
    summary = main_qm9.main([
        "--datadir", data, "--outdir", str(tmp_path / "out"), "--exp_name", "prep",
        "--train_diffusion", "--trainable_ae", "--n_epochs", "1", "--test_epochs", "1",
        "--batch_size", "16", "--nf", "16", "--n_layers", "1", "--diffusion_steps", "4",
        "--n_stability_samples", "2", "--device", "cpu", "--no_wandb", "--force_download"])
    assert len(summary["losses"][0]) == 50 // 16
    with np.load(os.path.join(data, "qm9", "train.npz")) as f:
        assert len(f["num_atoms"]) == 50 and "U0_thermo" in f.files
