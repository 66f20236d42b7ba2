"""The port stands alone: no module of geoldm_tpu_torch (ops, parallel, cli
and the rest; and not chip_smoke.py) imports jax or the JAX package, and
asking for the card on a host without one raises instead of running on the
CPU, sequence-parallel ranks included."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import geoldm_tpu_torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import geoldm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(geoldm_tpu_torch.__path__, "geoldm_tpu_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, sys.argv[1])
import chip_smoke  # noqa: F401
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib")) or
             (m.startswith("geoldm_tpu") and not m.startswith("geoldm_tpu_torch")))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 20 else 0)
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _PROBE, REPO], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_every_module_is_a_port_module():
    names = [m.name for m in pkgutil.walk_packages(geoldm_tpu_torch.__path__,
                                                   "geoldm_tpu_torch.")]
    for name in ("ops.egnn_block", "ops.egnn_tiled", "ops.egnn_sp", "ops.cuda_build",
                 "parallel.sp", "cli.serve", "cli.main_qm9", "cli.main_geom_drugs",
                 "train.train_step", "train.trainer", "data.qm9", "data.geom",
                 "utils.checkpoint", "train.augment", "train.prefetch",
                 "utils.logging_utils", "evalsuite.smiles", "evalsuite.rdkit_metrics",
                 "evalsuite.native", "evalsuite.analyze", "cli.eval_analyze", "cli.check_data",
                 "nn.core", "cli.eval_sample", "train.conditioning", "models.classifier",
                 "train.classifier_train", "cli.main_qm9_prop", "cli.eval_conditional_qm9",
                 "nn.egnn_legacy", "diffusion.priors", "evalsuite.visualizer", "data.md17",
                 "data.native_geom", "cli.build_geom_dataset", "utils.flops", "cli.bench_train",
                 "parallel.sharding"):
        assert f"geoldm_tpu_torch.{name}" in names


def test_cuda_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    from geoldm_tpu_torch.cli import serve
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.models import factory
    from geoldm_tpu_torch.utils.convert import save_reference_checkpoint

    cfg = factory.make_latent_diffusion_config(get_dataset_info("qm9"), nf=16, n_layers=1,
                                               diffusion_steps=4)
    with pytest.raises(RuntimeError, match="cuda"):
        factory.build_model(cfg)  # default device is the card
    save_reference_checkpoint(factory.build_model(cfg, "cpu"), str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        serve.SamplerService(serve.parse_args(["--model_path", str(tmp_path)]))
    from geoldm_tpu_torch.cli import eval_sample

    with pytest.raises(RuntimeError, match="cuda"):
        eval_sample.main(["--model_path", str(tmp_path), "--outdir", str(tmp_path / "out")])
    from geoldm_tpu_torch.cli import main_geom_drugs
    from geoldm_tpu_torch.data.synthetic import write_geom_conformers

    write_geom_conformers(str(tmp_path / "geom"), get_dataset_info("geom"), 20)
    with pytest.raises(RuntimeError, match="cuda"):
        main_geom_drugs.main(["--datadir", str(tmp_path / "geom"), "--outdir", str(tmp_path)])


def test_sp_refuses_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    from geoldm_tpu_torch.cli import main_geom_drugs
    from geoldm_tpu_torch.parallel import sharding

    with pytest.raises(RuntimeError, match="cuda"):
        sharding.placement(2)  # the card is the default
    with pytest.raises(RuntimeError, match="cuda"):
        main_geom_drugs.main(["--sp", "2", "--datadir", "unused"])


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
