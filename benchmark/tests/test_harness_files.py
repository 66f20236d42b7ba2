"""A cell, a configuration or a per-layer metric is added as new files and
``BENCHMARK.json`` entries only: the harness finds each by its name."""

import copy
import json
import os
import shutil

import pytest
import tiny

import run
from harness import core


@pytest.fixture
def bench_copy(tmp_path, monkeypatch):
    """The benchmark's data files copied to a new folder, the harness
    pointed at it."""
    for sub in ("workloads", "configs", "metrics"):
        shutil.copytree(os.path.join(core.BENCH_DIR, sub), tmp_path / sub)
    monkeypatch.setattr(core, "BENCH_DIR", str(tmp_path))
    return tmp_path


def _add(bench_copy):
    cfg = core.config("qm9_ldm")
    cfg["name"] = "qm9_ldm_small_lr"
    cfg["lr"] = 5e-5
    (bench_copy / "configs" / "qm9_ldm_small_lr.json").write_text(json.dumps(cfg))
    wl = core.workload("qm9_train")
    wl["config"] = "qm9_ldm_small_lr"
    wl["batch_size"] = 32
    (bench_copy / "workloads" / "qm9_train_b32.json").write_text(json.dumps(wl))
    (bench_copy / "metrics" / "steps_traced.train.py").write_text(
        '"""Steps in the traced stretch."""\n\n\ndef read(ctx):\n'
        '    return ctx.get("steps") if ctx.get("kind") == "train" else None\n')
    spec = copy.deepcopy(core.benchmark_spec())
    spec["configs"].append({"name": "qm9_ldm_small_lr", "source": "s",
                            "file": "benchmark/configs/qm9_ldm_small_lr.json", "reduced": [],
                            "why": "w"})
    spec["workloads"].append({"name": "qm9_train_b32", "config": "qm9_ldm_small_lr",
                              "traffic": "qm9_train_b32", "chips": 1, "why": "w"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_mol_per_s":
            m["workloads"].append("qm9_train_b32")
    spec["per_layer"].append({"name": "steps_traced.train", "unit": "steps", "better": "higher",
                              "source": "program_span", "layer": "Train step and optimizer",
                              "moves": "train_mol_per_s", "workloads": ["qm9_train_b32"]})
    return spec


def test_new_files_are_found_by_name(bench_copy):
    spec = _add(bench_copy)
    assert core.workload("qm9_train_b32")["batch_size"] == 32
    assert core.config("qm9_ldm_small_lr")["lr"] == 5e-5
    assert core.metric_reader("steps_traced.train")({"kind": "train", "steps": 7}) == 7
    m = core.cell_metrics(spec, "qm9_train_b32")
    assert {x["name"] for x in m["end_to_end"]} == {"train_mol_per_s", "peak_mem_gib",
                                                    "setup_s"}
    assert [x["name"] for x in m["per_layer"]] == ["steps_traced.train"]
    assert "steps_traced.train" not in {x["name"] for x in core.cell_metrics(spec, "qm9_train")[
        "per_layer"]}


def test_a_cell_added_as_files_runs(bench_copy, monkeypatch):
    spec = _add(bench_copy)
    monkeypatch.setattr(core, "benchmark_spec", lambda root=None: spec)
    s = tiny.spec("qm9_train_b32", seconds=1.0)
    assert s.config["lr"] == 5e-5
    line = run.execute(s, core.cell_metrics(spec, "qm9_train_b32"))
    assert line["correct"] is True
    assert set(line["metrics"]) == {"train_mol_per_s", "peak_mem_gib", "setup_s"}
