"""The result line's schema and the no-JAX check."""

import json
import sys
import types

import tiny  # noqa: F401

from harness import core
from harness.core import Check, Outcome


def _metrics():
    return core.cell_metrics(core.benchmark_spec(), "qm9_train")


def test_untraced_line_has_the_end_to_end_metrics_and_checks_last():
    out = Outcome(e2e={"train_mol_per_s": 1000.5, "setup_s": 20.0, "peak_mem_gib": 2.0},
                  checks=[Check("loss_gap", 1e-7, 1e-5)], attempted=300,
                  device=core.device_record(1, 2 << 30, "NVIDIA H100 80GB HBM3"))
    line = core.result_line(out, _metrics(), trace=False)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"train_mol_per_s", "setup_s", "peak_mem_gib"}
    assert line["metrics"]["train_mol_per_s"] == {"value": 1000.5, "unit": "mol/s"}
    assert line["device"] == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                              "memory_peak_bytes": 2 << 30}
    assert line["checks"] == {"loss_gap": {"value": 1e-7, "limit": 1e-5}}
    json.dumps(line)


def test_traced_line_has_per_layer_metrics_breakdown_and_leaves_out_silent_readers():
    trace = {"window_s": 4.0, "busy_s": 3.0, "kernel_count": 4000,
             "device_ops": [["k", 1.0]], "idle_gaps": [["aten::copy_", 0.5]]}
    ctx = {"kind": "train", "trace": trace, "steps": 10, "chips": 1, "useful_flops": 4.95e12,
           "untraced_s": 4.0, "peak_flops": 495e12, "least_s": 0.3}
    out = Outcome(ctx=ctx, checks=[Check("loss_gap", 1.0, 1e-5)],
                  device=dict(core.device_record(1, 1, "x"), busy_s=3.0, window_s=4.0),
                  breakdown={"device_ops": trace["device_ops"], "idle_gaps": trace["idle_gaps"]})
    line = core.result_line(out, _metrics(), trace=True)
    assert line["correct"] is False
    assert list(line)[-1] == "checks" and "breakdown" in line
    m = line["metrics"]
    assert m["launches_per_step.train"]["value"] == 400.0
    assert m["idle_share.train"]["value"] == 25.0
    assert abs(m["mfu.train"]["value"] - 0.25) < 1e-12
    assert abs(m["roofline_share.train"]["value"] - 10.0) < 1e-12
    assert "train_mol_per_s" not in m
    out.ctx = dict(ctx, least_s=0.0)  # a reader that finds nothing is left out
    assert "roofline_share.train" not in core.result_line(out, _metrics(), trace=True)["metrics"]


def test_a_non_finite_number_fails_its_check():
    assert not Check("x", float("nan"), 1.0).ok
    assert not Check("x", float("inf"), 1.0).ok
    assert Check("x", 0.5, 1.0).ok and not Check("x", 1.5, 1.0).ok


def test_no_jax_compares_whole_top_level_names():
    names = ["geoldm_tpu", "geoldm_tpu.ops", "jaxlib.xla", "flax"]
    saved = {n: sys.modules.get(n) for n in names}
    try:
        assert core.forbidden_modules() == []
        sys.modules["geoldm_tpu_torch_extra"] = types.ModuleType("geoldm_tpu_torch_extra")
        sys.modules["jaxtyping"] = types.ModuleType("jaxtyping")
        assert core.forbidden_modules() == []
        for n in names:
            sys.modules[n] = types.ModuleType(n)
        assert core.forbidden_modules() == sorted(names)
    finally:
        for n in names + ["geoldm_tpu_torch_extra", "jaxtyping"]:
            if saved.get(n) is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = saved[n]


def test_the_program_loads_no_jax():
    import geoldm_tpu_torch.cli.serve  # noqa: F401
    import geoldm_tpu_torch.train.trainer  # noqa: F401

    assert core.forbidden_modules() == []
