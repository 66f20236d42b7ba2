"""What every run shares: the files that name a cell, the check that no JAX
module is loaded, the device record and the result line.

Layout (all found by name, so a cell, a configuration or a metric is added
as files): ``BENCHMARK.json`` at the checkout's root lists the cells and
metrics; ``benchmark/workloads/<cell>.json`` holds a cell's configuration
name, traffic parameters, chips, driver and correctness limits;
``benchmark/configs/<config>.json`` the model; ``benchmark/drivers/<driver>.py``
a traffic driver; ``benchmark/metrics/<metric>.py`` a per-layer reader.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import statistics
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

# Top-level module names a run may not load (the JAX package and JAX itself).
FORBIDDEN = ("jax", "jaxlib", "flax", "geoldm_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is forbidden: ``geoldm_tpu_torch`` passes, ``geoldm_tpu`` fails."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def process_start_wall() -> float:
    """The wall-clock time this process started (Linux /proc), so set-up
    counts the interpreter's own start."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def workload(name: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "workloads", f"{name}.json"))


def config(name: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "configs", f"{name}.json"))


def driver(kind: str):
    """The traffic driver module ``drivers.<kind>``."""
    return importlib.import_module(f"drivers.{kind}")


def metric_reader(name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``'s
    ``read(ctx)``, which returns a number or None (nothing to read)."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(spec: dict, cell: str) -> Dict[str, List[dict]]:
    """The end-to-end and per-layer metrics ``BENCHMARK.json`` has cell
    ``cell`` report: one with a ``workloads`` list reports in those cells, one
    without in every cell (a per-layer one without the list in every cell
    that reports the end-to-end metric it moves)."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return {"end_to_end": e2e, "per_layer": layer}


@dataclass
class Check:
    """One compared number: its value and its limit (a value above the
    limit, or one that is not finite, fails)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and abs(self.value) != float("inf") \
            and self.value <= self.limit


@dataclass
class Outcome:
    """What a driver returns: end-to-end values (unit from BENCHMARK.json),
    the context per-layer readers read, the checks, the device record and
    the trace's summary."""

    e2e: Dict[str, float] = field(default_factory=dict)
    ctx: dict = field(default_factory=dict)
    checks: List[Check] = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    device: dict = field(default_factory=dict)
    breakdown: Optional[dict] = None
    numbers: Dict[str, float] = field(default_factory=dict)  # every number the check read
    detail: Optional[dict] = None  # the check's terms, for the readings


def device_record(chips: int, peak_bytes: int, device_name: str) -> dict:
    return {"platform": "gpu", "kind": device_name, "count": chips,
            "memory_peak_bytes": int(peak_bytes)}


def result_line(out: Outcome, metrics: Dict[str, List[dict]], trace: bool) -> dict:
    """The result object: ``metrics`` holds the end-to-end metrics without a
    trace, the per-layer ones with it (a reader that finds nothing leaves
    its metric out); ``checks`` comes last."""
    vals = {}
    if trace:
        for m in metrics["per_layer"]:
            v = metric_reader(m["name"])(out.ctx)
            if v is not None:
                vals[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in metrics["end_to_end"]:
            if m["name"] in out.e2e:
                vals[m["name"]] = {"value": float(out.e2e[m["name"]]), "unit": m["unit"]}
    line = {"correct": bool(out.checks) and all(c.ok for c in out.checks),
            "attempted": int(out.attempted), "failed": int(out.failed), "metrics": vals,
            "device": out.device}
    if trace and out.breakdown is not None:
        line["breakdown"] = out.breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    return line


def print_checks(checks: List[Check]) -> None:
    """Each compared number beside its limit, as the last lines of stderr."""
    for c in checks:
        verdict = "ok" if c.ok else "FAIL"
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) {verdict}", file=sys.stderr)
    sys.stderr.flush()


def quartile_spread(values) -> float:
    """(Q3 - Q1) / median by ``statistics.quantiles(values, n=4)``."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
