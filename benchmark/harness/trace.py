"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` over a
steady part of the window, reduced in memory to what the per-layer readers
and the result's ``breakdown`` need: the device's busy intervals, time by
device operation, and the idle gaps named by what the host was doing.

The harness marks its own spans with ``torch.profiler.record_function``
(``bench.<name>``); a gap is named by the innermost host event (such a span
or an operator) running at its middle.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Stretch:
    """Profile from ``start()`` to ``stop()``; the device is synchronised at
    both ends, so the stretch holds exactly the work issued inside it."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.prof = None
        self.t0 = self.t1 = 0.0
        self.summary: Optional[dict] = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self._sync()
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> dict:
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.summary = reduce(self.prof, self.t1 - self.t0, self.device)
        self.prof = None
        return self.summary


def reduce(prof, window_s: float, device) -> dict:
    """{window_s, busy_s, busy: union of device intervals (ns), device_ops:
    [(name, seconds)] by total time, kernel_count, idle_gaps: [(host event,
    seconds)]}."""
    events = prof.profiler.kineto_results.events()
    dev_iv, cpu = [], []
    by_name: Dict[str, int] = defaultdict(int)
    kernels = 0
    for ev in events:
        dt = ev.device_type()
        if dt == torch.autograd.DeviceType.CPU:
            if ev.duration_ns() > 0:
                cpu.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name()))
            continue
        if dt != torch.autograd.DeviceType.CUDA or ev.device_index() != _index(device) \
                or ev.is_user_annotation():  # a host span's shadow on the device: no work
            continue
        s, d = ev.start_ns(), ev.duration_ns()
        if d <= 0:
            continue
        name = ev.name()
        dev_iv.append((s, s + d))
        by_name[name] += d
        kernels += 1 if not name.startswith(("Memcpy", "Memset")) else 0
    busy = _union(dev_iv)
    busy_ns = sum(e - s for s, e in busy)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"window_s": window_s, "busy_s": busy_ns / 1e9, "kernel_count": kernels,
            "device_ops": [[n[:160], v / 1e9] for n, v in ops[:10]],
            "op_seconds": {n: v / 1e9 for n, v in by_name.items()},
            "idle_gaps": _gaps(busy, cpu)}


def _index(device) -> int:
    device = torch.device(device)
    if device.type != "cuda":
        return -1
    return device.index if device.index is not None else torch.cuda.current_device()


def _gaps(busy: List[Tuple[int, int]], cpu: List[tuple], top: int = 10,
          small_ns: int = 10_000) -> list:
    """Idle time between busy intervals, summed by the innermost host event
    at each gap's middle (gaps under ``small_ns`` summed apart) -> the
    ``top`` names by seconds."""
    if len(busy) < 2:
        return []
    cpu.sort()
    starts = [c[0] for c in cpu]
    spans = [c for c in cpu if c[2].startswith("bench.")]
    total: Dict[str, int] = defaultdict(int)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        gap = s1 - e0
        if gap <= 0:
            continue
        if gap < small_ns:
            total[f"(gaps under {small_ns // 1000} us)"] += gap
            continue
        mid = e0 + gap // 2
        i = bisect.bisect_right(starts, mid)
        best = None
        for j in range(i - 1, max(-1, i - 256), -1):  # recent starts: the innermost
            cs, ce, n = cpu[j]
            if ce >= mid and (best is None or ce - cs < best[1] - best[0]):
                best = (cs, ce, n)
        if best is None:  # fall back on the harness's own spans
            for cs, ce, n in spans:
                if cs <= mid <= ce and (best is None or ce - cs < best[1] - best[0]):
                    best = (cs, ce, n)
        total[best[2] if best else "(no host event)"] += gap
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    return [[n[:160], v / 1e9] for n, v in ranked]


def breakdown(summary: dict) -> dict:
    return {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
