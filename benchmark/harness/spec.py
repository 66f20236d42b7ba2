"""One run's settings, handed to a driver."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class RunSpec:
    cell: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    start_wall: float = 0.0  # the process's start (set-up counts from it)
    fault: str = ""  # a planted fault (``harness.faults``): tests only
    limits: Dict[str, float] = field(default_factory=dict)
    extra: Optional[dict] = None

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])
