"""Size-bucket covering logic (port of ``geoldm_tpu/utils/buckets.py``)."""

from __future__ import annotations

from typing import Iterable, Tuple


def covering_buckets(buckets: Iterable[int], max_n: int) -> Tuple[int, ...]:
    """Keep the configured buckets below ``max_n`` and append one top bucket:
    the smallest configured bucket covering ``max_n``, else ``max_n`` rounded
    up to a multiple of 8."""
    bs = sorted({int(b) for b in buckets})
    max_n = int(max_n)
    top = min((b for b in bs if b >= max_n), default=-(-max_n // 8) * 8)
    return tuple(b for b in bs if b < max_n) + (top,)
