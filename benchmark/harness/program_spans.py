"""The program's own spans and counters (``geoldm_tpu_torch.utils.spans``),
as the readers of the ``program_span`` and ``program_counter`` metrics take
them.

The program records them only while a torch profiler records, and a run's
only profiler is its traced stretch, so they cover exactly the stretch that
``ctx["trace"]`` describes (of every seed a process ran: each metric is a
mean over spans or a ratio of counters). A program without the module, or
a run without its spans, reads None.
"""

from __future__ import annotations

from typing import Optional


def program(ctx: dict, kind: str):
    """(span records, counters) for a traced run of ``kind``, else None."""
    if ctx.get("kind") != kind or not ctx.get("trace"):
        return None
    try:
        from geoldm_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans.records(), spans.counters()


def per_span_ms(ctx: dict, kind: str, over: str, *names: str) -> Optional[float]:
    """Milliseconds of the spans in ``names`` per span named ``over``."""
    got = program(ctx, kind)
    if got is None:
        return None
    n = sum(1 for r in got[0] if r[0] == over)
    ns = sum(r[4] - r[3] for r in got[0] if r[0] in names)
    return ns / 1e6 / n if n else None


def pad_waste(ctx: dict, kind: str, prefix: str) -> Optional[float]:
    """100 x (1 - ``<prefix>.pairs`` / ``<prefix>.pair_slots``)."""
    got = program(ctx, kind)
    if got is None:
        return None
    slots = got[1].get(prefix + ".pair_slots", 0)
    return 100.0 * (1.0 - got[1].get(prefix + ".pairs", 0) / slots) if slots > 0 else None
