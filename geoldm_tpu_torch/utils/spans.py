"""The program's own spans and counters, recorded only while a
``torch.profiler`` records (the benchmark's traced stretch, ``--trace DIR``).

``span(name, id)`` is a context manager around one piece of work; ``count(name,
n)`` adds ``n`` to a counter. With no profiler running, ``span`` hands back one
shared null context and ``count`` returns at once: the check is a read of the
profiler's own flag. With one running, each span

- opens ``torch.profiler.record_function("geoldm.<name>")``, so it sits in the
  profiler's timeline beside the device's kernels (and in a Chrome trace), and
- is kept in memory as ``(name, id, parent, start_ns, end_ns)`` on
  ``time.perf_counter_ns``'s clock; ``parent`` is the name of the span it
  opened inside (on its own thread), or None. Spans of one step or one call
  share an ``id``.

``records()``, ``counters()`` and ``clear()`` read and reset them. At most
``CAP`` spans are kept; ``dropped()`` counts those past it.

Spans go where the work is issued, on the thread that issues it: the training
loop, the train step and the sampler. The prefetch worker gets none (the
profiler does not record it); the loop's wait for its batch is a span.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Hashable, List, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

CAP = 1_000_000
PREFIX = "geoldm."

Record = Tuple[str, Optional[Hashable], Optional[str], int, int]

_lock = threading.Lock()
_local = threading.local()
_records: List[Record] = []
_counters: Dict[str, int] = {}
_dropped = 0


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL = _Null()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "id", "parent", "start", "fn")

    def __init__(self, name: str, id: Optional[Hashable]):
        self.name, self.id = name, id

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.fn = torch.profiler.record_function(PREFIX + self.name)
        self.fn.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.fn.__exit__(*exc)
        _stack().pop()
        global _dropped
        with _lock:
            if len(_records) < CAP:
                _records.append((self.name, self.id, self.parent, self.start, end))
            else:
                _dropped += 1
        return False


def span(name: str, id: Optional[Hashable] = None):
    """A context manager timing the work inside it (module docstring)."""
    if not _profiler._is_profiler_enabled:
        return NULL
    return _Span(name, id)


def count(name: str, n) -> None:
    """Add ``n`` to counter ``name`` while a profiler records."""
    if not _profiler._is_profiler_enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def records() -> List[Record]:
    """The spans kept so far, in the order they ended."""
    with _lock:
        return list(_records)


def counters() -> Dict[str, int]:
    with _lock:
        return dict(_counters)


def dropped() -> int:
    """Spans not kept because ``CAP`` were held."""
    return _dropped


def clear() -> None:
    """Forget every span and counter."""
    global _dropped
    with _lock:
        _records.clear()
        _counters.clear()
        _dropped = 0
