"""Background host-prep pipeline for the training and evaluation loops
(copy of ``geoldm_tpu/train/prefetch.py``).

The per-batch host work (numpy augmentation, log p(N), the copy to the card)
runs serially with the device step in a naive loop: the card idles while the
host prepares batch k+1. ``prefetch_map`` moves that host work onto one
background thread with a small bounded queue, so batch k+1 is prepared (and
its copy issued) while the card runs step k. It keeps to a single worker so
that the numpy RNG stream and the batch order are the serial loop's, byte
for byte.

The reference has no input pipeline (a torch DataLoader with num_workers=0
in its recipes, host-synchronous step loop: train_test.py:15-94).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
U = TypeVar("U")

_SENTINEL = object()


def prefetch_map(fn: Callable[[T], U], iterable: Iterable[T],
                 depth: int = 2) -> Iterator[U]:
    """Yield ``fn(item)`` for each item, computing up to ``depth`` results
    ahead on a single background thread.

    Exceptions raised by ``fn`` (or the iterable) are re-raised at the
    consuming ``next()`` call, preserving the serial loop's error
    behavior. With ``depth <= 0`` this degrades to a plain map (no
    thread)."""
    if depth <= 0:
        for item in iterable:
            yield fn(item)
        return

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _worker():
        try:
            for item in iterable:
                if stop.is_set():
                    return
                q.put(fn(item))
            q.put(_SENTINEL)
        except BaseException as e:  # noqa: BLE001 — re-raised at consumer
            q.put(e)

    thread = threading.Thread(target=_worker, daemon=True,
                              name="geoldm-torch-prefetch")
    thread.start()
    try:
        while True:
            out = q.get()
            if out is _SENTINEL:
                return
            if isinstance(out, BaseException):
                raise out
            yield out
    finally:
        # Consumer stopped early (break / exception): unblock the worker
        # and WAIT until it is actually dead — callers share a numpy
        # Generator with fn, so returning while the worker is mid-fn would
        # race on rng state. The worker can only be blocked in q.put
        # (freed by draining) or inside fn (bounded by one batch), so the
        # drain+join loop terminates.
        stop.set()
        while thread.is_alive():
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=0.5)
