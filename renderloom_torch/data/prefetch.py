"""Background-thread batch prefetching.

A copy of the JAX package's ``renderloom/data/prefetch.py``: a bounded
daemon producer thread runs the host side of the input pipeline (h5
reads and image decode, which the native decoder runs without the
interpreter lock) ahead of the train loop.  Only host work runs on the
thread; the copy to the device stays in the train loop.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


class Prefetcher(Iterator[T]):
    """Iterate ``source`` on a daemon thread, ``depth`` items ahead.

    Exceptions in the producer re-raise at the consuming ``next()``;
    ``close()`` (or garbage collection of the iterator) stops the
    producer promptly even if the consumer abandons the loop early.
    """

    def __init__(self, source: Iterable[T], depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._produce, args=(iter(source),), daemon=True)
        self._thread.start()

    def _produce(self, it):
        try:
            for item in it:
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            self._q.put(_SENTINEL)
        except BaseException as e:  # noqa: BLE001 — re-raised at next()
            self._q.put(e)

    def __iter__(self):
        return self

    def __next__(self) -> T:
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is _SENTINEL:
            self._stop.set()
            raise StopIteration
        if isinstance(item, BaseException):
            self._stop.set()
            raise item
        return item

    def close(self):
        self._stop.set()
        # drain so a blocked producer can observe the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __del__(self):
        self.close()


def prefetch(source: Iterable[T], depth: int = 2) -> Prefetcher:
    """Wrap an iterable of batches with background prefetching."""
    return Prefetcher(source, depth)
