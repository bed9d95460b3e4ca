"""Readahead pipelining: overlap host decode + H2D transfer with compute.

Reference: the pull-based AsyncGenerator combinators — readahead
(util/async_generator.h:898), background generator, transferred generator —
that let the reference's scanners overlap IO with CPU work
(dataset/scanner.cc:426-650). The device analogue is simpler: a bounded-queue
background thread produces device-resident batches while the main thread's
device computations run; JAX dispatch is async, so consume/produce overlap
naturally once batches are on device.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

from ..table import RecordBatch

__all__ = ["ReadaheadIterator", "MergedIterator", "prefetch_batches"]

_SENTINEL = object()


class ReadaheadIterator:
    """Wrap a batch iterator with an N-deep background prefetch queue
    (reference: MakeReadaheadGenerator async_generator.h:898)."""

    def __init__(self, source: Iterator[RecordBatch], readahead: int = 2,
                 transfer: Optional[Callable] = None):
        self._source = source
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(readahead, 1))
        self._transfer = transfer
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for item in self._source:
                if self._transfer is not None:
                    item = self._transfer(item)
                self._queue.put(item)
        except BaseException as e:  # propagate to consumer
            self._error = e
        finally:
            self._queue.put(_SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is _SENTINEL:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item


class MergedIterator:
    """Merge N source iterators with bounded concurrency — the reference's
    MakeMergedGenerator (util/async_generator.h:1098): at most
    `readahead` sources are live at once, each streaming through its own
    bounded queue (so a fragment's batches flow as they decode instead
    of materializing per fragment).

    ordered=True delivers source 0's items, then source 1's, ... (the
    sequenced merge the sync scanner uses); ordered=False delivers
    whichever source produces first (max throughput, the async
    scanner's default)."""

    def __init__(self, factories, readahead: int = 4, ordered: bool = True,
                 depth: int = 2, transfer: Optional[Callable] = None):
        self._factories = list(factories)
        self._ra = max(1, readahead)
        self._ordered = ordered
        self._depth = max(1, depth)
        self._transfer = transfer
        self._errors: dict = {}
        if ordered:
            self._queues = {}
            self._next_to_start = 0
            for _ in range(min(self._ra, len(self._factories))):
                self._start_next()
        else:
            self._shared: "queue.Queue" = queue.Queue(
                maxsize=self._ra * self._depth)
            self._started = 0
            self._finished = 0
            self._lock = threading.Lock()
            for _ in range(min(self._ra, len(self._factories))):
                self._start_next_unordered()

    # ---- ordered mode ----
    def _start_next(self):
        i = self._next_to_start
        if i >= len(self._factories):
            return
        self._next_to_start += 1
        q: "queue.Queue" = queue.Queue(maxsize=self._depth)
        self._queues[i] = q

        def work(i=i, q=q):
            try:
                for item in self._factories[i]():
                    if self._transfer is not None:
                        item = self._transfer(item)
                    q.put(item)
            except BaseException as e:
                self._errors[i] = e
            finally:
                q.put(_SENTINEL)

        threading.Thread(target=work, daemon=True).start()

    # ---- unordered mode ----
    def _start_next_unordered(self):
        with self._lock:
            i = self._started
            if i >= len(self._factories):
                return
            self._started += 1

        def work(i=i):
            try:
                for item in self._factories[i]():
                    if self._transfer is not None:
                        item = self._transfer(item)
                    self._shared.put(item)
            except BaseException as e:
                self._errors[i] = e
            finally:
                self._shared.put(_SENTINEL)

        threading.Thread(target=work, daemon=True).start()

    def __iter__(self):
        if not self._factories:
            return
        if self._ordered:
            for i in range(len(self._factories)):
                q = self._queues[i]
                while True:
                    item = q.get()
                    if item is _SENTINEL:
                        break
                    yield item
                del self._queues[i]
                if i in self._errors:
                    raise self._errors[i]
                self._start_next()
        else:
            done = 0
            while done < len(self._factories):
                item = self._shared.get()
                if item is _SENTINEL:
                    done += 1
                    self._start_next_unordered()
                    continue
                yield item
            for e in self._errors.values():
                raise e


def prefetch_batches(source, readahead: int = 2, device=None):
    """Readahead + optional explicit device placement of each batch."""
    transfer = None
    if device is not None:
        import jax

        def transfer(batch):
            return jax.device_put(batch, device)

    return ReadaheadIterator(iter(source), readahead, transfer)
