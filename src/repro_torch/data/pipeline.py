"""Seekable batch iterator with a host prefetch thread (port of
``repro.data.pipeline``).

Wraps a counter-based generator ``batch_fn(step) -> dict`` into an
iterator that resumes exactly at any step (``seek``), moves batches to a
device, and overlaps host-side generation with device compute via a
prefetch thread.  An exception in the worker is enqueued in stream order
and re-raised from ``__next__`` at the step where it occurred; the
pipeline then resets, so a retry or a ``seek`` restarts the worker.

With ``sharding`` (a dict of ``NamedSharding`` per batch field,
``distributed.sharding.train_batch_shardings``) each rank builds the
global batch of a step (``batch_fn`` is a function of the step) and
keeps its rows.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional


class _WorkerFailure:
    """An exception carried from the prefetch worker to the consumer."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class DataPipeline:
    def __init__(self, batch_fn: Callable[[int], dict], start_step: int = 0,
                 device=None, prefetch: int = 2, sharding=None):
        self._batch_fn = batch_fn
        self._sharding = sharding
        self._step = start_step
        self._device = device
        self._prefetch = max(prefetch, 0)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(self._prefetch, 1))
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    @property
    def step(self) -> int:
        return self._step

    def seek(self, step: int) -> None:
        """Exact resume: drop any prefetched batches and jump to ``step``."""
        self._halt_worker()
        self._step = step

    def _make(self, step: int):
        batch = self._batch_fn(step)
        if self._sharding is not None:
            from ..distributed.sharding import sharded_batch
            batch = sharded_batch(batch, self._sharding)
        if self._device is not None:
            batch = {k: v.to(self._device) for k, v in batch.items()}
        return batch

    def _worker(self, from_step: int):
        s = from_step
        while not self._stop.is_set():
            try:
                item = self._make(s)
            except BaseException as e:  # surfaced on the consumer thread
                item = _WorkerFailure(e)
            while not self._stop.is_set():
                try:
                    self._q.put((s, item), timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(item, _WorkerFailure):
                return              # the worker exits at the failing step
            s += 1

    def _halt_worker(self):
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
            self._thread = None
            self._stop.clear()
        while not self._q.empty():
            self._q.get_nowait()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._prefetch:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._worker, args=(self._step,), daemon=True)
                self._thread.start()
            s, batch = self._q.get()
            if isinstance(batch, _WorkerFailure):
                self._thread.join()
                self._thread = None
                while not self._q.empty():
                    self._q.get_nowait()
                raise batch.exc
            assert s == self._step, f"pipeline desync: {s} != {self._step}"
        else:
            batch = self._make(self._step)
        self._step += 1
        return batch

    def close(self):
        self._halt_worker()
