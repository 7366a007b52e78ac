"""Background prefetching over a batch iterator: the counterpart of
phc_gnn_tpu/data/prefetch.py:23-72.

A daemon thread pulls from the loader (host packing and plans) into a
bounded queue ahead of the training loop.  With a CUDA ``device`` the
thread also moves each batch to the card: it pins the batch's tensors and
copies them with ``non_blocking=True`` on a side stream of its own, then
records an event.  The consumer makes its current stream wait on that
event before it touches the batch (so the graphed steps' copies into their
static buffers never read a batch still in flight), and calls
``record_stream`` on each tensor (so the caching allocator does not hand
the memory out again while the consumer's stream may still read it).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Iterable, Iterator, Optional, Union

import torch

from phc_gnn_torch.graph.batch import GraphsTuple

__all__ = ["PrefetchIterator", "prefetch"]

_SENTINEL = object()


def _pinned(batch: GraphsTuple) -> GraphsTuple:
    """``batch`` with each tensor in pinned host memory."""
    return dataclasses.replace(batch, **{
        name: t.pin_memory() for name, t in batch.tensors()})


class PrefetchIterator:
    """Iterate ``source`` with ``depth`` items prefetched on a daemon
    thread; with a ``device`` the items are ``GraphsTuple`` batches, moved
    there (see the module's text for the CUDA route).  ``move_s`` counts the thread's seconds moving
    items to the device, ``wait_s`` the consumer's seconds blocked waiting
    for an item.

    Single-pass: wrap a fresh iterable per epoch.  Exceptions from the
    source are raised at the consuming call site; an exhausted iterator
    raises StopIteration on further next() calls."""

    def __init__(self, source: Iterable, depth: int = 2,
                 device: Optional[Union[str, torch.device]] = None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._device = None if device is None else torch.device(device)
        self._cuda = self._device is not None and self._device.type == "cuda"
        if self._cuda and self._device.index is None:
            self._device = torch.device("cuda", torch.cuda.current_device())
        self._stream = torch.cuda.Stream(self._device) if self._cuda else None
        self._err: Optional[BaseException] = None
        self._done = False  # sentinel consumed; further next() raises cleanly
        self.move_s = 0.0   # the thread's seconds pinning and enqueueing copies
        self.wait_s = 0.0   # the consumer's seconds blocked on the queue
        self._thread = threading.Thread(target=self._fill, args=(source,),
                                        daemon=True)
        self._thread.start()

    def _fill(self, source):
        try:
            for item in source:
                event = None
                t0 = time.perf_counter()
                if self._cuda:
                    with torch.cuda.stream(self._stream):
                        item = _pinned(item).to(self._device,
                                                non_blocking=True)
                        event = torch.cuda.Event()
                        event.record(self._stream)
                elif self._device is not None:
                    item = item.to(self._device)
                self.move_s += time.perf_counter() - t0
                self._q.put((item, event))
        except BaseException as e:  # noqa: BLE001 - raised at the consumer
            self._err = e
        finally:
            self._q.put(_SENTINEL)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._done:
            # single-pass iterator: re-iteration must not deadlock on the
            # empty queue
            raise StopIteration
        t0 = time.perf_counter()
        got = self._q.get()
        self.wait_s += time.perf_counter() - t0
        if got is _SENTINEL:
            self._done = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        item, event = got
        if event is not None:
            current = torch.cuda.current_stream(self._device)
            current.wait_event(event)
            for _, t in item.tensors():
                t.record_stream(current)
        return item


def prefetch(source: Iterable, depth: int = 2,
             device: Optional[Union[str, torch.device]] = None
             ) -> PrefetchIterator:
    """Wrap any batch iterable with background prefetching."""
    return PrefetchIterator(source, depth=depth, device=device)
