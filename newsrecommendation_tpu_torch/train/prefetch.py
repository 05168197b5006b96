"""Background staging of host batches for the training loop.

The host side of a step (the numpy batch assembly in
``TrainSamples.iter_batches`` and the copy to the device) runs on one
worker thread with a bounded queue, so batch N+1 is built and copied
while the device runs step N. One worker, FIFO queue: the batch order, and
so the training trajectory, is exactly that of the plain iterator.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
U = TypeVar("U")

_DONE = object()


class _Raised:
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


def stage_ahead(items: Iterable[T], stage: Callable[[T], U],
                depth: int = 2) -> Iterator[U]:
    """Yield ``stage(item)`` for each item, staged up to `depth` ahead.

    `stage` runs on a single background thread (FIFO: output order is the
    input order). Exceptions from the iterator or from `stage` re-raise at
    the consumer's next pull. ``depth <= 0`` runs inline (no thread).
    Closing the generator early stops the worker promptly.
    """
    if depth <= 0:
        for item in items:
            yield stage(item)
        return

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(obj) -> None:
        # a bounded put that gives up once the consumer has left: a plain
        # blocking put would deadlock close() on a full queue, and a
        # one-shot timed put could drop an error or the end marker
        while not stop.is_set():
            try:
                q.put(obj, timeout=0.1)
                return
            except queue.Full:
                continue

    def worker():
        try:
            for item in items:
                if stop.is_set():
                    break
                put(stage(item))
        except BaseException as e:  # noqa: BLE001 - relayed to the consumer
            put(_Raised(e))
        finally:
            put(_DONE)

    t = threading.Thread(target=worker, name="newsrec-prefetch", daemon=True)
    t.start()
    try:
        while True:
            out = q.get()
            if out is _DONE:
                return
            if isinstance(out, _Raised):
                raise out.exc
            yield out
    finally:
        stop.set()
        # drain so a worker blocked on put() can observe stop and exit
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5.0)
