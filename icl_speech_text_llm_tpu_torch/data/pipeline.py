"""Host-side prefetch pipeline.

A copy of ``PrefetchIterator`` from ``icl_speech_text_llm_tpu/data/pipeline.py``
(that module is free of jax, but importing it runs the JAX package's
``data/__init__``, which pulls jax in): a background thread builds
PackedBatches ahead of the device step, so collation and tokenization
overlap the device's work.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

_SENTINEL = object()


class PrefetchIterator:
    """Wrap a batch iterator with an N-deep background prefetch queue."""

    def __init__(self, make_iterator: Callable[[], Iterator], depth: int = 2):
        self._make_iterator = make_iterator
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for item in self._make_iterator():
                self._queue.put(item)
        except BaseException as e:  # surfaced on the consumer side
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
