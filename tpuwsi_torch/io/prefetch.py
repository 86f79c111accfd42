"""Background-thread batch prefetcher (``tpuwsi/io/wsi.py:271 Prefetcher``).

Producer exceptions are captured and re-raised in the consumer (a swallowed
read error would silently truncate the epoch), and ``close()`` unblocks and
retires the producer when the consumer stops early
(``--max-steps-per-epoch``), so long runs do not gather threads parked on a
full queue. ``wait_s`` counts the seconds the consumer spent blocked on the
queue: the share of a loop's time that the data did not keep up.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional


class Prefetcher:
    def __init__(self, iterator, depth: int = 3):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._iterator = iterator
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._finished = False
        self.wait_s = 0.0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """put that notices a stop; False = the consumer closed us."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            for item in self._iterator:
                if not self._put(item):
                    return
        except BaseException as e:  # re-raised on the consumer's side
            self._err = e
        finally:
            self._put(self._done)

    def close(self):
        """Stop the producer and drain the queue (idempotent)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)

    def __iter__(self):
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        t0 = time.perf_counter()
        item = self._q.get()
        self.wait_s += time.perf_counter() - t0
        if item is self._done:
            self._finished = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
