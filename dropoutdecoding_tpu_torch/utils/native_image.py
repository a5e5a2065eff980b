"""Threaded image prefetch (port of ``PrefetchLoader`` in
``dropoutdecoding_tpu/utils/native_image.py``; the ctypes JPEG pipeline
beside it in the JAX package is not carried over).

``PrefetchLoader`` overlaps host-side image decoding with device compute:
PIL's decoders release the interpreter lock, so worker threads decode the
next images while the caller's thread drives the card.
"""
from __future__ import annotations

import threading


class PrefetchLoader:
    """Yields ``(path, preprocess_fn(path))`` in the order of ``paths``,
    with ``workers`` threads running at most ``depth`` images ahead of the
    consumer.  An exception raised by ``preprocess_fn`` is raised again
    where its image would have been yielded."""

    def __init__(self, paths, preprocess_fn, depth: int = 4, workers: int = 2):
        self.paths = list(paths)
        self.fn = preprocess_fn
        self.depth = max(depth, 1)
        self._idx = 0  # next index a worker takes
        self._next_emit = 0  # next index the consumer yields
        self._results = {}
        self._cv = threading.Condition()
        self.workers = [threading.Thread(target=self._work, daemon=True) for _ in range(workers)]
        for t in self.workers:
            t.start()

    def _work(self):
        while True:
            with self._cv:
                while self._idx < len(self.paths) and self._idx >= self._next_emit + self.depth:
                    self._cv.wait()
                if self._idx >= len(self.paths):
                    return
                i = self._idx
                self._idx += 1
            try:
                res = self.fn(self.paths[i])
            except Exception as e:  # handed to the consumer, raised there
                res = e
            with self._cv:
                self._results[i] = res
                self._cv.notify_all()

    def __iter__(self):
        for i in range(len(self.paths)):
            with self._cv:
                while i not in self._results:
                    self._cv.wait()
                res = self._results.pop(i)
                self._next_emit = i + 1
                self._cv.notify_all()
            if isinstance(res, Exception):
                raise res
            yield self.paths[i], res
