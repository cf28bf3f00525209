"""Functional reader decorators.

≙ paddle_tpu/data/decorator.py (a copy: the module is pure Python;
reference python/paddle/reader/decorator.py:33-240 (map_readers, shuffle,
chain, compose, buffered, firstn, xmap_readers). A reader is a zero-arg
callable returning an iterable over samples — identical contract to the
reference so user pipelines port unchanged.
"""

from __future__ import annotations

import itertools
import queue
import random
import threading
from typing import Callable, Iterable, List

from ..core.enforce import InvalidArgumentError, enforce


def map_readers(func, *readers):
    """Apply func elementwise over parallel readers (≙ decorator.py:33)."""

    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)

    return reader


def shuffle(reader, buf_size):
    """Shuffle within a sliding buffer (≙ decorator.py shuffle)."""

    def shuffled():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            random.shuffle(buf)
            yield from buf

    return shuffled


def chain(*readers):
    """Concatenate readers (≙ decorator.py chain)."""

    def chained():
        for r in readers:
            yield from r()

    return chained


def compose(*readers, check_alignment=True):
    """Zip readers into tuple samples (≙ decorator.py compose)."""

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def composed():
        rs = [r() for r in readers]
        if check_alignment:
            for items in itertools.zip_longest(*rs):
                enforce(all(i is not None for i in items),
                        "readers have different lengths",
                        exc=InvalidArgumentError)
                yield sum((make_tuple(i) for i in items), ())
        else:
            for items in zip(*rs):
                yield sum((make_tuple(i) for i in items), ())

    return composed


def buffered(reader, size):
    """Prefetch into a bounded queue on a worker thread (≙ decorator.py
    buffered) — hides host-side read latency from the training loop."""

    end = object()

    def buffered_reader():
        q: queue.Queue = queue.Queue(maxsize=size)

        def fill():
            try:
                for d in reader():
                    q.put(d)
            finally:
                q.put(end)

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        while True:
            e = q.get()
            if e is end:
                break
            yield e

    return buffered_reader


def firstn(reader, n):
    def firstn_reader():
        for i, item in enumerate(reader()):
            if i >= n:
                break
            yield item

    return firstn_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map with worker threads (≙ decorator.py xmap_readers)."""

    end = object()

    def xreader():
        in_q: queue.Queue = queue.Queue(buffer_size)
        out_q: queue.Queue = queue.Queue(buffer_size)

        def read_worker():
            for i, sample in enumerate(reader()):
                in_q.put((i, sample))
            for _ in range(process_num):
                in_q.put(end)

        def map_worker():
            while True:
                item = in_q.get()
                if item is end:
                    out_q.put(end)
                    return
                i, sample = item
                out_q.put((i, mapper(sample)))

        threading.Thread(target=read_worker, daemon=True).start()
        workers = [threading.Thread(target=map_worker, daemon=True)
                   for _ in range(process_num)]
        for w in workers:
            w.start()
        finished = 0
        pending = {}
        next_idx = 0
        while finished < process_num:
            item = out_q.get()
            if item is end:
                finished += 1
                continue
            if order:
                i, mapped = item
                pending[i] = mapped
                while next_idx in pending:
                    yield pending.pop(next_idx)
                    next_idx += 1
            else:
                yield item[1]
        if order:
            for i in sorted(pending):
                yield pending[i]

    return xreader


def batch(reader, batch_size, drop_last=True):
    """Group samples into lists (≙ python/paddle/v2-era batch.py /
    paddle.batch)."""

    def batch_reader():
        b = []
        for item in reader():
            b.append(item)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader
