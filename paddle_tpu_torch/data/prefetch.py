"""Asynchronous host → device prefetch.

≙ paddle_tpu/data/prefetch.py (reference double-buffered readers,
operators/reader/buffered_reader.h:27, and the py_reader blocking queue,
reader/lod_tensor_blocking_queue.h:31). Where the JAX package stages a
batch with jax.device_put, this one copies it through a pinned host buffer
on a side CUDA stream, so the copy of batch k+1 overlaps the step on
batch k.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..core.places import resolve_device
from .feeder import stage_batch


class DevicePrefetcher:
    """Wrap a feed-dict iterator; yields batches already on the device.

    `stage_threads` workers stage batches concurrently, up to `capacity`
    ahead, and the batches come out in the iterator's order (a bounded
    queue of futures). On a CUDA place a worker converts each entry to its
    wire dtype (`staging`: {var name: (wire dtype, scale)}, as
    data.feeder.staging_specs gives; uint8 images are a quarter of
    float32's bytes), copies it into a pinned host buffer, copies that to
    the card with non_blocking=True on a side stream, and records an event
    after the batch's copies. The consumer's stream waits on that event
    before it first reads the batch. `place` defaults to CUDAPlace(0); on
    the CPU a batch is only made tensors."""

    _END = object()

    def __init__(self, feed_iter_fn: Callable[[], Iterator[Dict]],
                 capacity: int = 2, place=None,
                 staging: Optional[Dict] = None, stage_threads: int = 2):
        self._fn = feed_iter_fn
        self._capacity = max(capacity, stage_threads)
        self._device = resolve_device(place)
        self._staging = staging or {}
        self._stage_threads = max(1, stage_threads)

    def _put(self, batch: Dict, stream):
        """(tensors of one staged batch, the event after its copies or
        None on the CPU). Runs on a worker thread."""
        batch = stage_batch(batch, self._staging)
        host = {}
        for k, v in batch.items():
            a = np.asarray(v)
            if a.dtype == np.float64:
                a = a.astype(np.float32)   # float feeds run in float32
            host[k] = torch.from_numpy(np.ascontiguousarray(a))
        if stream is None:
            return host, None
        out = {}
        with torch.cuda.stream(stream):
            for k, t in host.items():
                # the host allocator keeps the pinned buffer until the
                # copy enqueued on `stream` has read it
                out[k] = t.pin_memory().to(self._device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self._capacity)
        err = []
        stream = (torch.cuda.Stream(device=self._device)
                  if self._device.type == "cuda" else None)
        pool = ThreadPoolExecutor(max_workers=self._stage_threads)
        # set when the consumer abandons the iterator (break / exception
        # in the training loop): the producer must not stay blocked in
        # put() forever, pinning its thread, the pool and up to
        # `capacity` staged batches for the life of the process
        closed = threading.Event()

        def put_open(item) -> bool:
            while not closed.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in self._fn():
                    if not put_open(pool.submit(self._put, b, stream)):
                        return
            except Exception as e:  # propagate to the consumer
                err.append(e)
            finally:
                put_open(self._END)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._END:
                    if err:
                        raise err[0]
                    return
                batch, done = item.result()
                if done is not None:
                    consumer = torch.cuda.current_stream(self._device)
                    consumer.wait_event(done)
                    for v in batch.values():
                        # allocated on the side stream, read on this one
                        v.record_stream(consumer)
                yield batch
        finally:
            closed.set()
            try:  # drop queued futures so staged batches free promptly
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            pool.shutdown(wait=False)
