"""IO layers: data declaration, the batch-row mask and the reader pipeline.

≙ paddle_tpu/layers/io.py (reference python/paddle/fluid/layers/io.py):
`data`, `batch_row_mask`, and the readers — `PyReader` / `py_reader` (a
bounded queue filled by a producer thread), the reader-level `shuffle`,
`batch`, `double_buffer` and `Preprocessor`. Double buffering runs over
data.prefetch.DevicePrefetcher: each batch is copied through pinned host
memory on a side CUDA stream ahead of the step that reads it.
`open_recordio_file` and `open_files` read the RecordIO container
(data/recordio.py over csrc/recordio.cc).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dtypes import convert_dtype
from ..framework.program import BATCH_ROW_MASK_NAME, default_main_program


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True, staging_dtype=None, staging_scale=None):
    """Declare an input variable (≙ fluid.layers.data, reference
    layers/io.py:38). append_batch_size prepends -1.

    staging_dtype declares a byte-lean wire dtype: the host may feed this
    var as `staging_dtype` (uint8 images: a quarter of float32's bytes
    over PCIe) and the executor casts it to `dtype` and multiplies by
    `staging_scale` (default 1/255 for uint8) on the device. Feeding
    `dtype` itself stays valid."""
    full_shape = list(shape)
    if append_batch_size:
        full_shape = [-1] + full_shape
    block = default_main_program().current_block()
    if name in block.vars:
        return block.vars[name]
    var = block.create_var(name=name, shape=full_shape, dtype=dtype,
                           lod_level=lod_level, is_data=True,
                           stop_gradient=stop_gradient)
    if staging_dtype is not None:
        wire = convert_dtype(staging_dtype)
        if staging_scale is None and wire == torch.uint8:
            staging_scale = 1.0 / 255.0
        var.staging = (wire, staging_scale)
    if lod_level > 0:
        # companion sequence-length variable (static-shape LoD translation)
        block.create_var(name=name + "@SEQLEN", shape=[-1], dtype="int32",
                         is_data=True, stop_gradient=True)
    return var


def batch_row_mask():
    """Declare the per-row batch validity mask: [batch] float32, 1.0 for a
    real row. The Executor feeds all-ones when the caller does not (a
    multi-device executor that pads a partial batch zeroes its padded
    rows). Weight per-example losses with it —
    ``loss = reduce_sum(per_ex * mask) / reduce_sum(mask)`` — so padded
    rows contribute nothing to the gradient."""
    block = default_main_program().current_block()
    if BATCH_ROW_MASK_NAME in block.vars:
        return block.vars[BATCH_ROW_MASK_NAME]
    return block.create_var(name=BATCH_ROW_MASK_NAME, shape=[-1],
                            dtype="float32", is_data=True,
                            stop_gradient=True)


# ---------------------------------------------------------------------------
# Reader pipeline (≙ reference layers/io.py:345-968). Readers are Python
# iterators over feed dicts; py_reader is a bounded blocking queue between
# a producer thread and the train loop (≙ LoDTensorBlockingQueue); double
# buffering stages batches on the device ahead of compute
# (≙ buffered_reader.h:27).
# ---------------------------------------------------------------------------

class PyReader:
    """Queue-fed input (≙ layers/io.py py_reader:474).

    feed_list names the data vars each record provides. Call decorate_*
    and then start(); the train loop iterates feed dicts. With
    use_double_buffer the dicts come out as tensors already on `place`
    (CUDAPlace(0) by default), staged by a DevicePrefetcher."""

    def __init__(self, feed_list, capacity=64, name=None,
                 use_double_buffer=False, place=None):
        import queue as _q
        self.feed_names = [getattr(v, "name", v) for v in feed_list]
        self._capacity = capacity
        self._queue = _q.Queue(maxsize=capacity)
        self._END = object()
        self._thread = None
        self._gen = None
        self._err = []
        self._stop = None
        self.use_double_buffer = use_double_buffer
        self.place = place

    def decorate_sample_list_generator(self, generator):
        """generator() yields lists / tuples aligned with feed_list, or
        feed dicts."""
        self._gen = generator
        return self

    decorate_paddle_reader = decorate_sample_list_generator  # API parity

    def start(self):
        import queue as _q
        import threading

        # bound per epoch: a later reset() must neither receive this
        # producer's data nor its errors, and must be able to stop it
        q = self._queue
        err = self._err
        stop = threading.Event()
        self._stop = stop

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except _q.Full:
                    continue
            return False

        def produce():
            try:
                for sample in self._gen():
                    if not isinstance(sample, dict):
                        sample = dict(zip(self.feed_names, sample))
                    if not put(sample):
                        return
            except BaseException as e:  # surfaced in the consumer
                err.append(e)
            finally:
                # the end mark must arrive or the consumer hangs; only a
                # reset() (stop set) abandons it, and nobody reads that
                # queue any more
                put(self._END)
        self._thread = threading.Thread(target=produce, daemon=True)
        self._thread.start()
        return self

    def reset(self):
        """Abandon the current epoch: the producer exits at its next put,
        and a fresh queue and error list keep stale samples and errors out
        of the next start()."""
        import queue as _q
        if self._stop is not None:
            self._stop.set()
        self._queue = _q.Queue(maxsize=self._capacity)
        self._thread = None
        self._err = []

    def _raw_iter(self):
        q = self._queue
        while True:
            item = q.get()
            if item is self._END:
                if self._err:
                    raise self._err[0]
                return
            yield item

    def __iter__(self):
        if self.use_double_buffer:
            from ..data.prefetch import DevicePrefetcher
            yield from DevicePrefetcher(self._raw_iter, place=self.place)
        else:
            yield from self._raw_iter()


def py_reader(capacity, shapes, dtypes, names, use_double_buffer=True,
              place=None):
    """≙ reference layers/io.py py_reader:474: declares the data vars and
    returns a PyReader bound to them. `use_double_buffer` stages batches
    on `place` (CUDAPlace(0) by default) as double_buffer does."""
    feed_vars = [data(nm, shape=list(shape), dtype=dtype,
                      append_batch_size=False)
                 for nm, shape, dtype in zip(names, shapes, dtypes)]
    return PyReader(feed_vars, capacity=capacity,
                    use_double_buffer=use_double_buffer, place=place)


def open_recordio_file(filename, shapes, dtypes, names):
    """≙ layers/io.py open_recordio_file:345: a reader over the RecordIO
    container (data/recordio.py). Each record holds its fields' raw bytes
    back to back, in `names` order (as RecordIOWriter wrote them); each
    deserializes per `shapes` / `dtypes` into a feed dict of numpy arrays.
    A record whose bytes the shapes and dtypes do not consume exactly
    raises ValueError."""
    from ..data.recordio import RecordIOScanner

    def reader():
        with RecordIOScanner(filename) as sc:
            for rec in sc:
                out = {}
                off = 0
                for nm, shape, dtype in zip(names, shapes, dtypes):
                    arr = np.frombuffer(rec, dtype=dtype, offset=off,
                                        count=int(np.prod(shape)))
                    out[nm] = arr.reshape(shape).copy()
                    off += arr.nbytes
                if off != len(rec):
                    raise ValueError(
                        f"record in {filename!r} has {len(rec)} bytes but "
                        f"shapes/dtypes consume {off} — shape or dtype "
                        f"misconfiguration (no silent data loss)")
                yield out
    return reader


def open_files(filenames, shapes, dtypes, names, thread_num=1):
    """≙ layers/io.py open_files:724: a multi-file RecordIO reader; files
    are read in order (thread_num is kept for API parity; the threaded
    native reader is data.ParallelRecordLoader)."""
    def reader():
        for fn in filenames:
            yield from open_recordio_file(fn, shapes, dtypes, names)()
    return reader


def shuffle(reader, buffer_size):
    """≙ layers/io.py shuffle:843 (reader-level)."""
    from ..data import decorator
    return decorator.shuffle(reader, buffer_size)


def batch(reader, batch_size, drop_last=True):
    """≙ layers/io.py batch (reader-level): stacks the feed dicts of
    batch_size records key by key."""
    def batched():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield {k: np.stack([b[k] for b in buf]) for k in buf[0]}
                buf = []
        if buf and not drop_last:
            yield {k: np.stack([b[k] for b in buf]) for k in buf[0]}
    return batched


def double_buffer(reader, place=None):
    """≙ layers/io.py double_buffer:921: stage the next batches on `place`
    (CUDAPlace(0) by default) while the current step computes. Keeps the
    reader contract: a zero-argument callable, composable with batch and
    shuffle."""
    from ..data.prefetch import DevicePrefetcher

    def buffered():
        yield from DevicePrefetcher(reader, place=place)
    return buffered


class Preprocessor:
    """≙ layers/io.py Preprocessor:968: a user transform in the reader
    pipeline.

        p = Preprocessor(reader)
        @p.def_transform
        def _(sample): ...
        new_reader = p()
    """

    def __init__(self, reader, name=None):
        self._reader = reader
        self._fn = None

    def def_transform(self, fn):
        self._fn = fn
        return fn

    def __call__(self):
        def transformed():
            for item in self._reader():
                out = self._fn(item)
                if out is not None:
                    yield out
        return transformed
