"""RecordIO: chunked CRC-checked record files and a threaded native loader.

≙ paddle_tpu/data/recordio.py (reference paddle/fluid/recordio/{writer,
scanner,chunk}.h and the C++ reader stack, operators/reader/
buffered_reader.h:27, lod_tensor_blocking_queue.h:31, open_files_op.cc):
a Python surface over csrc/recordio.cc, the port's copy of the JAX
package's native container. The chunk format is the same, so either
package reads the other's files, and both write the same bytes for the
same records (compressed chunks too, with one zlib).

The library is built with g++ at first use into `csrc/build/` (beside the
CUDA kernels, named by a hash of its source and flags), linking libz by
its runtime name, and loaded with ctypes. A failed build raises; nothing
stands in for it.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Iterator, Optional, Sequence

from ..core.enforce import InvalidArgumentError, NotFoundError, enforce

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "recordio.cc")
_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]
# libz by its runtime name: no zlib header or libz.so link is needed
_LINK = ["-l:libz.so.1", "-lpthread"]
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def build() -> str:
    """Compile the container's library with g++ unless it is on disk.
    Returns its path; raises with the compiler's output on failure."""
    from ..kernels import build_host_library
    return build_host_library(_SRC, "recordio", _FLAGS, _LINK)


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        lib.rio_writer_open.restype = ctypes.c_void_p
        lib.rio_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32,
                                        ctypes.c_int]
        lib.rio_writer_write.restype = ctypes.c_int
        lib.rio_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_uint32]
        lib.rio_writer_flush.restype = ctypes.c_int
        lib.rio_writer_flush.argtypes = [ctypes.c_void_p]
        lib.rio_writer_close.restype = ctypes.c_int
        lib.rio_writer_close.argtypes = [ctypes.c_void_p]
        lib.rio_scanner_open.restype = ctypes.c_void_p
        lib.rio_scanner_open.argtypes = [ctypes.c_char_p]
        lib.rio_scanner_next.restype = ctypes.POINTER(ctypes.c_char)
        lib.rio_scanner_next.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_uint32)]
        lib.rio_scanner_skipped.restype = ctypes.c_uint32
        lib.rio_scanner_skipped.argtypes = [ctypes.c_void_p]
        lib.rio_scanner_close.argtypes = [ctypes.c_void_p]
        lib.rio_loader_open.restype = ctypes.c_void_p
        lib.rio_loader_open.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.c_uint32]
        lib.rio_loader_next.restype = ctypes.POINTER(ctypes.c_char)
        lib.rio_loader_next.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_uint32)]
        lib.rio_loader_failed_files.restype = ctypes.c_uint32
        lib.rio_loader_failed_files.argtypes = [ctypes.c_void_p]
        lib.rio_loader_skipped.restype = ctypes.c_uint32
        lib.rio_loader_skipped.argtypes = [ctypes.c_void_p]
        lib.rio_loader_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class RecordIOWriter:
    """Append records (bytes) to a chunked file; context manager closes.

    ≙ recordio::Writer (reference recordio/writer.h)."""

    def __init__(self, path: str, max_chunk_bytes: int = 1 << 20,
                 compress: bool = False):
        lib = _load()
        self._lib = lib
        self._h = lib.rio_writer_open(path.encode(), max_chunk_bytes,
                                      1 if compress else 0)
        enforce(self._h, f"cannot open {path!r} for writing",
                exc=NotFoundError)

    def _handle(self):
        enforce(self._h, "writer is closed", exc=InvalidArgumentError)
        return self._h

    def write(self, record: bytes):
        enforce(isinstance(record, (bytes, bytearray)),
                "record must be bytes", exc=InvalidArgumentError)
        rc = self._lib.rio_writer_write(self._handle(), bytes(record),
                                        len(record))
        enforce(rc == 0, "recordio write failed")

    def flush(self):
        enforce(self._lib.rio_writer_flush(self._handle()) == 0,
                "flush failed")

    def close(self):
        if self._h:
            self._lib.rio_writer_close(self._h)
            self._h = None

    def __del__(self):  # flush the buffered tail chunk if never closed
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordIOScanner:
    """Iterate records of one file; corrupt chunks are skipped (resync on
    the chunk magic) and counted in .skipped_chunks.

    ≙ recordio::Scanner (reference recordio/scanner.h)."""

    def __init__(self, path: str):
        lib = _load()
        self._lib = lib
        self._h = lib.rio_scanner_open(path.encode())
        enforce(self._h, f"cannot open {path!r}", exc=NotFoundError)

    def _handle(self):
        enforce(self._h, "scanner is closed", exc=InvalidArgumentError)
        return self._h

    def __iter__(self) -> Iterator[bytes]:
        n = ctypes.c_uint32()
        while True:
            p = self._lib.rio_scanner_next(self._handle(), ctypes.byref(n))
            if not p:
                return
            yield ctypes.string_at(p, n.value)

    @property
    def skipped_chunks(self) -> int:
        return self._lib.rio_scanner_skipped(self._handle())

    def close(self):
        if self._h:
            self._lib.rio_scanner_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ParallelRecordLoader:
    """N native threads scan a file list into a bounded in-memory queue;
    iterate to consume. The C++ analogue of the reference's
    open_files + double_buffer reader stack."""

    def __init__(self, paths: Sequence[str], num_threads: int = 4,
                 queue_capacity: int = 256):
        enforce(len(paths) > 0, "need at least one file",
                exc=InvalidArgumentError)
        missing = [p for p in paths if not os.path.exists(p)]
        enforce(not missing, f"recordio files not found: {missing}",
                exc=NotFoundError)
        lib = _load()
        self._lib = lib
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._h = lib.rio_loader_open(arr, len(paths), num_threads,
                                      queue_capacity)
        enforce(self._h, "loader open failed")

    def __iter__(self) -> Iterator[bytes]:
        n = ctypes.c_uint32()
        while True:
            enforce(self._h, "loader is closed", exc=InvalidArgumentError)
            p = self._lib.rio_loader_next(self._h, ctypes.byref(n))
            if not p:
                # workers are done; a file that raced past the ctor
                # existence check (deleted/unreadable) must not pass as
                # silent data loss
                failed = self._lib.rio_loader_failed_files(self._h)
                if failed:
                    raise IOError(f"{failed} recordio file(s) could not "
                                  f"be opened by the loader")
                return
            yield ctypes.string_at(p, n.value)

    @property
    def skipped_chunks(self) -> int:
        """Corrupt chunks skipped (summed over finished files)."""
        enforce(self._h, "loader is closed", exc=InvalidArgumentError)
        return self._lib.rio_loader_skipped(self._h)

    def close(self):
        if self._h:
            self._lib.rio_loader_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_numpy_records(path: str, arrays_iter, compress: bool = False):
    """Serialize an iterable of numpy-array tuples as records (npz-free
    compact framing: npy bytes per field)."""
    import io as _io

    import numpy as np
    with RecordIOWriter(path, compress=compress) as w:
        count = 0
        for tup in arrays_iter:
            if not isinstance(tup, (list, tuple)):
                tup = (tup,)
            buf = _io.BytesIO()
            buf.write(np.array(len(tup), dtype="<u4").tobytes())
            for a in tup:
                f = _io.BytesIO()
                np.save(f, np.asarray(a), allow_pickle=False)
                b = f.getvalue()
                buf.write(np.array(len(b), dtype="<u4").tobytes())
                buf.write(b)
            w.write(buf.getvalue())
            count += 1
    return count


def read_numpy_records(source) -> Iterator[tuple]:
    """Inverse of write_numpy_records; `source` is a Scanner/Loader or an
    iterable of raw record bytes."""
    import io as _io

    import numpy as np
    for rec in source:
        off = 0
        nf = int(np.frombuffer(rec, "<u4", 1, off)[0])
        off += 4
        out = []
        for _ in range(nf):
            ln = int(np.frombuffer(rec, "<u4", 1, off)[0])
            off += 4
            out.append(np.load(_io.BytesIO(rec[off:off + ln]),
                               allow_pickle=False))
            off += ln
        yield tuple(out)
