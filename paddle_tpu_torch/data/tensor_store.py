"""ctypes binding for the native tensor container (csrc/tensor_store.cc).

≙ paddle_tpu/data/tensor_store.py (≙ reference save_combine_op.cc /
load_combine_op.cc + LoDTensor SerializeToStream): many named tensors in
one CRC-checked file, streamed through C++. The file format and dtype
codes are the JAX package's, so either package reads the other's files,
and both write the same bytes for the same tensors in the same order.

The library is built with g++ at first use into `csrc/build/` (beside the
CUDA kernels, named by a hash of its source) and needs no GPU and no
zlib. A failed build raises; no other container stands in.
io.save_vars / load_vars route any `filename` ending in `.pts` here.

Tensors go in as torch tensors (any device: a CUDA tensor is copied to
the host first) or numpy arrays, and come out as CPU torch tensors:
numpy has no bfloat16, torch has all eleven codes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

_DTYPES = ["float32", "float64", "int32", "int64", "uint8", "bool",
           "bfloat16", "float16", "int16", "uint32", "uint64"]
_CODE = {name: i for i, name in enumerate(_DTYPES)}
_TORCH = {name: getattr(torch, name) for name in _DTYPES}
_NAME_OF = {v: k for k, v in _TORCH.items()}
MAGIC = 0x50545453

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "tensor_store.cc")
_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _lib_path() -> str:
    from ..kernels import build_dir
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(_FLAGS).encode())
    return os.path.join(build_dir(), f"tensor_store-{digest.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the container's library with g++ unless it is on disk.
    Returns its path; raises with the compiler's output on failure."""
    path = _lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    out = subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"tensor_store build failed (g++ exit "
                           f"{out.returncode}):\n{out.stdout}{out.stderr}")
    os.replace(tmp, path)   # atomic: a concurrent loader never sees half
    return path


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        lib.ptpu_store_writer_open.restype = ctypes.c_void_p
        lib.ptpu_store_writer_open.argtypes = [ctypes.c_char_p]
        lib.ptpu_store_writer_add.restype = ctypes.c_int
        lib.ptpu_store_writer_add.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint8,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint8,
            ctypes.c_void_p, ctypes.c_uint64]
        lib.ptpu_store_writer_finish.restype = ctypes.c_int
        lib.ptpu_store_writer_finish.argtypes = [ctypes.c_void_p]
        lib.ptpu_store_reader_open.restype = ctypes.c_void_p
        lib.ptpu_store_reader_open.argtypes = [ctypes.c_char_p]
        lib.ptpu_store_reader_names.restype = ctypes.c_uint64
        lib.ptpu_store_reader_names.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
        lib.ptpu_store_reader_meta.restype = ctypes.c_uint64
        lib.ptpu_store_reader_meta.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint64)]
        lib.ptpu_store_reader_read.restype = ctypes.c_int
        lib.ptpu_store_reader_read.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
            ctypes.c_uint64]
        lib.ptpu_store_reader_close.restype = None
        lib.ptpu_store_reader_close.argtypes = [ctypes.c_void_p]
        lib.ptpu_store_version.restype = ctypes.c_uint32
        _lib = lib
        return lib


def _host_tensor(name: str, value) -> torch.Tensor:
    """`value` as a contiguous CPU tensor of one of the container's
    dtypes."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.device.type != "cpu":
            t = t.cpu()
    else:
        arr = np.asarray(value)
        if arr.dtype.name not in _CODE or arr.dtype.name == "bfloat16":
            raise ValueError(f"tensor_store: unsupported dtype "
                             f"{arr.dtype.name!r} for {name!r}")
        t = torch.from_numpy(np.ascontiguousarray(arr))
    if t.dim() == 0:
        # as the JAX package (np.ascontiguousarray makes a 0-d array 1-d):
        # a scalar is stored with shape (1,), so both write the same bytes
        t = t.reshape(1)
    if t.dtype not in _NAME_OF:
        raise ValueError(f"tensor_store: unsupported dtype {t.dtype} for "
                         f"{name!r}")
    if t.dim() > 16:
        raise ValueError(f"tensor_store: {name!r} has {t.dim()} dims; the "
                         f"container supports at most 16")
    return t.contiguous()


def save_tensors(path: str, tensors: Dict[str, object]):
    """Write named tensors into one container file, in the dict's order.
    Atomic: data goes to a temp file that replaces `path` only after a
    successful finalize, so a failure mid-save never leaves a valid-looking
    partial file over the previous good one."""
    lib = _load()
    tmp = path + ".tmp"
    h = lib.ptpu_store_writer_open(tmp.encode())
    if not h:
        raise IOError(f"tensor_store: cannot open {tmp!r} for writing")
    try:
        for name, value in tensors.items():
            t = _host_tensor(name, value)
            dims = (ctypes.c_uint64 * max(t.dim(), 1))(*t.shape)
            nbytes = t.numel() * t.element_size()
            # the tensor's own buffer, no copy; `t` stays referenced for
            # the duration of the call
            ok = lib.ptpu_store_writer_add(
                h, name.encode(), _CODE[_NAME_OF[t.dtype]], dims, t.dim(),
                ctypes.c_void_p(t.data_ptr() if nbytes else 0), nbytes)
            if not ok:
                raise IOError(f"tensor_store: write failed for {name!r}")
    except Exception:
        lib.ptpu_store_writer_finish(h)   # release the handle...
        try:
            os.unlink(tmp)                # ...and discard the partial file
        except OSError:
            pass
        raise
    if not lib.ptpu_store_writer_finish(h):
        raise IOError(f"tensor_store: finalize failed for {path!r}")
    os.replace(tmp, path)


def _names(lib, h) -> List[str]:
    n = lib.ptpu_store_reader_names(h, None, 0)
    buf = ctypes.create_string_buffer(int(n))
    lib.ptpu_store_reader_names(h, buf, n)
    return buf.raw[:int(n)].decode().split("\n") if n else []


class Reader:
    """One container file open for reading: its index parsed once, any
    entry read on demand (each payload CRC-verified). Close it (or use it
    as a context manager) to release the native handle."""

    def __init__(self, path: str):
        self.path = path
        self._lib = _load()
        self._h = self._lib.ptpu_store_reader_open(path.encode())
        if not self._h:
            raise IOError(_open_error(path))

    def names(self) -> List[str]:
        return _names(self._lib, self._h)

    def read(self, name: str) -> torch.Tensor:
        lib, h = self._lib, self._h
        dtype = ctypes.c_uint8()
        ndim = ctypes.c_uint8()
        dims = (ctypes.c_uint64 * 16)()
        dlen = lib.ptpu_store_reader_meta(
            h, name.encode(), ctypes.byref(dtype), ctypes.byref(ndim), dims)
        if dlen == ctypes.c_uint64(-1).value:
            raise KeyError(f"tensor_store: {name!r} not in {self.path!r}")
        if dtype.value >= len(_DTYPES):
            raise IOError(f"tensor_store: {name!r} in {self.path!r} has "
                          f"unknown dtype code {dtype.value}")
        shape = tuple(int(dims[i]) for i in range(ndim.value))
        t = torch.empty(shape, dtype=_TORCH[_DTYPES[dtype.value]])
        if t.numel() * t.element_size() != dlen:
            raise IOError(f"tensor_store: {name!r} in {self.path!r} holds "
                          f"{dlen} bytes for shape {shape}")
        if not lib.ptpu_store_reader_read(
                h, name.encode(), ctypes.c_void_p(t.data_ptr()), dlen):
            raise IOError(f"tensor_store: CRC/read failure for {name!r} in "
                          f"{self.path!r}")
        return t

    def close(self):
        if self._h:
            self._lib.ptpu_store_reader_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        self.close()


def load_tensors(path: str, names: Optional[List[str]] = None
                 ) -> Dict[str, torch.Tensor]:
    """Read (a subset of) named tensors back as CPU tensors; each payload
    is CRC-verified, and only the named entries are read."""
    with Reader(path) as r:
        return {n: r.read(n) for n in (r.names() if names is None
                                       else names)}


def list_tensors(path: str) -> List[str]:
    with Reader(path) as r:
        return r.names()


def _format_version() -> int:
    """The native library is the single source of truth for the format."""
    return int(_load().ptpu_store_version())


def _open_error(path: str) -> str:
    """Tell a wrong container version from corruption."""
    if not os.path.exists(path):
        return f"tensor_store: {path!r} does not exist"
    try:
        with open(path, "rb") as f:
            magic, version = struct.unpack("<II", f.read(8))
        current = _format_version()
        if magic == MAGIC and version != current:
            return (f"tensor_store: {path!r} is container format "
                    f"v{version}; this build reads v{current} — "
                    f"re-save the checkpoint with the current version")
    except Exception:
        pass
    return (f"tensor_store: cannot open {path!r} "
            f"(truncated or corrupt index)")
