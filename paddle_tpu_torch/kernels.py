"""Building, loading and counting the port's hand-written CUDA kernels.

Each kernel source in `csrc/` has a plain C interface. It is compiled with
`nvcc` for sm_90a into a shared library at first use and loaded with
ctypes; no PyTorch header is compiled, so a build takes seconds. Libraries
land in `csrc/build/` (or `$PTT_KERNEL_BUILD_DIR`), named by a hash of
their source, so an edited source is rebuilt and a stale library is never
loaded.

`LAUNCHES` counts, per kernel, the launches its wrapper made: a wrapper adds
one where it launches its kernel and nowhere else, so a run can show that a
path went through the kernel (`reset_launch_counts` before, read after).
One library may hold several kernels (flash_attention.cu holds flash_fwd,
flash_bwd_dq and flash_bwd_dkv; recurrent.cu holds lstm_seq and gru_seq).
`flash_fwd_tc`, `flash_bwd_dq_tc` and `flash_bwd_dkv_tc` count the launches
of flash_fwd, flash_bwd_dq and flash_bwd_dkv that took the bfloat16
tensor-core route, and `flash_*_wide` those that took the wide-head route
(head dims above 256); each such launch counts under both names.
`decode_attention_multi` and `decode_attention_int8` count the launches of
decode_attention with a query window of more than one position (the
speculative verify forward) and over an int8 cache, each also counted under
`decode_attention`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")

#: library name -> source file under csrc/
KERNEL_SOURCES = {"decode_attention": "decode_attention.cu",
                  "flash_attention": "flash_attention.cu",
                  "recurrent": "recurrent.cu"}

#: kernel name -> launches made by its wrapper
LAUNCHES: Dict[str, int] = {name: 0 for name in (
    "decode_attention", "decode_attention_multi", "decode_attention_int8",
    "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
    "flash_fwd_tc", "flash_bwd_dq_tc", "flash_bwd_dkv_tc", "flash_fwd_wide",
    "flash_bwd_dq_wide", "flash_bwd_dkv_wide", "lstm_seq", "gru_seq")}

#: library name -> nvcc's output for the last build in this process
BUILD_LOGS: Dict[str, str] = {}

_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch(name: str):
    LAUNCHES[name] += 1


def build_dir() -> str:
    return os.environ.get("PTT_KERNEL_BUILD_DIR") or os.path.join(
        _CSRC, "build")


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source")


def _lib_path(name: str) -> str:
    src = os.path.join(_CSRC, KERNEL_SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(_NVCC_FLAGS).encode())
    return os.path.join(build_dir(), f"{name}-{digest.hexdigest()[:12]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named libraries (default: all) that are not built yet,
    one nvcc per source, all started together. Returns name -> seconds each
    build took (0.0 for a library already on disk). Raises with nvcc's
    output when a build fails."""
    names = list(KERNEL_SOURCES if names is None else names)
    os.makedirs(build_dir(), exist_ok=True)
    procs, took = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            took[name] = 0.0
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp,
               os.path.join(_CSRC, KERNEL_SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)   # atomic: a concurrent loader never sees half
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The named library, built first if needed (cached per process)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not os.path.exists(path):
            build([name])
        lib = ctypes.CDLL(path)
        lib.ptt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ptt_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, err: int):
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.ptt_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")
