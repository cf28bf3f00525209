"""Building the native programs `ptpu_predict` and `ptpu_train` at first
use (≙ paddle_tpu/native/build.sh).

The sources are `csrc/native/`: `runtime.cc` (the graph runner, .npy,
meta, JSON, wire framing) and `ptpu_ops.cc` (the `ptpu::` ops), compiled
once each and linked into both programs, plus one `.cc` per program. They
are compiled with g++ against the installed torch's headers and libraries
(`torch.utils.cpp_extension.include_paths()` / `library_paths()`), with
ATen / c10 and the dispatcher, not `<torch/torch.h>`. The `ptpu::` schemas
come from `kernel_ops.SCHEMAS`, written into a generated header, and the
archive schema version the runner reads from the installed torch's
`torch._export.serde.schema.SCHEMA_VERSION`.

With a card (`cuda=True`, the default where one is visible) the build adds
the CUDA include path, `PTPU_WITH_CUDA` (the ops' CUDA implementations)
and links the kernel libraries that `kernels.build()` produces. The
programs land in `csrc/build/native-<hash>/` (or under
`$PTT_KERNEL_BUILD_DIR`), named by a hash of the sources, the schemas,
the flags and the kernel libraries, so an edited source is rebuilt and a
stale program is never run.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List, Optional

from . import kernel_ops, kernels

_SRC = os.path.join(kernels._CSRC, "native")

#: objects shared by every program
SHARED_SOURCES = ("runtime.cc", "ptpu_ops.cc")

#: program name -> its main source
PROGRAMS = {"ptpu_predict": "ptpu_predict.cc", "ptpu_train": "ptpu_train.cc"}

#: seconds the last build in this process took, per step ("compile",
#: "link"); empty when every call found the programs on disk
BUILD_SECONDS: Dict[str, float] = {}


def _schema_header() -> str:
    rows = ",\n".join(f'    "{s}"' for s in kernel_ops.SCHEMAS.values())
    return ("// generated by paddle_tpu_torch/native.py from "
            "kernel_ops.SCHEMAS\n#pragma once\n"
            f"static const char* const kPtpuSchemas[] = {{\n{rows}}};\n")


def _flags(cuda: bool) -> List[str]:
    import torch
    from torch._export.serde.schema import SCHEMA_VERSION
    from torch.utils import cpp_extension
    flags = ["-std=c++20", "-O2", "-fPIC", "-pthread",
             f"-D_GLIBCXX_USE_CXX11_ABI="
             f"{int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
             f"-DPTPU_SCHEMA_MAJOR={SCHEMA_VERSION[0]}",
             f"-DPTPU_SCHEMA_MINOR={SCHEMA_VERSION[1]}"]
    flags += [f"-I{p}" for p in cpp_extension.include_paths()]
    if cuda:
        home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
        flags += ["-DPTPU_WITH_CUDA", f"-I{os.path.join(home, 'include')}"]
    return flags


def _libs(cuda: bool) -> List[str]:
    """The link flags: torch's libraries and, with `cuda`, the kernel
    libraries (named by their sources' hash; built before the link)."""
    from torch.utils import cpp_extension
    libdir = cpp_extension.library_paths()[0]
    libs = ["-ltorch_cpu", "-lc10"]
    kernel_libs, rpaths = [], [libdir]
    if cuda:
        cudart = _cudart()
        libs += ["-ltorch_cuda", "-lc10_cuda", cudart]
        rpaths.append(os.path.dirname(cudart))
        kernel_libs = [kernels._lib_path(n) for n in kernels.KERNEL_SOURCES]
    # without --no-as-needed the linker may drop libtorch_cuda, and with it
    # the CUDA kernels of every aten op (they register at load time)
    return ([f"-L{libdir}", "-Wl,--no-as-needed", *libs, *kernel_libs,
             "-Wl,--as-needed", *(f"-Wl,-rpath,{d}" for d in rpaths),
             "-pthread"])


def _cudart() -> str:
    """The CUDA runtime library torch loads (the pip wheel's, beside
    torch, else the toolkit's): the ops' stream guards call into it."""
    import glob
    import torch
    site = os.path.dirname(os.path.dirname(torch.__file__))
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for pattern in (os.path.join(site, "nvidia", "cuda_runtime", "lib",
                                 "libcudart.so*"),
                    os.path.join(site, "nvidia", "cu*", "lib",
                                 "libcudart.so*"),
                    os.path.join(home, "lib64", "libcudart.so*")):
        found = sorted(glob.glob(pattern))
        if found:
            return found[-1]
    raise RuntimeError("libcudart not found beside torch or in CUDA_HOME")


def _sources() -> List[str]:
    return sorted(f for f in os.listdir(_SRC) if f.endswith((".cc", ".h")))


def _out_dir(cuda: bool) -> str:
    h = hashlib.sha1()
    for f in _sources():
        with open(os.path.join(_SRC, f), "rb") as fh:
            h.update(f.encode() + fh.read())
    h.update(_schema_header().encode())
    h.update(" ".join(_flags(cuda) + _libs(cuda)).encode())
    return os.path.join(kernels.build_dir(), f"native-{h.hexdigest()[:12]}")


def _run_all(cmds: List[List[str]], what: str):
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for cmd, p in zip(cmds, procs):
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{' '.join(cmd[-3:])} (exit {p.returncode}):\n"
                          f"{log[-6000:]}")
    if failed:
        raise RuntimeError(f"native {what} failed: " + "\n".join(failed))


def build(cuda: Optional[bool] = None) -> Dict[str, str]:
    """Build the programs (those of this source and flags not on disk yet)
    and return {name: path}. `cuda` defaults to whether a card is visible.
    The shared objects and the mains compile in parallel, one g++ each,
    then link against the kernel libraries (`kernels.build()`, which a
    caller may be running in another thread meanwhile)."""
    import torch
    if cuda is None:
        cuda = torch.cuda.is_available()
    out = _out_dir(cuda)
    paths = {name: os.path.join(out, name) for name in PROGRAMS}
    if all(os.path.exists(p) for p in paths.values()):
        return paths
    os.makedirs(kernels.build_dir(), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, "ptpu_schemas.h"), "w") as f:
        f.write(_schema_header())
    flags = _flags(cuda) + [f"-I{tmp}", f"-I{_SRC}"]
    srcs = list(SHARED_SOURCES) + list(PROGRAMS.values())
    t0 = time.perf_counter()
    try:
        _run_all([["g++", *flags, "-c", os.path.join(_SRC, s), "-o",
                   os.path.join(tmp, s.replace(".cc", ".o"))]
                  for s in srcs], "compile")
        if cuda:
            kernels.build()   # waits for a build another thread runs
        t1 = time.perf_counter()
        shared = [os.path.join(tmp, s.replace(".cc", ".o"))
                  for s in SHARED_SOURCES]
        _run_all([["g++", os.path.join(tmp, src.replace(".cc", ".o")),
                   *shared, "-o", os.path.join(tmp, name), *_libs(cuda)]
                  for name, src in PROGRAMS.items()], "link")
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    BUILD_SECONDS.update(compile=t1 - t0, link=time.perf_counter() - t1)
    try:
        os.replace(tmp, out)   # atomic: a concurrent caller never sees half
    except OSError:
        shutil.rmtree(tmp, ignore_errors=True)   # another build won the race
    return paths
