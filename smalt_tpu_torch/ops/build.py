"""Build the port's CUDA sources into shared libraries at first use.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by
`nvcc` for Hopper (`sm_90a`) into `build/kernels/` at the repository
root, under a name keyed on a hash of the source (with the `csrc/*.cuh`
it includes) and the flags, then
loaded with `ctypes`.  Nothing is compiled at import: the first call
of `load(name)` builds (a few seconds for a plain-C-interface file) and
later calls reuse the loaded library; builds of different sources may
run side by side from several threads.  A missing `nvcc` or a failed
build raises; there is no fallback.  `load_host(name)` builds the host
code a `csrc/<name>.cuh` shares with its kernel (csrc/segcand.cuh) with
the system C++ compiler, for CPU tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_locks: dict = {}          # one per source: builds of different sources overlap
_locks_guard = threading.Lock()
_libs: dict = {}
# per library: {"path", "seconds" (spent building, ~0 when the .so was
# already there), "log" (nvcc's output: ptxas registers and spills)}
build_info: dict = {}


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's "
                           "CUDA kernels are built from source at first use")
    return found


def _source_bytes(src: str) -> bytes:
    """The source's bytes and those of the files it includes by a quoted
    name from its own directory (csrc/*.cuh), so that an edit of either
    keys a new build."""
    with open(src, "rb") as f:
        data = f.read()
    for inc in re.findall(rb'^#include "([^"]+)"', data, re.M):
        with open(os.path.join(os.path.dirname(src), inc.decode()), "rb") as f:
            data += f.read()
    return data


def load_host(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the host build of `csrc/<name>.cuh`:
    the header compiled by the system C++ compiler ($CXX, else c++) with
    <NAME>_HOST defined, which exposes its code for CPU tensors."""
    ident = f"{name} host"
    src = os.path.join(CSRC, name + ".cuh")
    flags = ["-std=c++17", "-O2", "-shared", "-fPIC",
             f"-D{name.upper()}_HOST", "-x", "c++"]
    with _locks_guard:
        lock = _locks.setdefault(ident, threading.Lock())
    with lock:
        lib = _libs.get(ident)
        if lib is not None:
            return lib
        key = hashlib.sha256(_source_bytes(src) + " ".join(flags).encode())
        so = os.path.join(BUILD_DIR, f"{name}_host-{key.hexdigest()[:16]}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run([os.environ.get("CXX", "c++")] + flags +
                                  ["-o", tmp, src], capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"c++ failed on {src}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
        lib = _libs[ident] = ctypes.CDLL(so)
        return lib


def load(name: str, src: str = "") -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`, or, for a script that
    times an earlier version of a kernel beside the shipped one, another
    source file `src` with the same C interface."""
    ident = f"{name} {src}" if src else name     # key in _libs, build_info
    src = src or os.path.join(CSRC, name + ".cu")
    with _locks_guard:
        lock = _locks.setdefault(ident, threading.Lock())
    with lock:
        lib = _libs.get(ident)
        if lib is not None:
            return lib
        key = hashlib.sha256(_source_bytes(src) +
                             " ".join(NVCC_FLAGS).encode())
        so = os.path.join(BUILD_DIR, f"{name}-{key.hexdigest()[:16]}.so")
        t0 = time.perf_counter()
        log = ""
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run([nvcc()] + NVCC_FLAGS + ["-o", tmp, src],
                                  capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{log}")
            os.replace(tmp, so)
        build_info[ident] = {"path": so, "log": log,
                             "seconds": time.perf_counter() - t0}
        lib = _libs[ident] = ctypes.CDLL(so)
        return lib

