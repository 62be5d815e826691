"""Build and load the hand-written CUDA kernels of ``stardist_torch/csrc``.

Each ``.cu`` file is compiled on first use with ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Libraries go to ``build/stardist_torch/``
beside the package and are named by a hash of the source, the headers of
``csrc`` it includes and the flags, so an edited source or header is
rebuilt and an unchanged one is loaded as it is.

Every C entry point takes device pointers and the CUDA stream as
``void*`` plus ``int`` sizes, launches on that stream, and returns
``cudaGetLastError()``; :meth:`CudaKernel.launch` raises when it is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "stardist_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def local_sources(path, found=None):
    """``path`` and the files of its directory that it includes with
    ``#include "..."``, directly or through one another."""
    found = [] if found is None else found
    if path not in found:
        found.append(path)
        for name in _LOCAL_INCLUDE.findall(path.read_text()):
            local_sources(path.parent / name, found)
    return found


def nvcc_path():
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of stardist_torch "
                           "are built on first use and need the CUDA toolkit")
    return nvcc


class CudaKernel:
    """One ``.cu`` source, built on first use; ``launches`` counts the
    kernel launches made through :meth:`launch`.

    ``entry`` is the C function name, ``argtypes`` its ctypes signature
    (pointers and the stream as ``c_void_p``, sizes as ``c_int``)."""

    def __init__(self, source, entry, argtypes, extra_flags=()):
        self.source = CSRC / source
        self.entry = entry
        self.argtypes = list(argtypes)
        self.flags = NVCC_FLAGS + tuple(extra_flags)
        self.launches = 0
        self.build_seconds = None
        self._fn = None

    def library_path(self):
        h = hashlib.sha256()
        for path in local_sources(self.source):
            h.update(path.read_bytes())
        h.update(" ".join(self.flags).encode())
        return BUILD_DIR / f"lib{self.source.stem}_{h.hexdigest()[:16]}.so"

    def build(self):
        """Compile (if the library for this source is missing) and load;
        returns the ctypes function."""
        if self._fn is not None:
            return self._fn
        lib_path = self.library_path()
        t0 = time.perf_counter()
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *self.flags, "-o", str(tmp), str(self.source)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {self.source.name}:\n"
                                   f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        fn = getattr(lib, self.entry)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._lib = lib
        self._fn = fn
        self.build_seconds = time.perf_counter() - t0
        return fn

    def launch(self, *args):
        """Call the C entry point; raise on a nonzero CUDA error code."""
        fn = self.build()
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.entry} failed with CUDA error {err}")
        self.launches += 1


def stream_ptr(device):
    """The current CUDA stream of ``device`` as a ctypes pointer value."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
