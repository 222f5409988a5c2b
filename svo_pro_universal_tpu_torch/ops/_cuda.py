"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled on first use by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into its own shared library with
a plain C interface, loaded with ``ctypes``. The library name carries a hash
of its source and of the shared headers (``csrc/*.cuh``), so an edited
source or header is rebuilt; the build directory
(``svo_pro_universal_tpu_torch/_build``) is git-ignored. ``build_all``
starts one ``nvcc`` per source at once and waits for all of them.

Every C entry point takes device pointers, integer sizes and a stream, runs
on PyTorch's current stream, and returns ``cudaGetLastError()``; a non-zero
code raises here. ``Kernel.launches`` counts the launches of one entry
point — the only place it is incremented is ``Kernel.launch``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(source: str) -> Path:
    src = CSRC / source
    h = hashlib.sha1(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def _start_build(source: str):
    out = _lib_path(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(source: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{source}:\n{log}")
    os.replace(tmp, out)


def build_all() -> list[str]:
    """Compile every ``csrc/*.cu`` not yet built, one nvcc each, all
    started together. Returns the sources."""
    sources = sorted(p.name for p in CSRC.glob("*.cu"))
    jobs = [(s, _start_build(s)) for s in sources]
    for s, job in jobs:
        _finish_build(s, job)
    return sources


def load(source: str) -> ctypes.CDLL:
    lib = _libs.get(source)
    if lib is None:
        _finish_build(source, _start_build(source))
        lib = ctypes.CDLL(str(_lib_path(source)))
        _libs[source] = lib
    return lib


class Kernel:
    """One C entry point of one ``csrc`` source, with its launch count."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list,
                 replaces: str):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces
        self.launches = 0
        self._fn = None

    def _function(self):
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        fn = self._function()
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*args, ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(
                f"CUDA kernel {self.name} failed to launch (cudaError {rc})")
        self.launches += 1


KERNELS: list[Kernel] = []


def register(kernel: Kernel) -> Kernel:
    KERNELS.append(kernel)
    return kernel


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input")
