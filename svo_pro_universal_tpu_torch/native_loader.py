"""PNG decoding for the dataset loaders: the native (C++) decoder and
threaded prefetch loader, and a numpy decoder on the standard library's
zlib.

The native library is built from the repository's ``native/png_decode.cc``
and ``native/prefetch_loader.cc`` with ``g++ -lz`` into the git-ignored
``svo_pro_universal_tpu_torch/_build/`` (its name carries a hash of the
sources, so an edited source is rebuilt), and loaded with ctypes. A build
that fails raises with the compiler's log. Which decoder a run uses is the
caller's explicit choice (``decoder("native")`` / ``decoder("numpy")``,
the runners' ``--png-decoder``): ``toolchain_check`` says whether the
native one can be built where it runs, and nothing falls back silently.
``native_available`` and ``decode_png_gray8`` keep the JAX package's
names and contract (None where the library is absent) for its callers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
import zlib
from pathlib import Path
from typing import Callable

import numpy as np

_PKG = Path(__file__).resolve().parent
NATIVE_DIR = _PKG.parent / "native"
SOURCES = ("png_decode.cc", "prefetch_loader.cc")
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-shared"]
LINK_FLAGS = ["-lz", "-lpthread"]
MAX_PIXELS = 4096 * 4096
DECODERS = ("native", "numpy")

_lib = None


def _cxx() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++"):
        if name and shutil.which(name):
            return shutil.which(name)
    raise RuntimeError("no C++ compiler (g++) found: the native PNG decoder "
                       "cannot be built; choose the numpy decoder")


def library_path() -> Path:
    digest = hashlib.sha1(b"".join(
        (NATIVE_DIR / s).read_bytes() for s in SOURCES)).hexdigest()[:12]
    return BUILD_DIR / f"libsvotpu_native_{digest}.so"


def toolchain_check() -> tuple[bool, str]:
    """Whether a C++ compiler with zlib's header and library is here:
    compiles and links a two-line program. Returns (ok, the compiler's
    output or the reason)."""
    try:
        cxx = _cxx()
    except RuntimeError as e:
        return False, str(e)
    with tempfile.TemporaryDirectory() as d:
        src = Path(d) / "probe.cc"
        src.write_text("#include <zlib.h>\n"
                       "int main() { return zlibVersion() == nullptr; }\n")
        proc = subprocess.run([cxx, str(src), "-lz", "-o", str(Path(d) / "p")],
                              capture_output=True, text=True, timeout=120)
    return proc.returncode == 0, (proc.stdout + proc.stderr).strip()


def build() -> Path:
    """Compile the native library unless it is built; raise with the
    compiler's log when that fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_cxx(), *CXX_FLAGS, *(str(NATIVE_DIR / s) for s in SOURCES),
           *LINK_FLAGS, "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError("building the native PNG decoder failed:\n"
                           + proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The native library (built on first use)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.svo_loader_create.restype = ctypes.c_void_p
    lib.svo_loader_create.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int]
    lib.svo_loader_next.restype = ctypes.c_int
    lib.svo_loader_next.argtypes = [ctypes.c_void_p, u8p, ctypes.c_size_t,
                                    ip, ip]
    lib.svo_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.svo_png_decode_gray8.restype = ctypes.c_int
    lib.svo_png_decode_gray8.argtypes = [u8p, ctypes.c_size_t, u8p,
                                         ctypes.c_size_t, ip, ip]
    _lib = lib
    return lib


def decode_png_gray8_native(data: bytes) -> np.ndarray:
    """8-bit grayscale [H, W] of a PNG by the native decoder."""
    lib = load_library()
    out = np.empty((MAX_PIXELS,), np.uint8)
    w, h = ctypes.c_int(), ctypes.c_int()
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    rc = lib.svo_png_decode_gray8(
        buf, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        MAX_PIXELS, ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise ValueError(f"native PNG decode failed (code {rc})")
    return out[: w.value * h.value].reshape(h.value, w.value).copy()


def native_available() -> bool:
    """Whether the native library builds and loads here (JAX
    native_loader.py:60-61)."""
    try:
        load_library()
    except (RuntimeError, OSError):
        return False
    return True


def decode_png_gray8(data: bytes) -> np.ndarray | None:
    """The JAX package's contract (native_loader.py:64-78): the native
    decoder's [H, W] uint8 image, or None when the library is absent or
    the decode fails. ``decode_png_gray8_native`` raises instead."""
    if not native_available():
        return None
    try:
        return decode_png_gray8_native(data)
    except ValueError:
        return None


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def decode_png_gray8_numpy(data: bytes) -> np.ndarray:
    """The plain decoder: the same formats and gray conversion as
    native/png_decode.cc (8-bit gray / gray+alpha / RGB / RGBA, 16-bit
    gray by its high byte, no interlace, luma (299 R + 587 G + 114 B) /
    1000), on the standard library's zlib."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, ihdr = 8, [], None
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body[:13])
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = ihdr
    channels = {0: 1, 2: 3, 4: 2, 6: 4}.get(color)
    if channels is None or interlace or not (
            depth == 8 or (depth == 16 and color == 0)):
        raise ValueError(f"unsupported PNG (color {color}, depth {depth}, "
                         f"interlace {interlace})")
    bpp = channels * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != (stride + 1) * h:
        raise ValueError("PNG data of the wrong size")
    raw = raw.reshape(h, stride + 1)
    img = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        f, s = int(raw[y, 0]), raw[y, 1:]
        if f == 0:
            cur = s.copy()
        elif f == 1:
            cur = np.cumsum(s.reshape(w, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif f == 2:
            cur = s + prev
        elif f in (3, 4):
            cur = np.zeros(stride, np.int64)
            si, pi = s.astype(np.int64), prev.astype(np.int64)
            for x in range(stride):
                a = int(cur[x - bpp]) if x >= bpp else 0
                b = int(pi[x])
                if f == 3:
                    cur[x] = (si[x] + (a + b) // 2) & 0xFF
                else:
                    c = int(pi[x - bpp]) if x >= bpp else 0
                    cur[x] = (si[x] + _paeth(a, b, c)) & 0xFF
            cur = cur.astype(np.uint8)
        else:
            raise ValueError(f"bad PNG filter {f}")
        img[y] = cur
        prev = cur
    if color == 0 and depth == 8:
        return img
    if color in (0, 4):                   # 16-bit gray, gray + alpha
        return np.ascontiguousarray(img[:, 0::2])
    px = img.reshape(h, w, channels).astype(np.int32)
    return ((299 * px[..., 0] + 587 * px[..., 1] + 114 * px[..., 2])
            // 1000).astype(np.uint8)


def decoder(name: str) -> Callable[[bytes], np.ndarray]:
    """The decoder a run chose: "native" (built now, raising if it cannot
    be) or "numpy"."""
    if name == "native":
        load_library()
        return decode_png_gray8_native
    if name == "numpy":
        return decode_png_gray8_numpy
    raise ValueError(f"unknown PNG decoder {name!r}; one of {DECODERS}")


class PrefetchLoader:
    """In-order stream of decoded 8-bit images from a list of PNG paths,
    read and decoded ahead by the native library's threads
    (native/prefetch_loader.cc)."""

    def __init__(self, paths: list[str], capacity: int = 8,
                 n_threads: int = 3):
        self._lib = load_library()
        self._paths = [str(p).encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._handle = self._lib.svo_loader_create(arr, len(self._paths),
                                                   capacity, n_threads)
        self._n = len(self._paths)
        self._i = 0

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._i >= self._n:
            raise StopIteration
        out = np.empty((MAX_PIXELS,), np.uint8)
        w, h = ctypes.c_int(), ctypes.c_int()
        rc = self._lib.svo_loader_next(
            self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            MAX_PIXELS, ctypes.byref(w), ctypes.byref(h))
        self._i += 1
        if rc != 0:
            raise RuntimeError(f"native decode failed (code {rc})")
        return out[: w.value * h.value].reshape(h.value, w.value).copy()

    def close(self) -> None:
        if self._handle:
            self._lib.svo_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()
