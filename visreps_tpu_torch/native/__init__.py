"""The host's JPEG/PNG decode pipeline in C++ (``fastimage.cpp``): libjpeg
/ libpng decode, PIL-compatible shorter-side BILINEAR resize, centre
crop, optional horizontal flip, float32-normalised or uint8 NHWC output,
over a thread pool; one C call per batch.

The library is compiled with ``g++`` at first use (never at import) into
the git-ignored ``visreps_tpu_torch/_build/``, keyed by a hash of the
source and the flags, and loaded with ctypes. It needs g++ and the
libjpeg and libpng headers. When the build (or the load) fails, its message
is printed once and kept in ``BUILD_ERROR``, ``native_available()`` is
False, and the loaders decode with PIL instead (``data/loader.py``).
The source and flags are the JAX package's, so both packages decode to
the same pixels bit for bit on one machine.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "fastimage.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg", "-lpng", "-lpthread")

#: The compiler's message of this process's failed build, else "".
BUILD_ERROR = ""

_lib = None
_lib_failed = False
_lock = threading.Lock()


def _build_lib() -> Path | None:
    """Compile the library unless this source and these flags are built
    already; its path, or None (with the message printed) on failure."""
    global BUILD_ERROR
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(GXX_FLAGS + LIBS).encode())
    so_path = BUILD_DIR / f"fastimage_{digest.hexdigest()[:12]}.so"
    if so_path.exists():
        return so_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_name(f"{so_path.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp), *LIBS]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=120)
    except (subprocess.CalledProcessError, FileNotFoundError, subprocess.TimeoutExpired) as e:
        BUILD_ERROR = f"{e}; {(getattr(e, 'stderr', '') or '').strip()[:500]}"
        print(f"fastimage build failed ({BUILD_ERROR})")
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, so_path)  # atomic: concurrent builds each install a whole file
    return so_path


def get_lib():
    """The loaded library, building it on the first call; None when the
    build or the load failed (then every later call returns None at once)."""
    global _lib, _lib_failed, BUILD_ERROR
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        so = _build_lib()
        try:
            lib = ctypes.CDLL(str(so)) if so is not None else None
        except OSError as e:  # built, but its libjpeg / libpng do not load here
            BUILD_ERROR = f"loading {so.name} failed: {e}"
            print(f"fastimage load failed ({BUILD_ERROR})")
            lib = None
        if lib is None:
            _lib_failed = True
            return None
        lib.decode_resize_batch.restype = ctypes.c_int
        lib.decode_resize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),  # paths
            ctypes.c_int,                     # n
            ctypes.c_int,                     # resize_short
            ctypes.c_int,                     # crop
            ctypes.POINTER(ctypes.c_float),   # mean
            ctypes.POINTER(ctypes.c_float),   # std
            ctypes.POINTER(ctypes.c_ubyte),   # hflip or None
            ctypes.c_int,                     # fast_dct
            ctypes.POINTER(ctypes.c_float),   # out
            ctypes.c_int,                     # n_threads
        ]
        lib.decode_resize_batch_u8.restype = ctypes.c_int
        lib.decode_resize_batch_u8.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),  # paths
            ctypes.c_int,                     # n
            ctypes.c_int,                     # resize_short
            ctypes.c_int,                     # crop
            ctypes.POINTER(ctypes.c_ubyte),   # hflip or None
            ctypes.c_int,                     # fast_dct
            ctypes.POINTER(ctypes.c_ubyte),   # out
            ctypes.c_int,                     # n_threads
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def _checked_lib():
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"fastimage native library unavailable: {BUILD_ERROR}")
    return lib


def _args(paths, hflip, crop):
    """The C path array and flip flags (each kept alive by the caller
    while the call runs), after checking sizes."""
    if crop < 1:
        raise ValueError(f"crop must be positive, got {crop}")
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    flags = None
    if hflip is not None:
        flags = np.ascontiguousarray(hflip, np.uint8)
        if flags.shape != (n,):
            raise ValueError(f"hflip has shape {flags.shape}, expected ({n},)")
    return n, c_paths, flags


def _flag_ptr(flags):
    return None if flags is None else flags.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))


def _raise_on_failures(failed: int, n: int) -> None:
    if failed:
        raise RuntimeError(f"fastimage failed to decode {failed} of {n} images")


def decode_batch(
    paths: list[str],
    resize_short: int = 256,
    crop: int = 224,
    mean=(0.485, 0.456, 0.406),
    std=(0.229, 0.224, 0.225),
    hflip: np.ndarray | None = None,
    fast_dct: bool = False,
    n_threads: int = 16,
) -> np.ndarray:
    """JPEG/PNG paths → (n, crop, crop, 3) float32 normalised NHWC.
    Raises if an image does not decode."""
    lib = _checked_lib()
    n, c_paths, flags = _args(paths, hflip, crop)
    out = np.empty((n, crop, crop, 3), np.float32)
    c_mean = (ctypes.c_float * 3)(*[float(m) for m in mean])
    c_std = (ctypes.c_float * 3)(*[float(s) for s in std])
    failed = lib.decode_resize_batch(
        c_paths, n, resize_short, crop, c_mean, c_std, _flag_ptr(flags),
        1 if fast_dct else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads,
    )
    _raise_on_failures(failed, n)
    return out


def decode_batch_u8(
    paths: list[str],
    resize_short: int = 256,
    crop: int = 224,
    hflip: np.ndarray | None = None,
    fast_dct: bool = False,
    n_threads: int = 16,
) -> np.ndarray:
    """JPEG/PNG paths → (n, crop, crop, 3) uint8 NHWC, not normalised
    (the uint8_transfer feed: the resampled 0..255 image rounded half to
    even in C++). Raises if an image does not decode."""
    lib = _checked_lib()
    n, c_paths, flags = _args(paths, hflip, crop)
    out = np.empty((n, crop, crop, 3), np.uint8)
    failed = lib.decode_resize_batch_u8(
        c_paths, n, resize_short, crop, _flag_ptr(flags), 1 if fast_dct else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), n_threads,
    )
    _raise_on_failures(failed, n)
    return out
