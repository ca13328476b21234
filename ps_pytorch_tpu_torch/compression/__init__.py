"""Gradient/weight compression: the JAX package's ``compression/__init__.py``
(``g_compress``/``g_decompress``/``w_compress``/``w_decompress``) with the
same ``PSC1`` container, byte for byte.

Self-describing container: a small header records dtype, shape, codec and
shuffle flag, so decompress needs no side channel. The heavy lifting is the
native C++ library (``native/codec.cpp``: byte-shuffle + zstd through
ctypes, built by ``make -C native libpscodec.so`` when absent); where the
library is missing and cannot be built, numpy byte-shuffle + zlib keeps the
API working. Containers declare their codec, and each side reads both. This
is a host codec by contract (checkpoint blobs and the ``blosc`` gradient
codec of the asynchronous path), not a stand-in for a device kernel.
"""

import ctypes
import os
import struct
import subprocess
import threading
import zlib
from typing import Optional

import numpy as np

_MAGIC = b"PSC1"
_CODEC_ZSTD = 1
_CODEC_ZLIB = 2

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_SO_NAME = "libpscodec.so"

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False
_lock = threading.Lock()


def _configure_codec(lib: ctypes.CDLL) -> None:
    lib.psc_compress.restype = ctypes.c_longlong
    lib.psc_decompress.restype = ctypes.c_longlong
    lib.psc_max_compressed_size.restype = ctypes.c_size_t
    lib.psc_max_compressed_size.argtypes = [ctypes.c_size_t]


def _load_native() -> Optional[ctypes.CDLL]:
    """The codec library, built with its own make target when absent; None
    means the zlib path."""
    global _lib, _lib_tried
    with _lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        so = os.path.join(NATIVE_DIR, _SO_NAME)
        try:
            if not os.path.exists(so):
                subprocess.run(["make", "-C", NATIVE_DIR, _SO_NAME],
                               capture_output=True, timeout=120, check=True)
            lib = ctypes.CDLL(so)
            _configure_codec(lib)
            _lib = lib
        except (OSError, AttributeError, subprocess.SubprocessError):
            _lib = None
        return _lib


def codec_name() -> str:
    """The codec new containers are written with: ``zstd`` or ``zlib``."""
    return "zstd" if have_native() else "zlib"


def have_native() -> bool:
    return _load_native() is not None


def _pack_header(dtype: np.dtype, shape: tuple, codec: int, shuffle: bool) -> bytes:
    dt = dtype.str.encode()  # e.g. b'<f4'
    hdr = struct.pack("<4sBBB", _MAGIC, codec, 1 if shuffle else 0, len(dt))
    hdr += dt + struct.pack("<B", len(shape))
    hdr += struct.pack(f"<{len(shape)}q", *shape)
    return hdr


def _unpack_header(buf: bytes):
    magic, codec, shuffle, dtlen = struct.unpack_from("<4sBBB", buf, 0)
    if magic != _MAGIC:
        raise ValueError("not a PSC container")
    off = 7
    dt = buf[off:off + dtlen].decode()
    off += dtlen
    (ndim,) = struct.unpack_from("<B", buf, off)
    off += 1
    shape = struct.unpack_from(f"<{ndim}q", buf, off)
    off += 8 * ndim
    return codec, bool(shuffle), np.dtype(dt), shape, off


def compress(arr: np.ndarray, level: int = 3, shuffle: bool = True) -> bytes:
    """numpy array -> self-describing compressed bytes."""
    orig_shape = np.asarray(arr).shape  # ascontiguousarray promotes 0-d to 1-d
    arr = np.ascontiguousarray(arr)
    n = arr.nbytes
    lib = _load_native()
    if lib is not None:
        cap = lib.psc_max_compressed_size(n)
        dst = np.empty(cap, np.uint8)
        scratch = np.empty(n, np.uint8) if shuffle else np.empty(0, np.uint8)
        src = arr.tobytes()  # contiguous byte view
        r = lib.psc_compress(src, n, arr.dtype.itemsize, level,
                             1 if shuffle else 0,
                             dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                             cap,
                             scratch.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if r > 0:
            return _pack_header(arr.dtype, orig_shape, _CODEC_ZSTD, shuffle) + dst[:r].tobytes()
    # Pure-python fallback: numpy byte-shuffle + zlib.
    data = arr.tobytes()
    if shuffle and arr.dtype.itemsize > 1:
        b = np.frombuffer(data, np.uint8)
        usable = (n // arr.dtype.itemsize) * arr.dtype.itemsize
        shuf = b[:usable].reshape(-1, arr.dtype.itemsize).T.tobytes() + b[usable:].tobytes()
        data = shuf
    return _pack_header(arr.dtype, orig_shape, _CODEC_ZLIB, shuffle) + zlib.compress(data, min(level, 9))


def decompress(buf: bytes) -> np.ndarray:
    codec, shuffle, dtype, shape, off = _unpack_header(buf)
    payload = buf[off:]
    n = int(np.prod(shape)) * dtype.itemsize if shape else dtype.itemsize
    n = max(n, dtype.itemsize) if not shape else n
    if codec == _CODEC_ZSTD:
        lib = _load_native()
        if lib is None:
            raise RuntimeError("zstd container but native codec unavailable; "
                               "run `make -C native`")
        dst = np.empty(max(n, 1), np.uint8)
        scratch = np.empty(max(n, 1), np.uint8) if shuffle else np.empty(0, np.uint8)
        r = lib.psc_decompress(payload, len(payload), dtype.itemsize,
                               1 if shuffle else 0,
                               dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                               n,
                               scratch.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if r < 0:
            raise ValueError("corrupt zstd container")
        data = dst[:n].tobytes()
    elif codec == _CODEC_ZLIB:
        data = zlib.decompress(payload)
        if shuffle and dtype.itemsize > 1:
            b = np.frombuffer(data, np.uint8)
            count = n // dtype.itemsize
            usable = count * dtype.itemsize
            unshuf = np.empty(n, np.uint8)
            unshuf[:usable] = b[:usable].reshape(dtype.itemsize, count).T.reshape(-1)
            unshuf[usable:] = b[usable:]
            data = unshuf.tobytes()
    else:
        raise ValueError(f"unknown codec id {codec}")
    return np.frombuffer(data, dtype)[: int(np.prod(shape)) if shape else 1].reshape(shape)


# ---- the reference's API surface ----

def g_compress(grad: np.ndarray, level: int = 3) -> bytes:
    return compress(np.asarray(grad), level=level)


def g_decompress(msg: bytes) -> np.ndarray:
    return decompress(msg)


def w_compress(w: np.ndarray, level: int = 3) -> bytes:
    return compress(np.asarray(w), level=level)


def w_decompress(msg: bytes) -> np.ndarray:
    return decompress(msg)
