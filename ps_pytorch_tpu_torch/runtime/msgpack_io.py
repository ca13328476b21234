"""The subset of msgpack that the JAX package's checkpoints use.

``flax.serialization.to_bytes`` writes a training state as a msgpack map
whose leaves are numpy arrays, and ``msgpack_restore`` reads it back. This
module writes and reads the same bytes without the ``msgpack`` package:

- maps with str keys, in the order the caller built them (the JAX save
  runs ``jax.device_get`` first, which sorts the keys of every dict; the
  fields of a state keep their declared order);
- str, int, nil and bin;
- ext type 1, a numpy array, and ext type 3, a numpy scalar, both with the
  payload ``packb((shape, dtype.name, raw C-order bytes))``.

Anything else raises ``ValueError``, as do arrays over 2**30 bytes, which
flax splits into chunks. ``packb`` of a tree equals ``to_bytes`` of the
same tree byte for byte.
"""

import struct
from typing import Any

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
MAX_ARRAY_BYTES = 2 ** 30        # flax chunks arrays above this


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _header(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: the fix form below ``fix_max``, else the first of
    the 8/16/32-bit forms (``codes``, None where msgpack has none) that
    holds ``n``."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} is too large for msgpack")


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 128:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32),
                                 (0xCF, ">Q", 1 << 64)):
            if n < limit:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise ValueError(f"int {n} is too large for msgpack")
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31),
                                 (0xD3, ">q", 1 << 63)):
            if n >= -limit:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise ValueError(f"int {n} is too small for msgpack")


def _array_payload(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.fields is not None:
        raise ValueError(f"dtype {a.dtype} cannot be serialized")
    if a.nbytes > MAX_ARRAY_BYTES:
        raise ValueError(f"array of {a.nbytes} bytes: flax would chunk it, "
                         "which this encoder does not do")
    return packb([list(a.shape), a.dtype.name, a.tobytes("C")])


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, (bool, np.bool_)):
        raise ValueError("bool is outside the checkpoint subset")
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _header(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        _header(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _header(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for key, value in obj.items():
            if not isinstance(key, str):
                raise ValueError(f"map key {key!r} is not a str")
            _pack(key, out)
            _pack(value, out)
    elif isinstance(obj, (np.ndarray, np.generic)):
        code = EXT_NDARRAY if isinstance(obj, np.ndarray) else EXT_NPSCALAR
        data = _array_payload(np.asarray(obj))
        n = len(data)
        if n in (1, 2, 4, 8, 16):
            out.append({1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}[n])
        else:
            _header(out, n, None, 0, (0xC7, 0xC8, 0xC9))
        out.append(code)
        out += data
    else:
        raise ValueError(f"{type(obj).__name__} is outside the checkpoint "
                         "subset")


def unpackb(data: bytes) -> Any:
    obj, pos = _unpack(memoryview(data), 0)
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} trailing bytes")
    return obj


def _take(buf: memoryview, pos: int, n: int):
    if pos + n > len(buf):
        raise ValueError("truncated msgpack data")
    return buf[pos:pos + n], pos + n


def _unpack(buf: memoryview, pos: int):
    raw, pos = _take(buf, pos, 1)
    b = raw[0]
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0xA0 <= b <= 0xBF:
        s, pos = _take(buf, pos, b & 0x1F)
        return bytes(s).decode("utf-8"), pos
    if 0x80 <= b <= 0x8F:
        return _unpack_map(buf, pos, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _unpack_array(buf, pos, b & 0x0F)
    if b == 0xC0:
        return None, pos
    ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in ints:
        fmt = ints[b]
        s, pos = _take(buf, pos, struct.calcsize(fmt))
        return struct.unpack(fmt, s)[0], pos
    lens = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I",      # str
            0xC4: ">B", 0xC5: ">H", 0xC6: ">I",      # bin
            0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",  # array, map
            0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}      # ext
    fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if b in lens:
        fmt = lens[b]
        s, pos = _take(buf, pos, struct.calcsize(fmt))
        n = struct.unpack(fmt, s)[0]
    elif b in fixext:
        n = fixext[b]
    else:
        raise ValueError(f"msgpack type byte 0x{b:02x} is outside the "
                         "checkpoint subset")
    if b in (0xD9, 0xDA, 0xDB):
        s, pos = _take(buf, pos, n)
        return bytes(s).decode("utf-8"), pos
    if b in (0xC4, 0xC5, 0xC6):
        s, pos = _take(buf, pos, n)
        return bytes(s), pos
    if b in (0xDC, 0xDD):
        return _unpack_array(buf, pos, n)
    if b in (0xDE, 0xDF):
        return _unpack_map(buf, pos, n)
    code, pos = _take(buf, pos, 1)
    payload, pos = _take(buf, pos, n)
    return _unpack_ext(code[0], bytes(payload)), pos


def _unpack_array(buf: memoryview, pos: int, n: int):
    items = []
    for _ in range(n):
        item, pos = _unpack(buf, pos)
        items.append(item)
    return items, pos


def _unpack_map(buf: memoryview, pos: int, n: int):
    out = {}
    for _ in range(n):
        key, pos = _unpack(buf, pos)
        if not isinstance(key, str):
            raise ValueError(f"map key {key!r} is not a str")
        out[key], pos = _unpack(buf, pos)
    return out, pos


def _unpack_ext(code: int, payload: bytes):
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise ValueError(f"msgpack ext type {code} is outside the "
                         "checkpoint subset")
    shape, dtype_name, raw = unpackb(payload)
    try:
        dtype = np.dtype(dtype_name)
    except TypeError:
        raise ValueError(f"dtype {dtype_name!r} is not readable here")
    a = np.frombuffer(raw, dtype=dtype).reshape(shape)
    return a if code == EXT_NDARRAY else a[()]
