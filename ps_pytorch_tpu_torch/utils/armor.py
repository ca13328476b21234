"""Vectorised base85 armouring: the JAX package's ``utils/armor.py``,
byte for byte ``base64.b85encode`` / ``b85decode``.

The KV wire (``parallel/transport.py``) ships every payload as ASCII text,
because the store's values are strings to the JAX package's coordination
service. CPython's ``base64`` does the radix-85 arithmetic in a Python loop
over 4-byte groups; these functions do it on whole numpy arrays, with the
same alphabet, the same zero-pad-then-truncate framing on encode and the
same ``~``-pad on decode, so that text armoured by either package reads in
the other.

Inputs below ``_SMALL`` bytes, non-alphabet characters and radix overflow
go to :mod:`base64`. Malformed text raises :class:`WireCorrupt`, a
``ValueError`` carrying the stdlib's message, so that the wire can count a
decode failure as corruption.
"""

import base64

import numpy as np


class WireCorrupt(ValueError):
    """Armoured wire text failed to decode (bad character, radix overflow,
    non-ASCII, or torn framing)."""


# base64._b85alphabet, spelled out rather than imported (a private name).
_ALPHABET = (b"0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
             b"abcdefghijklmnopqrstuvwxyz!#$%&()*+-;<=>?@^_`{|}~")
_ENC = np.frombuffer(_ALPHABET, np.uint8)
_DEC = np.full(256, 0xFF, np.uint8)
_DEC[np.frombuffer(_ALPHABET, np.uint8)] = np.arange(85, dtype=np.uint8)
_PAD = ord("~")  # decode pads the text with '~' (digit 84), as the stdlib

# Below this the numpy round trips cost more than the stdlib's loop.
_SMALL = 512


def _delegate_decode(data) -> bytes:
    try:
        return base64.b85decode(data)
    except ValueError as e:
        raise WireCorrupt(str(e)) from e


def b85encode(data) -> bytes:
    """``base64.b85encode(data)``, vectorised. Takes any bytes-like."""
    if not isinstance(data, (bytes, bytearray)):
        data = memoryview(data).tobytes()
    n = len(data)
    if n < _SMALL:
        return base64.b85encode(data)
    padding = (-n) % 4
    buf = np.frombuffer(data, np.uint8)
    if padding:
        buf = np.concatenate([buf, np.zeros(padding, np.uint8)])
    words = buf.view(">u4").astype(np.uint32)
    out = np.empty((words.size, 5), np.uint8)
    for i in range(4, -1, -1):
        out[:, i] = _ENC[words % 85]
        words = words // 85
    text = out.tobytes()
    return text[:-padding] if padding else text


def b85decode(data) -> bytes:
    """``base64.b85decode(data)``, vectorised. Takes str or bytes-like;
    malformed text raises :class:`WireCorrupt` with the stdlib's
    message."""
    if isinstance(data, str):
        try:
            data = data.encode("ascii")
        except UnicodeEncodeError as e:
            raise WireCorrupt(f"non-ASCII armoured text: {e}") from e
    elif not isinstance(data, (bytes, bytearray)):
        data = memoryview(data).tobytes()
    n = len(data)
    if n < _SMALL:
        return _delegate_decode(data)
    padding = (-n) % 5
    arr = np.frombuffer(data, np.uint8)
    if padding:
        arr = np.concatenate([arr, np.full(padding, _PAD, np.uint8)])
    digits = _DEC[arr]
    if (digits == 0xFF).any():
        return _delegate_decode(data)  # the stdlib's bad-character message
    g = digits.reshape(-1, 5)
    acc = g[:, 0].astype(np.uint64)
    for i in range(1, 5):
        acc *= 85
        acc += g[:, i]
    if (acc > 0xFFFFFFFF).any():
        return _delegate_decode(data)  # the stdlib's overflow message
    raw = acc.astype(">u4").tobytes()
    return raw[:-padding] if padding else raw
