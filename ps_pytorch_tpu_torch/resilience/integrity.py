"""Wire digests: the first layer of the JAX package's
``resilience/integrity.py`` (``wire_digest`` / ``verify_digest``,
``:35-81``).

Every armoured chunk a channel publishes (``parallel/transport.py``)
carries a CRC token in the version's meta, and readers verify each chunk
before decode. A failed digest demotes that read to "absent this round",
which the staleness machinery upstream already absorbs: counted, never a
crash. The token is crc32c (Castagnoli) when the ``crc32c`` module imports,
else zlib's crc32, the same rule as the JAX package's; the algorithm's name
travels in the token, so a reader built with the other one skips the check
instead of flagging every chunk.

The payload screen, the outlier gate and the quarantine (``GradIntegrity``)
are not ported yet (ROADMAP.md).
"""

import zlib

try:                                    # pragma: no cover - env dependent
    from crc32c import crc32c as _crc_impl
    _CRC_ALGO = "crc32c"
except ImportError:
    _crc_impl = zlib.crc32
    _CRC_ALGO = "crc32"


def wire_digest(data) -> str:
    """``"<algo>:<8 hex digits>"`` over ``data`` (str or bytes-like)."""
    if isinstance(data, str):
        data = data.encode("ascii")
    return f"{_CRC_ALGO}:{_crc_impl(data) & 0xFFFFFFFF:08x}"


def verify_digest(data, token: str) -> bool:
    """True when ``data`` matches ``token``. A token of an unknown
    algorithm verifies True (a writer built with the other CRC is not
    corruption); a malformed token verifies False."""
    algo, sep, hexval = (token or "").partition(":")
    if not sep or len(hexval) != 8:
        return False
    if algo != _CRC_ALGO:
        return True
    if isinstance(data, str):
        data = data.encode("ascii")
    try:
        want = int(hexval, 16)
    except ValueError:
        return False
    return (_crc_impl(data) & 0xFFFFFFFF) == want
