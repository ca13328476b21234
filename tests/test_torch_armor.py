"""The port's base85 armour (``ps_pytorch_tpu_torch/utils/armor.py``)
against the stdlib and the JAX package's ``utils/armor.py``, on the CPU.

The wire's text must be byte-equal across the two packages (a payload
armoured by either reads in the other), so encode and decode are held to
``base64`` and to the JAX module at sizes around the vectorisation cut
(``_SMALL``) and at every padding of a 4-byte group (encode) and a
5-character group (decode); malformed text raises ``WireCorrupt`` with the
stdlib's message.
"""

import base64

import numpy as np
import pytest

from ps_pytorch_tpu.utils import armor as jax_armor
from ps_pytorch_tpu_torch.utils import armor
from test_torch_train import two_torch_threads  # noqa: F401

SIZES = sorted({0, 1, 3, 4, 5, 7, 64, 509, 510, 511, 512, 513, 514, 515,
                516, 517, 1024, 4099, 65536 + 3})


def _bytes(n, seed=0):
    return np.random.default_rng(seed + n).integers(
        0, 256, n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("n", SIZES)
def test_encode_equals_stdlib_and_jax(n):
    data = _bytes(n)
    got = armor.b85encode(data)
    assert got == base64.b85encode(data) == jax_armor.b85encode(data)
    # Other bytes-like inputs: a bytearray and a numpy buffer.
    assert armor.b85encode(bytearray(data)) == got
    assert armor.b85encode(np.frombuffer(data, np.uint8)) == got


@pytest.mark.parametrize("n", SIZES)
def test_decode_round_trips_and_equals_jax(n):
    data = _bytes(n, seed=1)
    text = base64.b85encode(data)
    assert armor.b85decode(text) == data == jax_armor.b85decode(text)
    assert armor.b85decode(text.decode("ascii")) == data


@pytest.mark.parametrize("pad", range(5))
def test_decode_every_text_padding_around_the_cut(pad):
    """Text lengths 510..514 (and 2, 4, ... below the cut): every n mod 5
    the decoder pads with '~' like the stdlib."""
    for text_len in (armor._SMALL - 2 + pad, 10 + pad, 2 * armor._SMALL + pad):
        if text_len % 5 == 1:
            continue                    # no byte string armours to this length
        n = text_len * 4 // 5
        data = _bytes(n, seed=pad)
        text = base64.b85encode(data)
        assert len(text) == text_len
        assert armor.b85decode(text) == data == jax_armor.b85decode(text)


@pytest.mark.parametrize("n", [100, 2000])
def test_bad_character_raises_the_stdlibs_message(n):
    text = bytearray(base64.b85encode(_bytes(n)))
    text[7] = ord('"')                  # not in the alphabet
    with pytest.raises(ValueError) as want:
        base64.b85decode(bytes(text))
    with pytest.raises(armor.WireCorrupt) as got:
        armor.b85decode(bytes(text))
    assert str(got.value) == str(want.value)
    with pytest.raises(jax_armor.WireCorrupt) as theirs:
        jax_armor.b85decode(bytes(text))
    assert str(theirs.value) == str(got.value)


@pytest.mark.parametrize("n", [100, 2000])
def test_radix_overflow_raises_the_stdlibs_message(n):
    text = bytearray(base64.b85encode(_bytes(n)))
    text[10:15] = b"~~~~~"              # 85**5 - 1 > 2**32 - 1
    with pytest.raises(ValueError) as want:
        base64.b85decode(bytes(text))
    with pytest.raises(armor.WireCorrupt) as got:
        armor.b85decode(bytes(text))
    assert str(got.value) == str(want.value)
    assert "overflow" in str(got.value)


def test_non_ascii_text_is_wire_corruption():
    with pytest.raises(armor.WireCorrupt, match="non-ASCII"):
        armor.b85decode("abcé" * 200)
    assert issubclass(armor.WireCorrupt, ValueError)
