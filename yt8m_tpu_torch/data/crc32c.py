"""CRC32-C (Castagnoli) with the TFRecord masking scheme.

TFRecord framing (reference delegates to TF's C++ RecordReader/RecordWriter):
    uint64 length | uint32 masked_crc32c(length) | bytes data |
    uint32 masked_crc32c(data)

A dependency-free implementation used by the fixture writer and the
pure-Python reader (the oracle and fallback of the native parser,
data/pipeline.py, which checks the same CRCs in C++). A copy of the JAX
package's codec, so that the port imports nothing of that package.
"""

from __future__ import annotations

import struct

_POLY = 0x82F63B78  # reversed Castagnoli polynomial

_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _TABLE.append(_c)

_MASK_DELTA = 0xA282EAD8


def crc32c(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    table = _TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def unmask_crc(masked: int) -> int:
    rot = (masked - _MASK_DELTA) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF


def masked_crc_bytes(data: bytes) -> bytes:
    return struct.pack("<I", masked_crc32c(data))
