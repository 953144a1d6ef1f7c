"""Minimal protobuf wire-format codec for tf.Example / tf.SequenceExample.

The reference (readers.py :: YT8MAggregatedFeatureReader /
YT8MFrameFeatureReader) parses these protos through TF's C++ ops
(`parse_example`, `parse_single_sequence_example`). We keep the runtime free
of a TensorFlow dependency: this module implements exactly the subset of the
proto3 wire format those messages use.

Message schemas (from tensorflow/core/example/example.proto,
feature.proto — stable public format):

    Example          { Features features = 1; }
    SequenceExample  { Features context = 1; FeatureLists feature_lists = 2; }
    Features         { map<string, Feature> feature = 1; }
    FeatureLists     { map<string, FeatureList> feature_list = 1; }
    FeatureList      { repeated Feature feature = 1; }
    Feature          { oneof: BytesList bytes_list = 1;
                              FloatList float_list = 2;
                              Int64List int64_list = 3; }
    BytesList        { repeated bytes value = 1; }
    FloatList        { repeated float value = 1 [packed]; }
    Int64List        { repeated int64 value = 1 [packed]; }

A decoded Feature is a ``(kind, values)`` tuple with kind in
{"bytes", "float", "int64"}.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

Feature = Tuple[str, list]

# ---------------------------------------------------------------------------
# varint / wire primitives
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a serialized message.

    value is int for varint/fixed, bytes for length-delimited.
    """
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            val = buf[pos : pos + length]
            pos += length
        elif wire == 5:  # 32-bit
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


def _decode_feature(buf: bytes) -> Feature:
    for field, wire, val in _iter_fields(buf):
        if field == 1:  # BytesList
            values = [v for f, w, v in _iter_fields(val) if f == 1]
            return ("bytes", values)
        if field == 2:  # FloatList
            floats: List[float] = []
            for f, w, v in _iter_fields(val):
                if f != 1:
                    continue
                if w == 2:  # packed
                    floats.extend(
                        struct.unpack(f"<{len(v) // 4}f", v)
                    )
                else:  # unpacked 32-bit
                    floats.append(struct.unpack("<f", struct.pack("<I", v))[0])
            return ("float", floats)
        if field == 3:  # Int64List
            ints: List[int] = []
            for f, w, v in _iter_fields(val):
                if f != 1:
                    continue
                if w == 2:  # packed varints
                    p = 0
                    while p < len(v):
                        x, p = _read_varint(v, p)
                        ints.append(x - (1 << 64) if x >= 1 << 63 else x)
                else:
                    ints.append(val - (1 << 64) if val >= 1 << 63 else val)
            return ("int64", ints)
    return ("bytes", [])  # empty Feature


def _decode_features(buf: bytes) -> Dict[str, Feature]:
    out: Dict[str, Feature] = {}
    for field, _w, entry in _iter_fields(buf):
        if field != 1:
            continue
        key, feat = b"", ("bytes", [])
        for f, _ww, v in _iter_fields(entry):
            if f == 1:
                key = v
            elif f == 2:
                feat = _decode_feature(v)
        out[key.decode("utf-8")] = feat
    return out


def decode_example(buf: bytes) -> Dict[str, Feature]:
    """tf.Example bytes -> {name: (kind, values)}."""
    for field, _w, val in _iter_fields(buf):
        if field == 1:
            return _decode_features(val)
    return {}


def decode_sequence_example(
    buf: bytes,
) -> Tuple[Dict[str, Feature], Dict[str, List[Feature]]]:
    """tf.SequenceExample bytes -> (context, feature_lists)."""
    context: Dict[str, Feature] = {}
    feature_lists: Dict[str, List[Feature]] = {}
    for field, _w, val in _iter_fields(buf):
        if field == 1:
            context = _decode_features(val)
        elif field == 2:
            for f, _ww, entry in _iter_fields(val):
                if f != 1:
                    continue
                key, feats = b"", []
                for ff, _www, v in _iter_fields(entry):
                    if ff == 1:
                        key = v
                    elif ff == 2:  # FeatureList
                        feats = [
                            _decode_feature(fv)
                            for f3, _w3, fv in _iter_fields(v)
                            if f3 == 1
                        ]
                feature_lists[key.decode("utf-8")] = feats
    return context, feature_lists


# ---------------------------------------------------------------------------
# encoding (fixture writer; parity-checked against TF in tests)
# ---------------------------------------------------------------------------


def _encode_len_delimited(out: bytearray, field: int, payload: bytes) -> None:
    _write_varint(out, (field << 3) | 2)
    _write_varint(out, len(payload))
    out.extend(payload)


def _encode_feature(feat: Feature) -> bytes:
    kind, values = feat
    inner = bytearray()
    if kind == "bytes":
        for v in values:
            _encode_len_delimited(inner, 1, v)
        field = 1
    elif kind == "float":
        packed = struct.pack(f"<{len(values)}f", *values)
        _encode_len_delimited(inner, 1, packed)
        field = 2
    elif kind == "int64":
        packed = bytearray()
        for v in values:
            _write_varint(packed, v & ((1 << 64) - 1))
        _encode_len_delimited(inner, 1, bytes(packed))
        field = 3
    else:
        raise ValueError(f"unknown feature kind {kind!r}")
    out = bytearray()
    _encode_len_delimited(out, field, bytes(inner))
    return bytes(out)


def _encode_features(features: Dict[str, Feature]) -> bytes:
    out = bytearray()
    for name, feat in features.items():
        entry = bytearray()
        _encode_len_delimited(entry, 1, name.encode("utf-8"))
        _encode_len_delimited(entry, 2, _encode_feature(feat))
        _encode_len_delimited(out, 1, bytes(entry))
    return bytes(out)


def encode_example(features: Dict[str, Feature]) -> bytes:
    out = bytearray()
    _encode_len_delimited(out, 1, _encode_features(features))
    return bytes(out)


def encode_sequence_example(
    context: Dict[str, Feature],
    feature_lists: Dict[str, List[Feature]],
) -> bytes:
    out = bytearray()
    _encode_len_delimited(out, 1, _encode_features(context))
    fl = bytearray()
    for name, feats in feature_lists.items():
        entry = bytearray()
        _encode_len_delimited(entry, 1, name.encode("utf-8"))
        lst = bytearray()
        for feat in feats:
            _encode_len_delimited(lst, 1, _encode_feature(feat))
        _encode_len_delimited(entry, 2, bytes(lst))
        _encode_len_delimited(fl, 1, bytes(entry))
    _encode_len_delimited(out, 2, bytes(fl))
    return bytes(out)
