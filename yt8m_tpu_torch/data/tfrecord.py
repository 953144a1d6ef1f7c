"""TFRecord container I/O (pure Python, numpy-free).

Framing per record (what TF's C++ RecordWriter emits):
    uint64 little-endian length
    uint32 masked crc32c of the length bytes
    payload bytes
    uint32 masked crc32c of the payload
"""

from __future__ import annotations

import glob as _glob
import os
import struct
from typing import Iterable, Iterator, List, Sequence

from yt8m_tpu_torch.data.crc32c import masked_crc32c, masked_crc_bytes


def tfrecord_iterator(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    """Yield raw record payloads from one TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise IOError(f"{path}: truncated record header")
            (length,) = struct.unpack("<Q", header[:8])
            if verify_crc:
                (len_crc,) = struct.unpack("<I", header[8:12])
                if masked_crc32c(header[:8]) != len_crc:
                    raise IOError(f"{path}: corrupt length crc")
            data = f.read(length)
            if len(data) < length:
                raise IOError(f"{path}: truncated record body")
            footer = f.read(4)
            if verify_crc:
                (data_crc,) = struct.unpack("<I", footer)
                if masked_crc32c(data) != data_crc:
                    raise IOError(f"{path}: corrupt data crc")
            yield data


def write_tfrecords(path: str, records: Iterable[bytes]) -> int:
    """Write records to a TFRecord file; returns the record count."""
    n = 0
    with open(path, "wb") as f:
        for rec in records:
            header = struct.pack("<Q", len(rec))
            f.write(header)
            f.write(masked_crc_bytes(header))
            f.write(rec)
            f.write(masked_crc_bytes(rec))
            n += 1
    return n


def glob_files(pattern: str) -> List[str]:
    """Deterministically ordered file list for a glob pattern (reference:
    train.py uses gfile.Glob on --train_data_pattern)."""
    files = sorted(_glob.glob(os.path.expanduser(pattern)))
    return files


def shard_files(files: Sequence[str], shard: int, num_shards: int) -> List[str]:
    """Static file-level sharding for multi-host input."""
    return list(files[shard::num_shards])
