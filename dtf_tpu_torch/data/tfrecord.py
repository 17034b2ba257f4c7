"""TFRecord support (the port of ``dtf_tpu.data.tfrecord``): so far only
the CRC32C (Castagnoli) checksum and TFRecord's masked form of it, which
the serve-log and event-log record codec
(:mod:`dtf_tpu_torch.data.stream.servelog`) frames every record with.
The TFRecord reader and writer are not ported yet.

Table-driven over plain ints: fine for records of a few kilobytes.
"""

from __future__ import annotations

from typing import List, Optional

_CRC_TABLE: Optional[List[int]] = None


def _crc_table() -> List[int]:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (0x82F63B78 ^ (c >> 1)) if c & 1 else (c >> 1)
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    """CRC32C of ``data`` (reflected, initial and final XOR 0xFFFFFFFF)."""
    table = _crc_table()
    c = 0xFFFFFFFF
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC32C: rotated right by 15, plus 0xA282EAD8."""
    c = crc32c(data)
    return ((c >> 15) | (c << 17) & 0xFFFFFFFF) + 0xA282EAD8 & 0xFFFFFFFF


__all__ = ["crc32c", "masked_crc32c"]
