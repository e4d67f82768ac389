"""Record framing for the commit log — CRC32-framed, length-prefixed (a
copy of kafka_ps_tpu/log/records.py: the two packages' logs share bytes).

On-disk layout of one record (little-endian, like `runtime/serde.py`):

    +--------+---------+--------+----------------+
    | offset | length  | crc32  | payload bytes  |
    |  i64   |  u32    |  u32   | `length` bytes |
    +--------+---------+--------+----------------+

The offset is the record's logical position in its partition (stored
redundantly so a segment is self-describing — an index file can be
rebuilt from the .log alone).  The CRC covers offset + length + payload,
so a corrupted header is detected too, not just a corrupted body.
Kafka's v0 message set used the same shape (offset, size, crc, payload).

`scan` implements the recovery rule every restart runs on the last
segment: the longest valid prefix is the log; the first truncated or
CRC-corrupt record and everything after it is discarded (the bytes a
crash left half-written were never acknowledged, so dropping them is
correct, not lossy).
"""

from __future__ import annotations

import struct
import zlib

_PREFIX = struct.Struct("<qI")        # offset, payload length
_CRC = struct.Struct("<I")
HEADER_SIZE = _PREFIX.size + _CRC.size

# backstop against reading an absurd length out of a corrupt header and
# allocating it: no control-plane message is remotely this large
MAX_RECORD_BYTES = 64 * 1024 * 1024


def pack_record(offset: int, payload: bytes) -> bytes:
    prefix = _PREFIX.pack(offset, len(payload))
    crc = zlib.crc32(payload, zlib.crc32(prefix))
    return prefix + _CRC.pack(crc) + payload


def unpack_record(buf: bytes, pos: int) -> tuple[int, bytes, int] | None:
    """(offset, payload, next_pos) for the record at `pos`, or None if
    the bytes from `pos` are not a complete, CRC-valid record (the
    truncated/corrupt tail case — callers discard from `pos` on)."""
    if pos + HEADER_SIZE > len(buf):
        return None
    offset, length = _PREFIX.unpack_from(buf, pos)
    if length > MAX_RECORD_BYTES or offset < 0:
        return None
    end = pos + HEADER_SIZE + length
    if end > len(buf):
        return None
    (stored_crc,) = _CRC.unpack_from(buf, pos + _PREFIX.size)
    payload = buf[pos + HEADER_SIZE:end]
    crc = zlib.crc32(payload, zlib.crc32(buf[pos:pos + _PREFIX.size]))
    if crc != stored_crc:
        return None
    return offset, bytes(payload), end


def peek_header(buf: bytes, pos: int) -> tuple[int, int] | None:
    """(offset, payload_length) from the 16-byte header at `pos`, or
    None if the header is truncated or obviously corrupt.  Does NOT
    verify the CRC — this is the cheap skip-scan primitive positioned
    point reads (`LogSegment.read_at`) use to hop record-to-record from
    an index floor without touching payload bytes; the target record
    itself is always CRC-verified via `unpack_record`."""
    if pos + HEADER_SIZE > len(buf):
        return None
    offset, length = _PREFIX.unpack_from(buf, pos)
    if length > MAX_RECORD_BYTES or offset < 0:
        return None
    return offset, length


def scan(buf: bytes, pos: int = 0):
    """Yield (offset, payload, record_pos) for the valid record prefix
    of `buf` starting at `pos`; stops at the first invalid record."""
    while True:
        rec = unpack_record(buf, pos)
        if rec is None:
            return
        offset, payload, next_pos = rec
        yield offset, payload, pos
        pos = next_pos


def valid_length(buf: bytes, pos: int = 0) -> int:
    """Byte length of the valid record prefix — the truncation point
    recovery resets a crashed segment file to."""
    for _, payload, rec_pos in scan(buf, pos):
        pos = rec_pos + HEADER_SIZE + len(payload)
    return pos
