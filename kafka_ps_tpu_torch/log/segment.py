"""One commit-log segment (a copy of kafka_ps_tpu/log/segment.py): an
append-only .log file plus a sparse offset index, named by base offset
like Kafka's on-disk layout:

    00000000000000000042.log      records 42, 43, ... (records.py framing)
    00000000000000000042.index    sparse (offset, file_position) pairs

The index holds one entry per ~`index_interval_bytes` of log, so a seek
to offset N is: binary-search the index for the floor entry, then scan
forward at most one interval.  The index is a derived structure — on
open it is validated against the recovered .log and rebuilt from it if
stale or missing, so index corruption can never lose records.
"""

from __future__ import annotations

import bisect
import os
import struct

from kafka_ps_tpu_torch.log import records

_INDEX_ENTRY = struct.Struct("<qq")        # offset, file position


def segment_basename(base_offset: int) -> str:
    return f"{base_offset:020d}"


class LogSegment:
    """Append + offset-addressed read over one segment file."""

    def __init__(self, directory: str, base_offset: int,
                 index_interval_bytes: int = 4096):
        self.directory = directory
        self.base_offset = base_offset
        self.index_interval_bytes = index_interval_bytes
        os.makedirs(directory, exist_ok=True)
        base = os.path.join(directory, segment_basename(base_offset))
        self.log_path = base + ".log"
        self.index_path = base + ".index"
        # sparse index, kept in memory and mirrored to the .index file
        self._index: list[tuple[int, int]] = []
        self._bytes_since_index = 0
        self.next_offset = base_offset
        self.size = 0
        self.truncated_bytes = 0      # corrupt tail discarded on recovery
        self._recover()
        self._fh = open(self.log_path, "ab")
        self._index_fh = open(self.index_path, "ab")

    # -- recovery ----------------------------------------------------------

    def _recover(self) -> None:
        """Scan the .log, truncate a corrupt/torn tail (records.py scan
        rule), and rebuild the sparse index from the surviving records."""
        if not os.path.exists(self.log_path):
            open(self.log_path, "wb").close()
            open(self.index_path, "wb").close()
            return
        with open(self.log_path, "rb") as fh:
            buf = fh.read()
        valid = records.valid_length(buf)
        self.truncated_bytes = len(buf) - valid
        if valid < len(buf):
            with open(self.log_path, "r+b") as fh:
                fh.truncate(valid)
            buf = buf[:valid]
        self.size = valid
        since = 0
        for offset, payload, pos in records.scan(buf):
            if pos == 0 or since >= self.index_interval_bytes:
                self._index.append((offset, pos))
                since = 0
            since += records.HEADER_SIZE + len(payload)
            self.next_offset = offset + 1
        self._bytes_since_index = since
        # the .index is derived: rewrite it to match the recovered log
        with open(self.index_path, "wb") as fh:
            for entry in self._index:
                fh.write(_INDEX_ENTRY.pack(*entry))

    # -- append ------------------------------------------------------------

    def append(self, payload: bytes) -> int:
        offset = self.next_offset
        rec = records.pack_record(offset, payload)
        if self._bytes_since_index >= self.index_interval_bytes \
                or self.size == 0:
            self._index.append((offset, self.size))
            self._index_fh.write(_INDEX_ENTRY.pack(offset, self.size))
            self._bytes_since_index = 0
        self._fh.write(rec)
        self.size += len(rec)
        self._bytes_since_index += len(rec)
        self.next_offset = offset + 1
        return offset

    def flush(self, sync: bool = False) -> None:
        self._fh.flush()
        if sync:
            os.fsync(self._fh.fileno())

    def close(self) -> None:
        self._fh.close()
        self._index_fh.close()

    # -- read --------------------------------------------------------------

    def seek_position(self, offset: int) -> int:
        """File position of the index floor entry for `offset` — the
        sparse seek: at most one index interval of records is scanned
        past this position."""
        if not self._index:
            return 0
        i = bisect.bisect_right([o for o, _ in self._index], offset) - 1
        return self._index[max(i, 0)][1]

    def read_from(self, offset: int):
        """Yield (offset, payload) for records with offset >= `offset`.
        Reads through a fresh handle so concurrent appends (from the
        owning writer thread) can't interleave with the scan."""
        self._fh.flush()
        with open(self.log_path, "rb") as fh:
            fh.seek(self.seek_position(offset))
            buf = fh.read()
        for rec_offset, payload, _ in records.scan(buf):
            if rec_offset >= offset:
                yield rec_offset, payload

    def read_at(self, offset: int) -> bytes:
        """CRC-verified point read of the single record at `offset`.

        The positioned-read primitive a tiered store's cold tier is
        built on: binary-search the sparse index for
        the floor position, then hop header-to-header (records.py
        `peek_header` — 16 bytes per hop, no payload reads) until the
        target record, and CRC-verify only that one.  At most one
        `index_interval_bytes` of headers is walked.

        Raises KeyError if `offset` is outside the segment's recovered
        range or the record at it fails CRC — a torn tail past the
        recovery point is "not present", never garbage bytes.
        """
        if not self.base_offset <= offset < self.next_offset:
            raise KeyError(offset)
        self._fh.flush()
        with open(self.log_path, "rb") as fh:
            pos = self.seek_position(offset)
            while True:
                fh.seek(pos)
                header = fh.read(records.HEADER_SIZE)
                peeked = records.peek_header(header, 0)
                if peeked is None:
                    raise KeyError(offset)        # torn/corrupt tail
                rec_offset, length = peeked
                if rec_offset > offset:
                    raise KeyError(offset)        # hole: offset skipped
                if rec_offset == offset:
                    rec = records.unpack_record(
                        header + fh.read(length), 0)
                    if rec is None:
                        raise KeyError(offset)    # CRC mismatch
                    return rec[1]
                pos += records.HEADER_SIZE + length

    def delete(self) -> None:
        self.close()
        for p in (self.log_path, self.index_path):
            if os.path.exists(p):
                os.remove(p)
