"""Host-side wire format of the compressed codecs (counterpart of
kafka_ps_tpu/compress/wire.py, a copy: numpy only, byte for byte the
same packing, so both packages read each other's frames).

The device-side encode/decode lives in compress/codecs.py; both share
the codec ids and the CodecSpec identity defined here.

Codec table (codec id, wire parts, asymptotic ratio vs raw f32):

  0 none   — never appears on the wire (plain f32 frames)
  1 bf16   — <u16 bits[n]>                               2x
  2 int8   — <f4 scales[ceil(n/256)]> <i1 q[n]>, then a  ~4x + zlib
             lossless zlib stage over the whole blob
             (flag bit 0; raw fallback when zlib grows it)
  3 topk:R — <i4 idx[k]> <f4 vals[k]>, k = max(1, R*n)   ~1/(2R)

Pack/unpack are exact inverses: the receiver reconstructs the sender's
encoded parts bit for bit, so decoding on either side yields the same
float32 values, the invariant the error-feedback residuals
(compress/feedback.py) rely on.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np

CODEC_NONE = 0
CODEC_BF16 = 1
CODEC_INT8 = 2
# topk parts are (indices, values) over the full key space
CODEC_TOPK = 3

_CODEC_NAMES = {CODEC_NONE: "none", CODEC_BF16: "bf16",
                CODEC_INT8: "int8", CODEC_TOPK: "topk"}

# int8 quantization granularity: one f32 scale per 256-value chunk
INT8_CHUNK = 256
# lossless stage over the int8 blob (the QSGD entropy-coding analogue,
# Alistarh et al. 2017 §3.3): quantized deltas cluster near zero, so a
# cheap deflate pass is what carries the codec past the 4x bound that
# raw int8+scales can never reach (4n / (n + scales) < 4)
_ZLIB_LEVEL = 6
FLAG_ZLIB = 1


@dataclasses.dataclass(frozen=True)
class CodecSpec:
    """Codec identity: id + one f32 parameter (the top-k ratio; 0 for
    the parameter-free codecs).  `param` is canonicalized through
    float32 so a spec parsed locally compares equal to one that crossed
    a wire as <f4>."""

    codec_id: int
    param: float = 0.0

    def __post_init__(self):
        if self.codec_id not in _CODEC_NAMES:
            raise ValueError(f"unknown codec id {self.codec_id}")
        object.__setattr__(self, "param", float(np.float32(self.param)))
        if self.codec_id == CODEC_TOPK and not 0.0 < self.param <= 1.0:
            raise ValueError(
                f"topk ratio must be in (0, 1], got {self.param}")

    @property
    def name(self) -> str:
        return _CODEC_NAMES[self.codec_id]

    def spec_str(self) -> str:
        """The `--compress` flag form this spec round-trips from."""
        if self.codec_id == CODEC_TOPK:
            return f"topk:{self.param:g}"
        return self.name


NONE = CodecSpec(CODEC_NONE)


def parse_codec(spec: str | None) -> CodecSpec:
    """Parse a `--compress` value: none | bf16 | int8 | topk:<ratio>."""
    if spec is None or spec == "" or spec == "none":
        return NONE
    if spec == "bf16":
        return CodecSpec(CODEC_BF16)
    if spec == "int8":
        return CodecSpec(CODEC_INT8)
    if spec.startswith("topk:"):
        try:
            ratio = float(spec[len("topk:"):])
        except ValueError:
            raise ValueError(f"bad topk ratio in {spec!r}") from None
        return CodecSpec(CODEC_TOPK, ratio)
    raise ValueError(
        f"unknown codec {spec!r} (expected none, bf16, int8 or topk:R)")


def topk_k(param: float, n: int) -> int:
    """The static k of a topk:R codec over an n-vector."""
    return max(1, min(n, int(round(param * n))))


def int8_chunks(n: int) -> int:
    return -(-n // INT8_CHUNK)


# -- pack / unpack -----------------------------------------------------------

def pack_parts(codec_id: int, parts, n: int) -> tuple[int, int, bytes]:
    """Encoded parts (host arrays) of an n-vector -> (flags, aux, blob).
    `aux` is the codec's shape word (k for topk, chunk count for int8,
    0 for bf16) so unpack needs nothing beyond the frame's KeyRange."""
    if codec_id == CODEC_BF16:
        (bits,) = parts
        return 0, 0, np.ascontiguousarray(bits, dtype="<u2").tobytes()
    if codec_id == CODEC_INT8:
        q, scales = parts
        scales = np.ascontiguousarray(scales, dtype="<f4")
        # the padded tail of q is exactly zero (zero input quantizes to
        # zero) — trim it to n bytes; unpack re-pads
        q = np.ascontiguousarray(q, dtype=np.int8)[:n]
        nchunks = len(scales)
        blob = scales.tobytes() + q.tobytes()
        comp = zlib.compress(blob, _ZLIB_LEVEL)
        if len(comp) < len(blob):
            return FLAG_ZLIB, nchunks, comp
        return 0, nchunks, blob
    if codec_id == CODEC_TOPK:
        idx, vals = parts
        idx = np.ascontiguousarray(idx, dtype="<i4")
        vals = np.ascontiguousarray(vals, dtype="<f4")
        return 0, len(idx), idx.tobytes() + vals.tobytes()
    raise ValueError(f"cannot pack codec id {codec_id}")


def unpack_parts(codec_id: int, flags: int, aux: int, blob, n: int):
    """(flags, aux, blob) -> the sender's encoded parts, bit-exact.
    `blob` may be any bytes-like (memoryview payloads included)."""
    if codec_id == CODEC_BF16:
        return (np.frombuffer(blob, dtype="<u2", count=n),)
    if codec_id == CODEC_INT8:
        if flags & FLAG_ZLIB:
            blob = zlib.decompress(blob)
        nchunks = aux
        scales = np.frombuffer(blob, dtype="<f4", count=nchunks)
        stored = len(blob) - 4 * nchunks
        q = np.zeros(nchunks * INT8_CHUNK, dtype=np.int8)
        q[:stored] = np.frombuffer(blob, dtype=np.int8, count=stored,
                                   offset=4 * nchunks)
        return q, scales
    if codec_id == CODEC_TOPK:
        idx = np.frombuffer(blob, dtype="<i4", count=aux)
        vals = np.frombuffer(blob, dtype="<f4", count=aux, offset=4 * aux)
        return idx, vals
    raise ValueError(f"cannot unpack codec id {codec_id}")
