"""Message serialization (counterpart of kafka_ps_tpu/runtime/serde.py).

Two codecs over one type registry:

  * JSON: every payload carries a `_t` discriminator, parameter values
    as a list; for debugging and interop (Weights, Gradient, LabeledData);
  * binary: a struct header plus raw little-endian buffers, the frame the
    durable log appends (log/durable_fabric.py) and a socket would carry.
    Tids 4/5 are the compressed variants of 1/2: the sender's encoded
    parts (messages.EncodedValues) packed by compress/wire.py verbatim,
    never re-encoded; 6 a sparse delta slice; 7 an aggregator's
    composite delta.

The bytes are the JAX package's for the same message: the same MAGIC,
structs and layouts, so a log or a frame written by either package
decodes in the other.  `to_bytes` copies a CUDA `values` tensor to the
host once (the copy waits for the kernel that produced it); `from_bytes`
returns tensors on utils.config.resolve_device(device), the card unless
the caller asks for the CPU; a decoded plain or sparse gradient also
keeps the host array it was decoded from as `host_values`.  Compressed
frames decode through compress.codecs.decode_message_parts, imported
when one is met.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

from kafka_ps_tpu_torch.compress import wire as cwire
from kafka_ps_tpu_torch.runtime.messages import (CompositeDelta,
                                                 GradientMessage, KeyRange,
                                                 LabeledData,
                                                 SparseDeltaMessage,
                                                 WeightsMessage)
from kafka_ps_tpu_torch.utils.config import resolve_device

MAGIC = b"KPS1"

# the `_t` registry; 4/5 are the codec-compressed variants of 1/2 (binary
# only), 6 the range-sharded sparse delta slice, 7 the composite delta
_TYPE_IDS = {
    "WeightsMessage": 1,
    "GradientMessage": 2,
    "LabeledData": 3,
    "CompressedWeights": 4,
    "CompressedGradient": 5,
    "SparseDelta": 6,
    "CompositeDelta": 7,
}
_ID_TYPES = {v: k for k, v in _TYPE_IDS.items()}


def _host(v, dtype: str) -> np.ndarray:
    """A tensor (one device-to-host copy for a CUDA one) or an array as a
    contiguous host array of `dtype`."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.ascontiguousarray(v, dtype=dtype)


def _array(payload, dtype: str, offset: int, count: int) -> np.ndarray:
    """`count` values of `dtype` at `offset` of the payload, copied."""
    return np.frombuffer(payload, dtype=dtype, offset=offset,
                         count=count).copy()


def _on_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on resolve_device(device)."""
    return torch.from_numpy(a).to(resolve_device(device))


# -- JSON codec --------------------------------------------------------------

def to_json(msg) -> str:
    if isinstance(msg, GradientMessage):      # subclass first
        body = {"_t": "GradientMessage", "vectorClock": msg.vector_clock,
                "keyRange": [msg.key_range.start, msg.key_range.end],
                "values": _host(msg.values, "<f4").tolist(),
                "partitionKey": msg.worker_id}
    elif isinstance(msg, WeightsMessage):
        body = {"_t": "WeightsMessage", "vectorClock": msg.vector_clock,
                "keyRange": [msg.key_range.start, msg.key_range.end],
                "values": _host(msg.values, "<f4").tolist()}
    elif isinstance(msg, LabeledData):
        body = {"_t": "LabeledData",
                "inputData": {str(k): float(v)
                              for k, v in msg.features.items()},
                "label": msg.label}
    else:
        raise TypeError(f"unregistered message type {type(msg).__name__}")
    return json.dumps(body)


def from_json(payload: str, device=None):
    body = json.loads(payload)
    t = body.get("_t")
    if t in ("WeightsMessage", "GradientMessage"):
        values = torch.tensor(body["values"], dtype=torch.float32,
                              device=resolve_device(device))
        if t == "WeightsMessage":
            return WeightsMessage(vector_clock=int(body["vectorClock"]),
                                  key_range=KeyRange(*body["keyRange"]),
                                  values=values)
        return GradientMessage(vector_clock=int(body["vectorClock"]),
                               key_range=KeyRange(*body["keyRange"]),
                               values=values,
                               worker_id=int(body["partitionKey"]))
    if t == "LabeledData":
        return LabeledData(
            features={int(k): float(v)
                      for k, v in body["inputData"].items()},
            label=int(body["label"]))
    raise ValueError(f"unknown message type tag {t!r}")


# -- binary codec ------------------------------------------------------------

_HEADER = struct.Struct("<4sBq")          # magic, type id, vector_clock
_RANGE = struct.Struct("<qqq")            # start, end, worker_id
_CODEC_HEADER = struct.Struct("<BBfq")    # codec id, flags, param, aux
# composite delta (tid 7): <B flags><I k members> then k x _MEMBER
# ((worker, clock) pairs), k x _TRACE (two u64 flow-id words, 0/0 =
# absent), <I d deltas>, then d x (<I len> + a nested to_bytes() of a
# GradientMessage: compressed members reuse the tid-5 body verbatim)
_COMPOSITE_HEAD = struct.Struct("<BI")    # flags (bit0 = summed), k
_MEMBER = struct.Struct("<qq")            # worker_id, vector_clock
_TRACE = struct.Struct("<QQ")             # flow id
_CHUNK = struct.Struct("<I")              # nested body length


def to_bytes(msg) -> bytes:
    if isinstance(msg, (GradientMessage, WeightsMessage)):
        grad = isinstance(msg, GradientMessage)
        worker = msg.worker_id if grad else 0
        head = _RANGE.pack(msg.key_range.start, msg.key_range.end, worker)
        enc = msg.encoded
        if enc is not None:
            from kafka_ps_tpu_torch.compress.codecs import Codec
            tid = _TYPE_IDS["CompressedGradient" if grad
                            else "CompressedWeights"]
            flags, aux, blob = cwire.pack_parts(
                enc.codec_id, Codec.host_parts(enc.parts),
                len(msg.key_range))
            return (_HEADER.pack(MAGIC, tid, msg.vector_clock) + head
                    + _CODEC_HEADER.pack(enc.codec_id, flags, enc.param,
                                         aux)
                    + blob)
        tid = _TYPE_IDS["GradientMessage" if grad else "WeightsMessage"]
        return (_HEADER.pack(MAGIC, tid, msg.vector_clock) + head
                + _host(msg.values, "<f4").tobytes())
    if isinstance(msg, SparseDeltaMessage):
        head = _RANGE.pack(msg.key_range.start, msg.key_range.end,
                           msg.worker_id)
        idx = _host(msg.indices, "<i4")
        vals = _host(msg.values, "<f4")
        return (_HEADER.pack(MAGIC, _TYPE_IDS["SparseDelta"],
                             msg.vector_clock) + head
                + struct.pack("<q", len(idx))
                + idx.tobytes() + vals.tobytes())
    if isinstance(msg, CompositeDelta):
        out = [_HEADER.pack(MAGIC, _TYPE_IDS["CompositeDelta"],
                            msg.agg_id),
               _COMPOSITE_HEAD.pack(int(msg.summed), len(msg.members))]
        for w, c in msg.members:
            out.append(_MEMBER.pack(w, c))
        for i in range(len(msg.members)):
            fid = 0
            if not msg.summed:
                fid = int(getattr(msg.deltas[i], "trace", None) or 0)
            out.append(_TRACE.pack(fid, 0))
        out.append(_CHUNK.pack(len(msg.deltas)))
        for d in msg.deltas:
            body = to_bytes(d)
            out.append(_CHUNK.pack(len(body)))
            out.append(body)
        return b"".join(out)
    if isinstance(msg, LabeledData):
        keys = np.fromiter(msg.features.keys(), dtype="<i4",
                           count=len(msg.features))
        vals = np.fromiter(msg.features.values(), dtype="<f4",
                           count=len(msg.features))
        return (_HEADER.pack(MAGIC, _TYPE_IDS["LabeledData"], msg.label)
                + struct.pack("<q", len(keys))
                + keys.tobytes() + vals.tobytes())
    raise TypeError(f"unregistered message type {type(msg).__name__}")


# -- columnar ingest rows ----------------------------------------------------
# The batched stream-row frame body: one NEGATIVE <i64 -nrows>
# discriminator (a legacy per-row frame's count is >= 0), then packed
# columns:
#     <i64 -nrows> <i64 total_nnz>
#     <i4 nnz[nrows]>       per-row feature counts
#     <i64 labels[nrows]>   per-row labels
#     <i4 keys[total_nnz]>  concatenated feature indices, row-major
#     <f4 vals[total_nnz]>  concatenated feature values, row-major

_BATCH_HEAD = struct.Struct("<qq")        # -nrows, total_nnz


def encode_labeled_rows(rows) -> bytes:
    """Columnar body for a sequence of (features: dict, label: int) stream
    rows.  An empty sequence encodes as the legacy <i64 0> frame (the -0
    discriminator would be ambiguous)."""
    n = len(rows)
    if n == 0:
        return struct.pack("<q", 0)
    nnz = np.empty(n, dtype="<i4")
    labels = np.empty(n, dtype="<q")
    keys_cols = []
    vals_cols = []
    for i, (features, label) in enumerate(rows):
        c = len(features)
        nnz[i] = c
        labels[i] = label
        keys_cols.append(np.fromiter(features.keys(), dtype="<i4",
                                     count=c))
        vals_cols.append(np.fromiter(features.values(), dtype="<f4",
                                     count=c))
    keys = np.concatenate(keys_cols)
    vals = np.concatenate(vals_cols)
    return b"".join((_BATCH_HEAD.pack(-n, keys.size),
                     nnz.tobytes(), labels.tobytes(),
                     keys.tobytes(), vals.tobytes()))


def decode_labeled_rows(payload) -> list:
    """Decode a columnar body back into [(features, label), ...] with
    Python int keys and float values."""
    neg, total = _BATCH_HEAD.unpack_from(payload, 0)
    n = -neg
    off = _BATCH_HEAD.size
    nnz = np.frombuffer(payload, dtype="<i4", offset=off, count=n)
    off += 4 * n
    labels = np.frombuffer(payload, dtype="<q", offset=off, count=n)
    off += 8 * n
    keys = np.frombuffer(payload, dtype="<i4", offset=off, count=total)
    off += 4 * total
    vals = np.frombuffer(payload, dtype="<f4", offset=off, count=total)
    ks, vs = keys.tolist(), vals.tolist()
    rows = []
    pos = 0
    for i in range(n):
        c = int(nnz[i])
        rows.append((dict(zip(ks[pos:pos + c], vs[pos:pos + c])),
                     int(labels[i])))
        pos += c
    return rows


def from_bytes(payload, device=None):
    """Decode one binary frame; tensors land on resolve_device(device)."""
    magic, tid, clock_or_label = _HEADER.unpack_from(payload, 0)
    if magic != MAGIC:
        raise ValueError("bad magic — not a KPS1 message")
    off = _HEADER.size
    name = _ID_TYPES.get(tid)
    if name in ("WeightsMessage", "GradientMessage"):
        start, end, worker = _RANGE.unpack_from(payload, off)
        off += _RANGE.size
        host = _array(payload, "<f4", off, end - start)
        values = _on_device(host, device)
        if name == "WeightsMessage":
            return WeightsMessage(vector_clock=clock_or_label,
                                  key_range=KeyRange(start, end),
                                  values=values)
        return GradientMessage(vector_clock=clock_or_label,
                               key_range=KeyRange(start, end),
                               values=values, worker_id=worker,
                               host_values=host)
    if name in ("CompressedWeights", "CompressedGradient"):
        start, end, worker = _RANGE.unpack_from(payload, off)
        off += _RANGE.size
        codec_id, flags, param, aux = _CODEC_HEADER.unpack_from(payload,
                                                                off)
        off += _CODEC_HEADER.size
        n = end - start
        parts = cwire.unpack_parts(codec_id, flags, aux, payload[off:], n)
        from kafka_ps_tpu_torch.compress import codecs
        values, enc = codecs.decode_message_parts(codec_id, param, parts,
                                                  n, device=device)
        if name == "CompressedWeights":
            return WeightsMessage(vector_clock=clock_or_label,
                                  key_range=KeyRange(start, end),
                                  values=values, encoded=enc)
        return GradientMessage(vector_clock=clock_or_label,
                               key_range=KeyRange(start, end),
                               values=values, encoded=enc,
                               worker_id=worker)
    if name == "SparseDelta":
        start, end, worker = _RANGE.unpack_from(payload, off)
        off += _RANGE.size
        (n,) = struct.unpack_from("<q", payload, off)
        off += 8
        idx = _on_device(_array(payload, "<i4", off, n), device)
        host = _array(payload, "<f4", off + 4 * n, n)
        return SparseDeltaMessage(vector_clock=clock_or_label,
                                  key_range=KeyRange(start, end),
                                  indices=idx,
                                  values=_on_device(host, device),
                                  worker_id=worker, host_values=host)
    if name == "CompositeDelta":
        flags, k = _COMPOSITE_HEAD.unpack_from(payload, off)
        off += _COMPOSITE_HEAD.size
        members = []
        for _ in range(k):
            members.append(_MEMBER.unpack_from(payload, off))
            off += _MEMBER.size
        fids = []
        for _ in range(k):
            fid, _reserved = _TRACE.unpack_from(payload, off)
            off += _TRACE.size
            fids.append(fid)
        (d,) = _CHUNK.unpack_from(payload, off)
        off += _CHUNK.size
        deltas = []
        for _ in range(d):
            (length,) = _CHUNK.unpack_from(payload, off)
            off += _CHUNK.size
            deltas.append(from_bytes(bytes(payload[off:off + length]),
                                     device))
            off += length
        summed = bool(flags & 1)
        if not summed:
            for m, fid in zip(deltas, fids):
                if fid:
                    object.__setattr__(m, "trace", fid)
        return CompositeDelta(agg_id=clock_or_label,
                              members=tuple(members),
                              deltas=tuple(deltas), summed=summed)
    if name == "LabeledData":
        (n,) = struct.unpack_from("<q", payload, off)
        off += 8
        keys = np.frombuffer(payload, dtype="<i4", offset=off, count=n)
        off += 4 * n
        vals = np.frombuffer(payload, dtype="<f4", offset=off, count=n)
        return LabeledData(
            features={int(k): float(v) for k, v in zip(keys, vals)},
            label=clock_or_label)
    raise ValueError(f"unknown binary type id {tid}")
