"""Codecs of the compressed delta transport (counterpart of
kafka_ps_tpu/compress/codecs.py): encode/decode of the flat parameter
vector, on the device the tensor lives on.

In the JAX package these are XLA programs (`jax.jit`), not Pallas
kernels, so here they are plain PyTorch.  Encoding runs where the vector
is: a serializer then moves the small encoded parts (1-2 bytes per
value, or 8 bytes per kept value for top-k) instead of 4n bytes of
float32, and the receiver expands them with the same `decode`.

Determinism contract: decode(unpack(pack(encode(v)))) on the receiver is
bitwise decode(encode(v)) on the sender: pack/unpack are exact
(compress/wire.py) and `decode` is one fixed function.  Every decoded
value the sender keeps (message values, the error-feedback residual)
comes from that same function, never from a fused variant.

Parity with the JAX package: bf16 is a round-to-nearest-even cast in
both, its bits carried as int16 on the device (torch's uint16 support
is thin) and viewed as <u2 at the numpy boundary; top-k selects by
|v| descending with ties to the lower index (`lax.top_k`'s order, here
a stable sort); int8 runs the eager `compress/slab.quantize_rows` per
256-value chunk, so its scales can differ by 1 ulp from the JAX codec,
which runs it under jit (ROADMAP C).  Decoding the same parts gives the
same bits in both packages.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from kafka_ps_tpu_torch.compress import wire
from kafka_ps_tpu_torch.compress.slab import dequantize_rows, quantize_rows
from kafka_ps_tpu_torch.compress.wire import (CODEC_BF16, CODEC_INT8,
                                              CODEC_NONE, CODEC_TOPK,
                                              INT8_CHUNK, CodecSpec)
from kafka_ps_tpu_torch.runtime.messages import EncodedValues
from kafka_ps_tpu_torch.utils.config import resolve_device


def _build_fns(spec: CodecSpec, n: int):
    """(encode, decode) over an n-vector."""
    if spec.codec_id == CODEC_BF16:
        def encode(v):
            return (v.to(torch.bfloat16).view(torch.int16),)

        def decode(bits):
            return bits.view(torch.bfloat16).to(torch.float32)
        return encode, decode

    if spec.codec_id == CODEC_INT8:
        # the wire codec's "row" is a 256-value chunk of the flat vector
        nchunks = wire.int8_chunks(n)
        pad = nchunks * INT8_CHUNK - n

        def encode(v):
            r = torch.nn.functional.pad(v, (0, pad)).reshape(nchunks,
                                                             INT8_CHUNK)
            q, scale = quantize_rows(r)
            return q.reshape(-1), scale

        def decode(q, scale):
            r = dequantize_rows(q.reshape(nchunks, INT8_CHUNK), scale)
            return r.reshape(-1)[:n]
        return encode, decode

    if spec.codec_id == CODEC_TOPK:
        k = wire.topk_k(spec.param, n)

        def encode(v):
            # lax.top_k's order: |v| descending, ties to the lower index
            # (a stable sort keeps equal keys in index order); these
            # indices are the wire order
            idx = torch.sort(v.abs(), descending=True,
                             stable=True).indices[:k]
            return idx.to(torch.int32), v[idx]

        def decode(idx, vals):
            out = torch.zeros((n,), dtype=torch.float32, device=vals.device)
            # unique indices: the scatter writes each element once
            out[idx.long()] = vals
            return out
        return encode, decode

    raise ValueError(f"no codec for {spec.spec_str()!r}")


def _as_part(p, device) -> torch.Tensor:
    """An encoded part as a tensor: a tensor stays where it is (or moves
    to `device`); a host array (unpack_parts' output) becomes one on
    `device` as utils.config.resolve_device reads it (the card unless
    the caller asks for the CPU), bf16 bits (<u2) viewed as int16."""
    if isinstance(p, torch.Tensor):
        return p if device is None else p.to(device)
    a = np.array(p)                      # a writable copy
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    return torch.from_numpy(a).to(resolve_device(device))


class Codec:
    """encode/decode for one (spec, n)."""

    def __init__(self, spec: CodecSpec, n: int):
        self.spec = spec
        self.n = n
        self._encode, self._decode = _build_fns(spec, n)

    def encode(self, v) -> tuple:
        """v (f32, length n) -> tuple of encoded parts on v's device."""
        return tuple(self._encode(torch.as_tensor(v, dtype=torch.float32)))

    def decode(self, *parts, device=None) -> torch.Tensor:
        """Encoded parts (tensors, or host arrays from unpack_parts) ->
        f32 tensor, on `device` if given, else on the tensors' device;
        host arrays go to resolve_device(device)."""
        return self._decode(*(_as_part(p, device) for p in parts))

    def roundtrip(self, v):
        """(decoded, parts): quantize-dequantize through the shared
        decode (the weights side, ServerNode._prepared_message)."""
        parts = self.encode(v)
        return self._decode(*parts), parts

    def ef_step(self, delta, residual):
        """(decoded, new_residual, parts): compensate, encode, the shared
        decode, the residual carry.  The new residual is a new tensor."""
        c = torch.as_tensor(delta, dtype=torch.float32,
                            device=residual.device) + residual
        parts = tuple(self._encode(c))
        d = self._decode(*parts)
        return d, c - d, parts

    @property
    def message_bytes(self) -> int:
        """Bytes of one message's packed payload before wire.pack_parts'
        zlib stage (int8's q trimmed to n): fixed by the spec and n."""
        cid, n = self.spec.codec_id, self.n
        if cid == CODEC_BF16:
            return 2 * n
        if cid == CODEC_INT8:
            return 4 * wire.int8_chunks(n) + n
        if cid == CODEC_TOPK:
            return 8 * wire.topk_k(self.spec.param, n)
        return 4 * n

    def encoded(self, parts) -> EncodedValues:
        """Wrap parts as the message-borne encoded payload."""
        return EncodedValues(codec_id=self.spec.codec_id,
                             param=self.spec.param, parts=tuple(parts))

    @staticmethod
    def host_parts(parts) -> tuple:
        """Parts as host arrays in wire dtypes (pack_parts' input): bf16
        bits as <u2."""
        out = []
        for p in parts:
            a = p.detach().cpu().numpy()
            out.append(a.view(np.uint16) if a.dtype == np.int16 else a)
        return tuple(out)


@functools.lru_cache(maxsize=None)
def get_codec(spec: CodecSpec, n: int) -> Codec:
    return Codec(spec, n)


class WeightsCompressor:
    """Server->worker weights compression: plain quantize-dequantize, NO
    error feedback (weights are state, not an accumulated signal).  The
    master theta stays full precision on the server; every worker trains
    on the identical decoded copy.

    A one-entry identity cache covers the gate releasing the SAME theta
    tensor to several workers at one moment (theta is updated by
    replacement, runtime/server.py): a multi-worker release encodes
    once."""

    def __init__(self, codec: Codec):
        self.codec = codec
        self._cache = None          # (theta_ref, decoded, EncodedValues)

    def encode(self, theta):
        c = self._cache
        if c is not None and c[0] is theta:
            return c[1], c[2]
        decoded, parts = self.codec.roundtrip(theta)
        enc = self.codec.encoded(parts)
        self._cache = (theta, decoded, enc)
        return decoded, enc


def make_compressor(compress: str | CodecSpec, n: int):
    """`--compress` value -> WeightsCompressor, or None for "none"."""
    spec = (compress if isinstance(compress, CodecSpec)
            else wire.parse_codec(compress))
    if spec.codec_id == CODEC_NONE:
        return None
    return WeightsCompressor(get_codec(spec, n))


def decode_message_parts(codec_id: int, param: float, parts, n: int,
                         device=None):
    """Receiver-side decode of unpacked parts: (values, EncodedValues),
    so a decoded message re-serializes to the same bytes.  Host parts
    decode on resolve_device(device), the card unless the caller asks
    for the CPU."""
    codec = get_codec(CodecSpec(codec_id, param), n)
    parts = tuple(_as_part(p, device) for p in parts)
    return codec.decode(*parts), EncodedValues(
        codec_id=codec_id, param=codec.spec.param, parts=parts)
