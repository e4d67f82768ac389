"""The port's serde (kafka_ps_tpu_torch/runtime/serde.py) against the JAX
package's (kafka_ps_tpu/runtime/serde.py): the cases of tests/test_serde.py
run on the port, byte identity of every binary frame (tids 1-7) and of
the columnar ingest rows for the same message with the same values,
each package decoding the other's bytes, and the port's frames landing
on the requested device.

Every comparison is exact: serde moves bytes, and decoding the same
compressed parts is one fixed function in each package.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from kafka_ps_tpu.runtime import messages as jmsg
from kafka_ps_tpu.runtime import serde as jserde
from kafka_ps_tpu_torch import compress
from kafka_ps_tpu_torch.compress import wire as cwire
from kafka_ps_tpu_torch.compress.codecs import Codec
from kafka_ps_tpu_torch.runtime import serde
from kafka_ps_tpu_torch.runtime.messages import (CompositeDelta,
                                                 GradientMessage, KeyRange,
                                                 LabeledData,
                                                 SparseDeltaMessage,
                                                 WeightsMessage)

N = 6150        # the reference model's parameter count


def _vec(n=N, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _compressed(codec_name, grad, clock=5, worker=2, seed=1):
    """(port message, JAX message) carrying the same encoded parts: the
    port's codec encodes, both messages hold its decoded values and parts
    (the JAX one as host arrays)."""
    codec = compress.get_codec(cwire.parse_codec(codec_name), N)
    values, parts = codec.roundtrip(_t(_vec(seed=seed)))
    enc = codec.encoded(parts)
    jenc = jmsg.EncodedValues(codec_id=enc.codec_id, param=enc.param,
                              parts=Codec.host_parts(parts))
    kr, jkr = KeyRange(0, N), jmsg.KeyRange(0, N)
    if grad:
        return (GradientMessage(vector_clock=clock, key_range=kr,
                                values=values, encoded=enc,
                                worker_id=worker),
                jmsg.GradientMessage(vector_clock=clock, key_range=jkr,
                                     values=values.numpy(), encoded=jenc,
                                     worker_id=worker))
    return (WeightsMessage(vector_clock=clock, key_range=kr, values=values,
                           encoded=enc),
            jmsg.WeightsMessage(vector_clock=clock, key_range=jkr,
                                values=values.numpy(), encoded=jenc))


def _pair(kind):
    """(port message, JAX message) of one wire type, same values."""
    v = _vec(8, seed=3)
    if kind == "weights":
        return (WeightsMessage(vector_clock=7, key_range=KeyRange(0, 8),
                               values=_t(v)),
                jmsg.WeightsMessage(vector_clock=7,
                                    key_range=jmsg.KeyRange(0, 8), values=v))
    if kind == "gradient":
        return (GradientMessage(vector_clock=3, key_range=KeyRange(10, 18),
                                values=_t(v), worker_id=2),
                jmsg.GradientMessage(vector_clock=3,
                                     key_range=jmsg.KeyRange(10, 18),
                                     values=v, worker_id=2))
    if kind == "labeled":
        feats = {3: 1.5, 100: -0.25, 7: 2.0}
        return (LabeledData(features=feats, label=4),
                jmsg.LabeledData(features=dict(feats), label=4))
    if kind.startswith(("cweights", "cgradient")):
        return _compressed(kind.split("-", 1)[1], kind.startswith("cg"))
    if kind == "sparse":
        idx = np.array([0, 3, 9, 40], np.int32)
        vals = np.array([0.5, -1.0, 2.5, 7.0], np.float32)
        return (SparseDeltaMessage(vector_clock=4, key_range=KeyRange(64, 128),
                                   indices=_t(idx), values=_t(vals),
                                   worker_id=1),
                jmsg.SparseDeltaMessage(vector_clock=4,
                                        key_range=jmsg.KeyRange(64, 128),
                                        indices=idx, values=vals,
                                        worker_id=1))
    if kind.startswith("composite"):
        summed = kind.endswith("summed")
        members = ((0, 6), (1, 6), (3, 6))
        deltas, jdeltas = [], []
        for i, (w, c) in enumerate(members[:1] if summed else members):
            d = _vec(8, seed=10 + i)
            deltas.append(GradientMessage(vector_clock=c,
                                          key_range=KeyRange(0, 8),
                                          values=_t(d), worker_id=w))
            jdeltas.append(jmsg.GradientMessage(
                vector_clock=c, key_range=jmsg.KeyRange(0, 8), values=d,
                worker_id=w))
        if not summed:
            for d, jd, fid in zip(deltas, jdeltas, (0, 17, 2 ** 63)):
                if fid:
                    object.__setattr__(d, "trace", fid)
                    object.__setattr__(jd, "trace", fid)
        return (CompositeDelta(agg_id=9, members=members,
                               deltas=tuple(deltas), summed=summed),
                jmsg.CompositeDelta(agg_id=9, members=members,
                                    deltas=tuple(jdeltas), summed=summed))
    raise ValueError(kind)


KINDS = ["weights", "gradient", "labeled",
         "cweights-bf16", "cweights-int8", "cweights-topk:0.1",
         "cgradient-bf16", "cgradient-int8", "cgradient-topk:0.1",
         "sparse", "composite", "composite-summed"]


def _values(msg):
    return np.asarray(msg.values.numpy() if isinstance(msg.values,
                                                       torch.Tensor)
                      else msg.values)


def _assert_same(port, ref):
    """A port message equal to a JAX message field by field, bitwise."""
    if isinstance(ref, jmsg.LabeledData):
        assert port == LabeledData(features=ref.features, label=ref.label)
        return
    if isinstance(ref, jmsg.CompositeDelta):
        assert (port.agg_id, port.members, port.summed) == \
            (ref.agg_id, ref.members, ref.summed)
        for d, jd in zip(port.deltas, ref.deltas, strict=True):
            _assert_same(d, jd)
            assert getattr(d, "trace", None) == getattr(jd, "trace", None)
        return
    assert port.vector_clock == ref.vector_clock
    assert (port.key_range.start, port.key_range.end) == \
        (ref.key_range.start, ref.key_range.end)
    assert getattr(port, "worker_id", 0) == getattr(ref, "worker_id", 0)
    np.testing.assert_array_equal(_values(port), _values(ref))
    if isinstance(ref, jmsg.SparseDeltaMessage):
        np.testing.assert_array_equal(port.indices.numpy(),
                                      np.asarray(ref.indices))
    assert (port.encoded is None) == (ref.encoded is None)


@pytest.mark.parametrize("kind", KINDS)
def test_binary_frames_are_the_jax_bytes(kind):
    port, ref = _pair(kind)
    assert serde.to_bytes(port) == jserde.to_bytes(ref)


@pytest.mark.parametrize("kind", KINDS)
def test_each_package_decodes_the_others_frames(kind):
    port, ref = _pair(kind)
    # JAX bytes into the port, on the CPU as asked
    got = serde.from_bytes(jserde.to_bytes(ref), device="cpu")
    _assert_same(got, ref)
    for t in (getattr(got, "values", None), getattr(got, "indices", None)):
        if isinstance(t, torch.Tensor):
            assert t.device.type == "cpu"
    # ...and it re-serializes to the same bytes (compressed parts kept
    # verbatim, never re-encoded)
    assert serde.to_bytes(got) == jserde.to_bytes(ref)
    # the port's bytes into the JAX package
    _assert_same(port, jserde.from_bytes(serde.to_bytes(port)))


def test_columnar_rows_are_the_jax_bytes_and_decode_across():
    rng = np.random.default_rng(4)
    rows = []
    for i in range(9):
        keys = rng.choice(64, size=int(rng.integers(0, 6)), replace=False)
        rows.append(({int(k): float(np.float32(rng.normal()))
                      for k in keys}, int(i % 3)))
    blob = serde.encode_labeled_rows(rows)
    assert blob == jserde.encode_labeled_rows(rows)
    assert serde.decode_labeled_rows(blob) == rows
    assert jserde.decode_labeled_rows(blob) == rows
    assert serde.encode_labeled_rows([]) == jserde.encode_labeled_rows([])


@pytest.mark.parametrize("kind", ["weights", "gradient", "labeled"])
def test_json_roundtrip_and_jax_text(kind):
    port, ref = _pair(kind)
    text = serde.to_json(port)
    assert text == jserde.to_json(ref)
    out = serde.from_json(text, device="cpu")
    assert type(out) is type(port)
    _assert_same(out, ref)
    _assert_same(serde.from_json(jserde.to_json(ref), device="cpu"), ref)


@pytest.mark.parametrize("kind", ["weights", "gradient", "labeled"])
def test_binary_roundtrip(kind):
    port, _ = _pair(kind)
    out = serde.from_bytes(serde.to_bytes(port), device="cpu")
    assert type(out) is type(port)
    if kind == "labeled":
        assert out == port
    else:
        assert out.vector_clock == port.vector_clock
        assert out.key_range == port.key_range
        assert torch.equal(out.values, port.values)


def test_gradient_worker_id_survives_both_codecs():
    port, _ = _pair("gradient")
    assert serde.from_json(serde.to_json(port), device="cpu").worker_id == 2
    assert serde.from_bytes(serde.to_bytes(port),
                            device="cpu").worker_id == 2


def test_json_carries_type_discriminator():
    weights, _ = _pair("weights")
    assert json.loads(serde.to_json(weights))["_t"] == "WeightsMessage"
    body = json.loads(serde.to_json(LabeledData(features={3: 1.5,
                                                          100: -0.25},
                                                label=4)))
    assert body["_t"] == "LabeledData"
    assert body["inputData"] == {"3": 1.5, "100": -0.25}


def test_binary_is_compact():
    msg = WeightsMessage(vector_clock=0, key_range=KeyRange(0, N),
                         values=_t(_vec()))
    blob = serde.to_bytes(msg)
    assert len(blob) == 37 + 4 * N      # header + raw float32
    assert len(blob) < len(serde.to_json(msg)) / 3


def test_compressed_frame_decodes_to_the_senders_values():
    """A compressed frame's values decode bitwise to what the sender's
    codec produced (the error-feedback contract across a log)."""
    for name in ("bf16", "int8", "topk:0.1"):
        port, _ = _compressed(name, grad=True)
        out = serde.from_bytes(serde.to_bytes(port), device="cpu")
        assert torch.equal(out.values, port.values)
        assert out.encoded.codec_id == port.encoded.codec_id


def test_bad_payloads_rejected():
    with pytest.raises(ValueError, match="bad magic"):
        serde.from_bytes(b"XXXX" + b"\x00" * 32)
    with pytest.raises(ValueError, match="unknown binary type id"):
        serde.from_bytes(serde.MAGIC + bytes([99]) + b"\x00" * 40)
    with pytest.raises(ValueError, match="unknown message type tag"):
        serde.from_json('{"_t": "MyArrayList"}')
    with pytest.raises(TypeError, match="unregistered"):
        serde.to_json(object())
    with pytest.raises(TypeError, match="unregistered"):
        serde.to_bytes(object())


def test_empty_features_labeled_data():
    msg = LabeledData(features={}, label=1)
    assert serde.from_bytes(serde.to_bytes(msg)) == msg
    assert serde.from_json(serde.to_json(msg)) == msg


def test_tensor_frames_default_to_the_card(monkeypatch):
    """With no device asked for, decoded tensors go to the card: here,
    with no card, that raises instead of quietly landing on the CPU."""
    monkeypatch.delenv("KPS_PLATFORM", raising=False)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: tests/test_torch_cuda.py")
    weights, _ = _pair("weights")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        serde.from_bytes(serde.to_bytes(weights))
    monkeypatch.setenv("KPS_PLATFORM", "cpu")
    assert serde.from_bytes(serde.to_bytes(weights)).values.device.type \
        == "cpu"
