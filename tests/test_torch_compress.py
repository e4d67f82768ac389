"""The port's compressed delta transport (kafka_ps_tpu_torch/compress/):
the cases of tests/test_compress.py that need no serde, run on the port,
and parity with kafka_ps_tpu.compress on seeded vectors.

Parity: bf16 parts and top-k indices and values are bitwise the JAX
codec's, ties in |v| included (lax.top_k gives ties to the lower index;
the port sorts stably).  int8 is bitwise JAX's eager `quantize_rows` on
the padded 256-value chunks; the JAX codec runs that function under jit,
where XLA turns `max|r| / 127` into a multiply by the reciprocal, so its
scales differ from the port's by at most 1 ulp on a few chunks (2 of 25
at n=6150 and 21 of 516 at n=131974 on the seeded vectors below, none
of them moving a q; the test allows at most a tenth of the chunks, each
within 1 ulp and 1 q step).  Decoding the same parts is bitwise equal in
both packages, and pack_parts gives the same bytes.
"""

from __future__ import annotations

import struct
import time

import jax
import numpy as np
import pytest
import torch

from kafka_ps_tpu import compress as jcompress
from kafka_ps_tpu.compress import slab as jslab
from kafka_ps_tpu.compress import wire as jwire
from kafka_ps_tpu_torch import compress
from kafka_ps_tpu_torch.compress import wire as cwire
from kafka_ps_tpu_torch.compress.codecs import Codec
from kafka_ps_tpu_torch.runtime.messages import (EncodedValues,
                                                 GradientMessage, KeyRange)

N = 6150        # the reference model shape (utils/config.ModelConfig)
CODECS = ["bf16", "int8", "topk:0.1"]


def _vec(n=N, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _codec(name, n=N):
    return compress.get_codec(cwire.parse_codec(name), n)


def _host(parts):
    return Codec.host_parts(parts)


# -- codec spec parsing ------------------------------------------------------


def test_parse_codec_accepts_the_flag_surface():
    assert cwire.parse_codec("none") == cwire.NONE
    assert cwire.parse_codec("bf16").codec_id == cwire.CODEC_BF16
    assert cwire.parse_codec("int8").codec_id == cwire.CODEC_INT8
    spec = cwire.parse_codec("topk:0.25")
    assert spec.codec_id == cwire.CODEC_TOPK
    assert spec.param == pytest.approx(0.25)
    assert spec.spec_str() == "topk:0.25"


@pytest.mark.parametrize("bad", ["gzip", "topk", "topk:0", "topk:1.5",
                                 "topk:-0.1", "topk:x", "int8:2"])
def test_parse_codec_rejects_garbage(bad):
    with pytest.raises(ValueError):
        cwire.parse_codec(bad)


def test_codec_spec_param_survives_f32_wire_roundtrip():
    spec = cwire.parse_codec("topk:0.1")
    packed = struct.pack("<f", spec.param)
    back = cwire.CodecSpec(spec.codec_id, struct.unpack("<f", packed)[0])
    assert back == spec


# -- round-trip error bounds -------------------------------------------------


def test_bf16_roundtrip_error_bound():
    v = _vec()
    codec = _codec("bf16")
    decoded = codec.decode(*codec.encode(_t(v))).numpy()
    # bf16 keeps 8 significand bits: relative error <= 2^-8 per element
    np.testing.assert_allclose(decoded, v, rtol=2.0 ** -8)


def test_int8_roundtrip_error_bound():
    v = _vec()
    codec = _codec("int8")
    decoded = codec.decode(*codec.encode(_t(v))).numpy()
    bound = float(np.abs(v).max()) / 127.0
    assert float(np.abs(decoded - v).max()) <= bound + 1e-7


def test_topk_keeps_exactly_the_largest_entries():
    v = _vec(n=1000)
    spec = cwire.parse_codec("topk:0.1")
    codec = compress.get_codec(spec, 1000)
    decoded = codec.decode(*codec.encode(_t(v))).numpy()
    kept = np.flatnonzero(decoded)
    assert len(kept) == cwire.topk_k(spec.param, 1000) == 100
    np.testing.assert_array_equal(decoded[kept], v[kept])
    assert np.abs(v[kept]).min() >= np.abs(np.delete(v, kept)).max() - 1e-7


def test_zero_vector_all_codecs():
    z = np.zeros(N, np.float32)
    for name in CODECS:
        codec = _codec(name)
        np.testing.assert_array_equal(
            codec.decode(*codec.encode(_t(z))).numpy(), z)


# -- host wire pack/unpack ---------------------------------------------------


@pytest.mark.parametrize("name", CODECS)
def test_pack_unpack_is_exact_inverse(name):
    v = _vec(seed=3)
    spec = cwire.parse_codec(name)
    codec = compress.get_codec(spec, N)
    parts = _host(codec.encode(_t(v)))
    flags, aux, blob = cwire.pack_parts(spec.codec_id, parts, N)
    back = cwire.unpack_parts(spec.codec_id, flags, aux, blob, N)
    assert len(back) == len(parts)
    for a, b in zip(parts, back):
        np.testing.assert_array_equal(a, np.asarray(b))
    d1 = codec.decode(*parts, device="cpu").numpy()
    d2 = codec.decode(*back, device="cpu").numpy()
    assert d1.tobytes() == d2.tobytes()


@pytest.mark.parametrize("name", CODECS)
def test_host_parts_decode_on_the_resolved_device(name, monkeypatch):
    """Host parts (unpack_parts' output) decode where the port's entry
    points run: the card unless the caller asks for the CPU; tensor
    parts stay on their device."""
    from kafka_ps_tpu_torch.utils.config import resolve_device
    spec = cwire.parse_codec(name)
    codec = compress.get_codec(spec, N)
    tensors = codec.encode(_t(_vec(seed=4)))
    host = _host(tensors)
    monkeypatch.delenv("KPS_PLATFORM", raising=False)
    if torch.cuda.is_available():
        assert codec.decode(*host).device.type == "cuda"
        assert compress.decode_message_parts(
            spec.codec_id, spec.param, host, N)[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            codec.decode(*host)
        with pytest.raises(RuntimeError, match="no CUDA card"):
            compress.decode_message_parts(spec.codec_id, spec.param, host, N)
    assert codec.decode(*tensors).device.type == "cpu"
    monkeypatch.setenv("KPS_PLATFORM", "cpu")
    assert resolve_device().type == "cpu"
    values, enc = compress.decode_message_parts(spec.codec_id, spec.param,
                                                host, N)
    assert values.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in enc.parts)
    assert values.numpy().tobytes() == codec.decode(*tensors).numpy().tobytes()


def test_int8_wire_ratio_meets_the_4x_bound():
    v = _vec(seed=4)
    spec = cwire.parse_codec("int8")
    parts = _host(compress.get_codec(spec, N).encode(_t(v)))
    _, _, blob = cwire.pack_parts(spec.codec_id, parts, N)
    assert 4.0 * N / len(blob) >= 4.0, len(blob)


@pytest.mark.parametrize("name", CODECS)
def test_message_bytes_is_the_packed_payload_before_zlib(name):
    """Codec.message_bytes, the stats line's bytes per message, is the
    size of pack_parts' blob before its zlib stage (for int8 the scales
    and q trimmed to n; the zlib'd frame may be smaller)."""
    import zlib
    spec = cwire.parse_codec(name)
    codec = compress.get_codec(spec, N)
    parts = _host(codec.encode(_t(_vec(seed=5))))
    flags, _, blob = cwire.pack_parts(spec.codec_id, parts, N)
    if flags & cwire.FLAG_ZLIB:
        blob = zlib.decompress(blob)
    assert codec.message_bytes == len(blob)


# -- error feedback ----------------------------------------------------------


@pytest.mark.parametrize("name", CODECS)
def test_error_feedback_preserves_the_accumulated_signal(name):
    """sum(sent) + residual == sum(true deltas): the quantization error
    is carried, never dropped."""
    ef = compress.ErrorFeedback(_codec(name), device="cpu")
    rng = np.random.default_rng(7)
    total_true = np.zeros(N, np.float64)
    total_sent = np.zeros(N, np.float64)
    for _ in range(50):
        delta = (rng.standard_normal(N) * 0.1).astype(np.float32)
        decoded, _ = ef.step(_t(delta))
        total_true += delta
        total_sent += decoded.numpy()
    drift = np.abs(total_sent + ef.state() - total_true).max()
    assert drift < 1e-3, drift
    assert np.abs(ef.state()).max() > 0


def test_error_feedback_state_roundtrip():
    codec = _codec("int8")
    ef = compress.ErrorFeedback(codec, device="cpu")
    ef.step(_t(_vec(seed=8)))
    saved = ef.state()
    assert saved.dtype == np.float32 and saved.shape == (N,)
    ef2 = compress.ErrorFeedback(codec, device="cpu")
    ef2.restore(saved)
    assert torch.equal(ef2.residual, ef.residual)
    d = _t(_vec(seed=9))
    a, _ = ef.step(d)
    b, _ = ef2.step(d)
    assert a.numpy().tobytes() == b.numpy().tobytes()
    assert ef.state().tobytes() == ef2.state().tobytes()


def test_error_feedback_replaces_its_residual():
    """A checkpoint read on another thread sees a whole residual: a step
    assigns a new tensor and leaves the old one untouched."""
    ef = compress.ErrorFeedback(_codec("int8"), device="cpu")
    ef.step(_t(_vec(seed=1)))
    old = ef.residual
    snapshot = old.clone()
    ef.step(_t(_vec(seed=2)))
    assert ef.residual is not old
    assert torch.equal(old, snapshot)


def test_weights_compressor_identity_cache():
    wc = compress.WeightsCompressor(_codec("int8"))
    theta = _t(_vec(seed=10))
    d1, e1 = wc.encode(theta)
    d2, e2 = wc.encode(theta)
    assert d1 is d2 and e1 is e2
    d3, _ = wc.encode(_t(_vec(seed=11)))
    assert d3 is not d1


def test_make_compressor_none_is_none():
    assert compress.make_compressor("none", N) is None
    assert compress.make_compressor("int8", N) is not None


def test_encoded_values_is_transport_only_metadata():
    msg = GradientMessage(vector_clock=0, key_range=KeyRange(0, 3),
                          values=torch.zeros(3), worker_id=1)
    assert msg.encoded is None
    enc = EncodedValues(codec_id=cwire.CODEC_INT8, param=0.0, parts=())
    assert (enc.codec_id, enc.parts) == (cwire.CODEC_INT8, ())


# -- CLI exclusions ----------------------------------------------------------


def test_fused_plus_compress_is_rejected():
    from kafka_ps_tpu_torch.cli import run as run_mod
    with pytest.raises(SystemExit, match="serde boundary"):
        run_mod.main(["--fused", "--compress", "int8"])


def test_bad_compress_spec_is_rejected():
    from kafka_ps_tpu_torch.cli import run as run_mod
    with pytest.raises(SystemExit, match="--compress"):
        run_mod.main(["--compress", "topk:9"])


# -- parity with kafka_ps_tpu.compress ---------------------------------------


def _jax_parts(name, v, n):
    codec = jcompress.get_codec(jwire.parse_codec(name), n)
    return codec, [np.asarray(p) for p in codec.encode(v)]


@pytest.mark.parametrize("n", [N, 131974])
@pytest.mark.parametrize("name", ["bf16", "topk:0.01", "topk:0.1"])
def test_parts_bitwise_equal_jax(name, n):
    v = _vec(n=n, seed=21, scale=0.1)
    _, jparts = _jax_parts(name, v, n)
    ours = _host(_codec(name, n).encode(_t(v)))
    assert len(ours) == len(jparts)
    for a, b in zip(ours, jparts):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ratio", [0.01, 0.1, 0.5])
def test_topk_ties_go_to_the_lower_index_as_in_jax(ratio):
    """Exact ties in |v| (repeated magnitudes of both signs, zeros): the
    kept indices and their order are lax.top_k's."""
    rng = np.random.default_rng(5)
    n = 2000
    v = (rng.integers(-6, 7, size=n) * 0.25).astype(np.float32)
    name = f"topk:{ratio}"
    _, (jidx, jvals) = _jax_parts(name, v, n)
    idx, vals = _host(_codec(name, n).encode(_t(v)))
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(vals, jvals)


@pytest.mark.parametrize("n", [N, 131974])
def test_int8_parts_equal_jax_eager_and_near_jax_jit(n):
    v = _vec(n=n, seed=22, scale=0.1)
    q, scale = _host(_codec("int8", n).encode(_t(v)))
    nchunks = jwire.int8_chunks(n)
    chunks = np.pad(v, (0, nchunks * 256 - n)).reshape(nchunks, 256)
    eq, escale = jslab.quantize_rows(jax.numpy.asarray(chunks))
    np.testing.assert_array_equal(q, np.asarray(eq).reshape(-1))
    np.testing.assert_array_equal(scale, np.asarray(escale))
    _, (jq, jscale) = _jax_parts("int8", v, n)
    ulps = np.abs(scale.view(np.int32).astype(np.int64)
                  - jscale.view(np.int32).astype(np.int64))
    steps = np.abs(q.astype(np.int32) - jq.astype(np.int32))
    differing = int((ulps > 0).sum())
    print(f"int8 n={n}: {differing} of {nchunks} chunk scales differ from "
          f"the jitted JAX codec (max {int(ulps.max())} ulp); "
          f"{int((steps > 0).sum())} q differ (max {int(steps.max())})")
    assert ulps.max() <= 1 and steps.max() <= 1
    assert differing <= nchunks // 10


@pytest.mark.parametrize("name", CODECS)
def test_port_decodes_jax_parts_bitwise(name):
    v = _vec(seed=23, scale=0.1)
    jcodec, jparts = _jax_parts(name, v, N)
    ours = _codec(name).decode(*jparts, device="cpu").numpy()
    assert ours.tobytes() == np.asarray(jcodec.decode(*jparts)).tobytes()
    values, enc = compress.decode_message_parts(
        cwire.parse_codec(name).codec_id, cwire.parse_codec(name).param,
        jparts, N, device="cpu")
    assert values.numpy().tobytes() == ours.tobytes()
    assert enc.codec_id == cwire.parse_codec(name).codec_id


@pytest.mark.parametrize("name", CODECS)
def test_pack_parts_bytes_equal_jax(name):
    """The same parts pack to the same bytes in both packages, and the
    port's own parts (bf16, top-k: bitwise JAX's) do too."""
    v = _vec(seed=24, scale=0.1)
    spec = cwire.parse_codec(name)
    _, jparts = _jax_parts(name, v, N)
    theirs = jwire.pack_parts(spec.codec_id, jparts, N)
    through = _host([_t(p.view(np.int16) if p.dtype == np.uint16 else p)
                     for p in jparts])
    assert cwire.pack_parts(spec.codec_id, through, N) == theirs
    if name != "int8":
        ours = _host(_codec(name).encode(_t(v)))
        assert cwire.pack_parts(spec.codec_id, ours, N) == theirs


def test_residual_read_on_another_thread_is_never_torn():
    """A checkpoint reads `state()` on the server thread while a worker
    thread steps: every read is a residual some step produced, whole
    (the step replaces the tensor).  Many threads, a short switch
    interval, a time bound."""
    import hashlib
    import sys
    import threading
    n = 131974
    ef = compress.ErrorFeedback(_codec("int8", n), device="cpu")
    ef.step(_t(_vec(n=n, seed=1)))      # no read may see the zero start
    def digest(a):
        return hashlib.blake2b(a.tobytes(), digest_size=16).digest()
    produced = {digest(ef.state())}
    lock = threading.Lock()
    stop = threading.Event()

    def step():
        rng = np.random.default_rng(threading.get_ident() % 2 ** 32)
        while not stop.is_set():
            with lock:           # one stepping stream, as a worker is
                ef.step(_t((rng.standard_normal(n) * 0.1).astype(
                    np.float32)))
                produced.add(digest(ef.state()))

    reads = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=step) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 1.0
        while time.monotonic() < deadline:
            reads.append(digest(ef.state()))
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(produced) > 10 and reads
    assert all(r in produced for r in reads)
