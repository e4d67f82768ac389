"""Compressed runs (`--compress`): the port's serial trainer under each
codec against kafka_ps_tpu's on the same rows, and the port's own bitwise
contracts under compression.

Against the JAX package, host decisions are exact: row keys, worker
clocks and the gate's releases (every WeightsMessage, worker and clock,
in send order).  Floats cannot be held to the f32 tolerance of
tests/test_torch_slice.py: the two packages' deltas differ in their last
bits (summation order), and a last-bit difference can flip a code — one
bf16 rounding, one int8 step, one top-k index — which then differs by a
whole codec step and feeds the next iteration.  So the test counts the
flips: every message's encoded parts are compared, code by code (75
messages).  On the rows below, bf16 flips 3,744-4,689 of 29,250 codes
(its 8-bit significand sits near the f32 noise of small deltas), int8
54-71 of 38,550 (1 ulp scales of the jitted JAX codec, ROADMAP C, and
the q steps they move), top-k none of 2,925 indices; the bounds are a
quarter, a hundredth and a hundredth of the codes.  θ is held within
one step of its codec at θ's scale, the most one flipped code changes a
decoded element by (`codec_step`: bf16 max|θ|·2^-8, int8 max|θ|/127,
top-k the k-th largest |θ|; measured at most 1.95e-4 against 2.6e-3 for
bf16, 9e-8 for int8 and top-k), the logged losses within 2^-8 of their
value, F1 and accuracy within 1/len(test) as in the uncompressed parity
test.

Inside the port the contracts are bitwise: gang dispatch equals
per-message dispatch under each codec, and a weights clock delivered
twice steps a worker's error-feedback residual once.
"""

import numpy as np
import pytest
import torch

from kafka_ps_tpu.runtime.app import StreamingPSApp as JApp
from kafka_ps_tpu.utils import config as jconfig
from kafka_ps_tpu_torch.runtime import fabric as fabric_mod
from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
from kafka_ps_tpu_torch.utils import config
from tests.test_torch_slice import W, _clock, _configs, _data, _split

CODECS = ["bf16", "int8", "topk:0.1"]
ITERS = 36
FLIP_SHARE = {"bf16": 1 / 4, "int8": 1 / 100, "topk:0.1": 1 / 100}


def _host(part):
    a = (part.detach().cpu().numpy() if isinstance(part, torch.Tensor)
         else np.asarray(part))
    return a.view(np.uint16) if a.dtype == np.int16 else a


def _drive(app_cls, cfg, rows, tx, ty, **kw):
    """A serial run with the stream pumped a row per round, recording
    the rows, the releases (weights sends in order) and every message's
    encoded parts by (topic, worker, clock)."""
    server, worker = [], []
    app = app_cls(cfg, test_x=tx, test_y=ty, server_log=server.append,
                  worker_log=worker.append, clock_ms=_clock(), **kw)
    releases, parts = [], {}
    orig = app.fabric.send

    def send(topic, key, msg):
        if topic in ("weights", "gradients"):
            w = msg.worker_id if topic == "gradients" else key
            if topic == "weights":
                releases.append((w, msg.vector_clock))
            parts[(topic, w, msg.vector_clock)] = tuple(
                _host(p) for p in msg.encoded.parts)
        return orig(topic, key, msg)
    app.fabric.send = send
    prefill = 40 * W
    for i, (feats, label) in enumerate(rows[:prefill]):
        app.data_sink(i % W, feats, label)
    tail = iter(enumerate(rows[prefill:], start=prefill))

    def pump():
        nxt = next(tail, None)
        if nxt is not None:
            app.data_sink(nxt[0] % W, *nxt[1])
    app.run_serial(ITERS, pump=pump)
    app.close_logs()
    return app, _split(server), _split(worker), releases, parts


def codec_step(codec: str, theta: np.ndarray) -> float:
    """The most one flipped code changes a decoded element of θ: a bf16
    rounding step of the largest element, an int8 quantization step of
    the coarsest chunk, or for top-k an element kept or dropped at the
    boundary (the k-th largest magnitude)."""
    mags = np.abs(theta)
    if codec == "bf16":
        return float(mags.max()) * 2.0 ** -8
    if codec == "int8":
        return float(mags.max()) / 127.0
    k = max(1, round(float(codec.split(":")[1]) * theta.size))
    return float(np.sort(mags)[-k])


def _flips(codec, ours, theirs):
    """Codes that differ: bf16 bit patterns, int8 q and scales, top-k
    indices (the kept values are raw floats, not codes)."""
    if codec == "topk:0.1":
        return len(set(ours[0].tolist()) ^ set(theirs[0].tolist()))
    return sum(int((a != b).sum()) for a, b in zip(ours, theirs))


@pytest.mark.parametrize("c", [0, 2, -1])
@pytest.mark.parametrize("codec", CODECS)
def test_compressed_serial_run_matches_reference(codec, c):
    rows, tx, ty = _data()
    japp, js, jw, jrel, jparts = _drive(
        JApp, _configs(jconfig, c, compress=codec), rows, tx, ty)
    tapp, ts, tw, trel, tparts = _drive(
        StreamingPSApp, _configs(config, c, compress=codec), rows, tx, ty,
        device="cpu")
    assert len(ts) == len(js) > 0 and len(tw) == len(jw) >= ITERS
    assert [r[1:3] for r in ts] == [r[1:3] for r in js]
    assert [r[1:3] + r[6:] for r in tw] == [r[1:3] + r[6:] for r in jw]
    assert trel == jrel
    assert tapp.server.tracker.clocks == japp.server.tracker.clocks
    assert tparts.keys() == jparts.keys()
    coded = 1 if codec == "topk:0.1" else 2     # top-k: the indices
    codes = sum(a.size for p in jparts.values() for a in p[:coded])
    flips = sum(_flips(codec, tparts[k], jparts[k]) for k in jparts)
    print(f"{codec} -c {c}: {flips} of {codes} codes flipped over "
          f"{len(jparts)} messages")
    assert flips <= FLIP_SHARE[codec] * codes
    jt = np.asarray(japp.server.theta)
    np.testing.assert_allclose(tapp.server.theta.numpy(), jt, rtol=0,
                               atol=codec_step(codec, jt))
    tol = 1.0 / len(ty)
    for ours, ref in zip(ts + tw, js + jw):
        loss = float(ref[3])
        assert abs(float(ours[3]) - loss) <= 2.0 ** -8 * abs(loss) + 1e-6
        assert abs(float(ours[4]) - float(ref[4])) <= tol
        assert abs(float(ours[5]) - float(ref[5])) <= tol


# -- inside the port, bitwise -------------------------------------------------


def _port_run(codec, c, **kw):
    rows, tx, ty = _data()
    app, s, w, rel, parts = _drive(
        StreamingPSApp, _configs(config, c, compress=codec, **kw), rows,
        tx, ty, device="cpu")
    return app, s, w, rel, parts


@pytest.mark.parametrize("c", [0, 2, -1])
@pytest.mark.parametrize("codec", CODECS)
def test_gang_equals_per_message_under_compression(codec, c):
    gang = _port_run(codec, c)
    single = _port_run(codec, c, use_gang=False)
    if c == 0:
        assert gang[0].gang.dispatches > 0
    assert torch.equal(gang[0].server.theta, single[0].server.theta)
    assert [r[1:] for r in gang[1]] == [r[1:] for r in single[1]]
    assert [r[1:] for r in gang[2]] == [r[1:] for r in single[2]]
    assert gang[3] == single[3]
    for k, p in single[4].items():
        assert all(np.array_equal(a, b) for a, b in zip(gang[4][k], p)), k
    for a, b in zip(gang[0].compressors.values(),
                    single[0].compressors.values()):
        assert torch.equal(a.residual, b.residual)


def _compressed_app(codec="int8", use_gang=True):
    rows, tx, ty = _data()
    app = StreamingPSApp(_configs(config, 0, compress=codec,
                                  use_gang=use_gang),
                         test_x=tx, test_y=ty, clock_ms=_clock(),
                         device="cpu")
    for i, (feats, label) in enumerate(rows[:40 * W]):
        app.data_sink(i % W, feats, label)
    return app


def test_redelivered_weights_clock_steps_the_residual_once():
    app = _compressed_app()
    app.server.start_training_loop()
    w = app.workers[1]
    msg = app.fabric.poll(fabric_mod.WEIGHTS_TOPIC, 1)
    w.on_weights(msg)
    first = app.fabric.poll(fabric_mod.GRADIENTS_TOPIC, 0)
    residual, iterations = w.compressor.residual, w.iterations
    w.on_weights(msg)                      # the same clock again
    again = app.fabric.poll(fabric_mod.GRADIENTS_TOPIC, 0)
    assert again is first                  # the cached message, resent
    assert w.compressor.residual is residual
    assert w.iterations == iterations
    app.server.process(first)
    app.server.process(again)
    assert app.server.duplicate_gradients_dropped == 1
    older = type(msg)(vector_clock=msg.vector_clock - 1,
                      key_range=msg.key_range, values=msg.values)
    w.on_weights(older)                    # stale: dropped, nothing sent
    assert app.fabric.poll(fabric_mod.GRADIENTS_TOPIC, 0) is None


def test_redelivered_weights_in_a_gang_step_the_residual_once():
    """A redelivered clock inside a release set is answered from the
    worker's cache; the rest of the set runs as a gang."""
    app = _compressed_app()
    app.server.start_training_loop()
    gang = app._make_gang()
    assert gang.drain_serial()
    sent = [app.fabric.poll(fabric_mod.GRADIENTS_TOPIC, 0) for _ in range(W)]
    residuals = [w.compressor.residual for w in app.workers]
    # the bootstrap set again: every member already trained on clock 0
    app.server._loop_started = False
    for st in app.server.tracker.tracker:
        st.weights_message_sent = True
    app.server.start_training_loop()
    dispatches = gang.dispatches
    assert gang.drain_serial() is False
    assert gang.dispatches == dispatches
    again = [app.fabric.poll(fabric_mod.GRADIENTS_TOPIC, 0) for _ in range(W)]
    assert [a is b for a, b in zip(again, sent)] == [True] * W
    assert [w.compressor.residual for w in app.workers] == residuals
