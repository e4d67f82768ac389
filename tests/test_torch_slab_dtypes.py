"""The reduced-precision device slab of the port (`--slab-dtype bf16|int8`,
kafka_ps_tpu_torch.compress.slab) and the plain versions of K3 and K5,
against the JAX package on the same numpy inputs, on the CPU.

Tolerances:
  * encodes: bitwise — the port's `quantize_rows` gives the JAX
    function's q and scale, and bf16 `encode_x` its bits, zero rows and
    .5 ties included; `decode_x` is bitwise too, so both packages train
    on the same decoded x;
  * K3's plain version against the JAX Pallas kernels in interpret mode
    (the streaming kernel, tiled or as `local_update` dispatches it):
    rtol=1e-4, atol=1e-6, as K1's (float32, different summation orders);
  * K5's plain version against `_mlp_stream_update`: rtol=1e-4,
    atol=1e-5, as K4's;
  * serial app runs against the JAX app with the same slab dtype: row
    keys exact, loss and theta rtol=1e-4, atol=1e-5, F1 and accuracy
    within 1/len(test);
  * inside the port: incremental slab == full upload, gang on == off,
    bitwise.

One difference of the JAX package with itself stays out of these
comparisons: its SlabStore encodes under jit, where XLA turns the
`/ 127.0` of `quantize_rows` into a multiply by the float32 reciprocal,
so a stored int8 scale can be 1 ulp off the function's.  The port's
store encodes with the function's division; the app runs below hold the
two packages within the f32 tolerances all the same.
"""

import json

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from kafka_ps_tpu.compress import slab as jslab
from kafka_ps_tpu.data.buffer import SlidingBuffer as JSlidingBuffer
from kafka_ps_tpu.data.synth import generate
from kafka_ps_tpu.models import mlp as jmlp
from kafka_ps_tpu.ops import fused_update as jfused
from kafka_ps_tpu.runtime.app import StreamingPSApp as JApp
from kafka_ps_tpu.utils import config as jconfig
from kafka_ps_tpu_torch.cli import run as cli_run
from kafka_ps_tpu_torch.compress import slab
from kafka_ps_tpu_torch.compress.slab import QuantizedSlab, SlabStore
from kafka_ps_tpu_torch.data.buffer import SlidingBuffer
from kafka_ps_tpu_torch.data.synth import write_csv
from kafka_ps_tpu_torch.ops import fused_update
from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
from kafka_ps_tpu_torch.utils import config
from kafka_ps_tpu_torch.weights import from_jax_params, from_jax_slab
from tests.test_torch_slice import _configs, _data, _drive, _split

RTOL, ATOL = 1e-4, 1e-6             # K3
MLP_RTOL, MLP_ATOL = 1e-4, 1e-5     # K5
APP_RTOL, APP_ATOL = 1e-4, 1e-5     # app runs
KINDS = ("bf16", "int8")


def _x_with_ties(rows=512, features=1024, seed=0):
    """Sparse normal rows, an all-zero row, and rows whose max is 127 so
    that the scale is 1 and r / scale lands on .5 ties."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, features))
         * (rng.random((rows, features)) < 0.5)).astype(np.float32)
    x[5] = 0.0
    x[7] = 0.0
    x[7, :6] = [127.0, 2.5, -0.5, 1.5, -3.5, 0.5]
    x[9] = (rng.integers(-254, 255, size=features) / 2).astype(np.float32)
    x[9, 0] = 127.0
    return x


def _bits(t):
    """The bytes of a torch tensor, bf16 included."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _jbits(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        a = a.view(np.uint16)
    return a.tobytes()


# -- encodes ---------------------------------------------------------------


def test_quantize_rows_and_bf16_encode_are_bitwise_the_references():
    x = _x_with_ties()
    q, scale = slab.quantize_rows(torch.from_numpy(x))
    jq, jscale = jslab.quantize_rows(jnp.asarray(x))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    assert _bits(q) == _jbits(jq) and _bits(scale) == _jbits(jscale)
    # the ties were there, and went to the even neighbour
    assert q[7, :6].tolist() == [127, 2, 0, 2, -4, 0]
    assert float(scale[5]) == 0.0 and not q[5].any()
    assert (_bits(slab.dequantize_rows(q, scale))
            == _jbits(jslab.dequantize_rows(jq, jscale)))
    for kind in ("f32", *KINDS):
        ours = slab.encode_x(kind, torch.from_numpy(x))
        ref = jslab.encode_x(kind, jnp.asarray(x))
        if kind == "int8":
            assert isinstance(ours, QuantizedSlab)
            assert ours.scale.shape == (x.shape[0], 1)
            assert _bits(ours.q) == _jbits(ref.q)
            assert _bits(ours.scale) == _jbits(ref.scale)
        else:
            assert _bits(ours) == _jbits(ref)
        assert _bits(slab.decode_x(ours)) == _jbits(jslab.decode_x(ref))
        assert slab.slab_kind(ours) == kind
        assert slab.slab_batch_shape(ours) == x.shape


def test_slab_kind_refuses_other_dtypes():
    with pytest.raises(TypeError):
        slab.slab_kind(torch.zeros(2, 2, dtype=torch.float64))
    with pytest.raises(ValueError):
        SlabStore("fp8", 4, 4, "cpu")


# -- the store ---------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _stores_equal(a, b):
    for u, v in zip(a.arrays(), b.arrays()):
        for s, t in zip(*(tuple(w) if isinstance(w, QuantizedSlab)
                          else (w,) for w in (u, v))):
            assert s.dtype == t.dtype and _bits(s) == _bits(t)


@pytest.mark.parametrize("dtype", slab.SLAB_DTYPES)
def test_incremental_slab_matches_full_upload_and_reference_counters(dtype):
    """tests/test_slab.py's randomized trace through every eviction
    branch: scattering each drained dirty set leaves the store bitwise a
    from-scratch upload, the spare row holds only zero padding, and the
    upload-byte counter moves as the JAX store's does."""
    rng = np.random.default_rng(7)
    policy = dict(min_size=2, max_size=8, coefficient=0.3,
                  arrival_window=500)
    clock, jclock = _Clock(), _Clock()
    buf = SlidingBuffer(4, config.BufferConfig(**policy), clock_ms=clock)
    jbuf = JSlidingBuffer(4, jconfig.BufferConfig(**policy),
                          clock_ms=jclock)
    inc, ref = SlabStore(dtype, 8, 4, "cpu"), jslab.SlabStore(dtype, 8, 4)
    inc.upload_full(*buf.snapshot(clear_dirty=True))
    ref.upload_full(*jbuf.snapshot(clear_dirty=True))
    for _ in range(60):
        dt = float(rng.choice([100.0, 1000.0, 50_000.0], p=[0.6, 0.3, 0.1]))
        row = rng.normal(scale=2.0, size=4).astype(np.float32)
        label = int(rng.integers(0, 5))
        for b, c in ((buf, clock), (jbuf, jclock)):
            c.t += dt
            b.add(row, label)
        inc.apply_rows(*buf.drain_dirty())
        ref.apply_rows(*jbuf.drain_dirty())
        full = SlabStore(dtype, 8, 4, "cpu")
        full.upload_full(*buf.snapshot())
        _stores_equal(inc, full)
        assert inc.bytes_uploaded == ref.bytes_uploaded
        spare = inc._x.q[8] if dtype == "int8" else inc._x[8]
        assert not spare.any() and int(inc._y[8]) == 0
        if dtype == "int8":
            assert float(inc._x.scale[8, 0]) == 0.0
    assert (inc.full_uploads, inc.incremental_applies,
            inc.rows_applied) == (ref.full_uploads, ref.incremental_applies,
                                  ref.rows_applied)
    assert inc.incremental_applies == 60
    x, y, mask = inc.arrays()
    for t in (*(x if dtype == "int8" else (x,)), y, mask):
        assert t.is_contiguous() and t.shape[0] == 8


@pytest.mark.parametrize("dtype,expected", [
    ("f32", 4_202_496), ("bf16", 2_105_344), ("int8", 1_060_864)])
def test_device_bytes_match_reference(dtype, expected):
    cap = nf = 1024
    rng = np.random.default_rng(3)
    x = rng.normal(size=(cap, nf)).astype(np.float32)
    y = rng.integers(0, 6, size=cap).astype(np.int32)
    m = np.ones(cap, np.float32)
    ours, ref = SlabStore(dtype, cap, nf, "cpu"), jslab.SlabStore(dtype,
                                                                  cap, nf)
    assert ours.device_bytes() == 0
    for s in (ours, ref):
        s.upload_full(x, y, m)
    assert ours.device_bytes() == ref.device_bytes() == expected
    assert ours.bytes_uploaded == ref.bytes_uploaded


# -- K3 and K5: plain versions against the Pallas kernels -------------------

STREAM_F = 128          # the JAX streaming kernels need F % 128 == 0


def _case(batch, features=STREAM_F, classes=5, k=2, seed=0, task="logreg",
          hidden=32):
    x, y = generate(batch, features, classes, noise=1.0, sparsity=0.5,
                    seed=seed)
    y[1] = classes + 3                      # out of range
    mask = (np.arange(batch) < batch - 5).astype(np.float32)
    cfg = config.ModelConfig(num_features=features, num_classes=classes,
                             num_max_iter=k, hidden_dim=hidden)
    jcfg = jconfig.ModelConfig(num_features=features, num_classes=classes,
                               num_max_iter=k, hidden_dim=hidden)
    rng = np.random.default_rng(seed + 1)
    if task == "logreg":
        theta = rng.normal(scale=0.1, size=cfg.num_params)
    else:
        theta = np.asarray(jmlp.MLPTask(jcfg).init_params()) + rng.normal(
            scale=0.01, size=jmlp.num_params(jcfg))
    return cfg, jcfg, theta.astype(np.float32), x, y, mask


def _both(kind, theta, x, y, mask):
    """The JAX inputs (x encoded by the JAX package) and the port's (the
    same stored bytes, through weights.from_jax_slab)."""
    stored = jslab.encode_x(kind, jnp.asarray(x))
    jargs = (jnp.asarray(theta), stored, jnp.asarray(y), jnp.asarray(mask))
    targs = (torch.from_numpy(theta), from_jax_slab(stored),
             torch.from_numpy(y), torch.from_numpy(mask))
    return jargs, targs


def _close(ours, ref, rtol, atol):
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref[0]),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(float(ours[1]), float(ref[1]), rtol=rtol,
                               atol=atol)
    assert np.isfinite(ours[0].numpy()).all()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("batch", [96, 37])
def test_k3_plain_matches_pallas_local_update(kind, batch):
    """tests/test_ops.py's decode case: a bf16 / int8 slab through the JAX
    `local_update` (its streaming kernel, interpret mode, no fallback)
    and through the port's, which takes the CPU path: no kernel call."""
    cfg, jcfg, theta, x, y, mask = _case(batch)
    jargs, targs = _both(kind, theta, x, y, mask)
    ref = jfused.local_update(*jargs, cfg=jcfg, interpret=True,
                              allow_fallback=False)
    before = fused_update.counts()
    ours = fused_update.local_update(*targs, cfg=cfg)
    assert fused_update.counts() == before
    _close(ours, ref, RTOL, ATOL)


@pytest.mark.parametrize("kind", ("f32", *KINDS))
def test_k3_plain_matches_tiled_stream_kernel(kind):
    """tests/test_ops.py's multi-tile case: B=200 in tiles of 32 (7
    tiles, the last padded) against the port's stream_update."""
    cfg, jcfg, theta, x, y, mask = _case(200)
    jargs, targs = _both(kind, theta, x, y, mask)
    ref = jfused._stream_update(*jargs, cfg=jcfg, tile=32, interpret=True)
    _close(fused_update.stream_update(*targs, cfg=cfg), ref, RTOL, ATOL)


def test_f32_oversize_batch_runs_through_local_update():
    """tests/test_ops.py's oversize f32 batch, too big for whole-VMEM
    residency, which the JAX package streams through K3: the port's
    local_update takes it as any f32 slab (K1's path; Hopper tiles every
    batch across CTAs)."""
    features = 512
    big = jfused._VMEM_BYTE_BUDGET // (4 * features) + 8
    big += (-big) % 8
    assert not jfused.fits_in_vmem(big, features)
    cfg, jcfg, theta, x, y, mask = _case(big, features=features)
    ref = jfused.local_update(jnp.asarray(theta), jnp.asarray(x),
                              jnp.asarray(y), jnp.asarray(mask), cfg=jcfg,
                              interpret=True, allow_fallback=False)
    ours = fused_update.local_update(*map(torch.from_numpy,
                                          (theta, x, y, mask)), cfg=cfg)
    _close(ours, ref, RTOL, ATOL)


@pytest.mark.parametrize("kind", ("f32", *KINDS))
def test_k5_plain_matches_tiled_mlp_stream_kernel(kind):
    cfg, jcfg, theta, x, y, mask = _case(200, task="mlp")
    jargs, targs = _both(kind, theta, x, y, mask)
    ref = jfused._mlp_stream_update(*jargs, cfg=jcfg, tile=32,
                                    interpret=True)
    before = fused_update.counts()
    _close(fused_update.mlp_stream_update(*targs, cfg=cfg), ref, MLP_RTOL,
           MLP_ATOL)
    assert fused_update.counts() == before


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("task", ["logreg", "mlp"])
def test_batched_stored_slabs_equal_single_calls(kind, task):
    """A gang of stored slabs: member i bitwise the single call, whether
    the gang comes as a list or stacked."""
    members = [_case(40, seed=s, task=task) for s in range(3)]
    cfg = members[0][0]
    thetas = [torch.from_numpy(m[2]) for m in members]
    xs = [slab.encode_x(kind, torch.from_numpy(m[3])) for m in members]
    ys = [torch.from_numpy(m[4]) for m in members]
    masks = [torch.from_numpy(m[5]) for m in members]
    batched, single = (
        (fused_update.local_update_batched, fused_update.local_update)
        if task == "logreg" else
        (fused_update.mlp_local_update_batched,
         fused_update.mlp_local_update))
    deltas, losses = batched(thetas, xs, ys, masks, cfg=cfg)
    stacked = (QuantizedSlab(torch.stack([x.q for x in xs]),
                             torch.stack([x.scale for x in xs]))
               if kind == "int8" else torch.stack(xs))
    d2, l2 = batched(torch.stack(thetas), stacked, torch.stack(ys),
                     torch.stack(masks), cfg=cfg)
    assert torch.equal(deltas, d2) and torch.equal(losses, l2)
    for i in range(3):
        d, loss = single(thetas[i], xs[i], ys[i], masks[i], cfg=cfg)
        assert torch.equal(deltas[i], d) and torch.equal(losses[i], loss)


def _stored_args(kind="int8", batch=16, features=8):
    cfg = config.ModelConfig(num_features=features, num_classes=3)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(batch, features)).astype(
        np.float32))
    return cfg, [torch.zeros(cfg.num_params), slab.encode_x(kind, x),
                 torch.ones(batch, dtype=torch.int32), torch.ones(batch)]


@pytest.mark.parametrize("bad,err", [
    (lambda x: QuantizedSlab(x.q.to(torch.int16), x.scale), TypeError),
    (lambda x: QuantizedSlab(x.q.to(torch.uint8), x.scale), TypeError),
    (lambda x: QuantizedSlab(x.q, x.scale.double()), TypeError),
    (lambda x: QuantizedSlab(x.q, x.scale.reshape(-1)), ValueError),
    (lambda x: QuantizedSlab(x.q, x.scale[:-1]), ValueError),
    (lambda x: QuantizedSlab(x.q.t().contiguous().t(), x.scale),
     ValueError),
    (lambda x: QuantizedSlab(x.q[:, :-1], x.scale), ValueError),
    (lambda x: slab.decode_x(x).to(torch.float16), TypeError),
])
def test_wrapper_checks_stored_forms_before_dispatch(bad, err):
    cfg, args = _stored_args()
    args[1] = bad(args[1])
    before = fused_update.counts()
    for fn in (fused_update.local_update, fused_update.stream_update):
        with pytest.raises(err):
            fn(*args, cfg=cfg)
    with pytest.raises(err):
        fused_update.check_args(*args, cfg)
    with pytest.raises(err):
        fused_update.local_update_batched([args[0]], [args[1]], [args[2]],
                                          [args[3]], cfg=cfg)
    assert fused_update.counts() == before


def test_gang_of_mixed_forms_raises_before_dispatch():
    cfg, a = _stored_args("int8")
    _, b = _stored_args("bf16")
    before = fused_update.counts()
    with pytest.raises(TypeError, match="one slab form"):
        fused_update.local_update_batched(*zip(a, b), cfg=cfg)
    assert fused_update.counts() == before


def test_from_jax_slab_carries_the_stored_bytes():
    x = _x_with_ties(rows=16, features=32)
    for kind in ("f32", *KINDS):
        stored = jslab.encode_x(kind, jnp.asarray(x))
        numpy_form = (jslab.QuantizedSlab(np.asarray(stored.q),
                                          np.asarray(stored.scale))
                      if kind == "int8" else np.asarray(stored))
        ours = from_jax_slab(numpy_form)
        assert slab.slab_kind(ours) == kind
        if kind == "int8":
            assert _bits(ours.q) == _jbits(stored.q)
            assert _bits(ours.scale) == _jbits(stored.scale)
        else:
            assert _bits(ours) == _jbits(stored)
    with pytest.raises(TypeError):
        from_jax_slab(x.astype(np.float64))


# -- the app ------------------------------------------------------------------


@pytest.mark.parametrize("dtype,c,task", [
    ("bf16", 0, "logreg"), ("bf16", 2, "logreg"), ("bf16", -1, "logreg"),
    ("int8", 0, "logreg"), ("int8", 2, "logreg"), ("int8", -1, "logreg"),
    ("int8", 0, "mlp")])
def test_serial_slab_dtype_run_matches_reference(dtype, c, task):
    rows, tx, ty = _data()
    jcfg = _configs(jconfig, c, task, slab_dtype=dtype)
    cfg = _configs(config, c, task, slab_dtype=dtype)
    theta0 = None
    if task == "mlp":
        theta0 = np.asarray(JApp(jcfg).server.theta)
    japp, js, jw = _drive(JApp, jcfg, rows, tx, ty, 36, theta0=theta0)
    tapp, ts, tw = _drive(
        StreamingPSApp, cfg, rows, tx, ty, 36, device="cpu",
        theta0=None if theta0 is None else from_jax_params(
            theta0, cfg.model, "cpu", task=task))
    js, jw, ts, tw = map(_split, (js, jw, ts, tw))
    assert len(ts) == len(js) > 0 and len(tw) == len(jw) >= 36
    assert [r[1:3] for r in ts] == [r[1:3] for r in js]
    assert [r[1:3] + r[6:] for r in tw] == [r[1:3] + r[6:] for r in jw]
    tol = 1.0 / len(ty)
    for ours, ref in zip(ts + tw, js + jw):
        np.testing.assert_allclose(float(ours[3]), float(ref[3]),
                                   rtol=APP_RTOL, atol=APP_ATOL)
        assert abs(float(ours[4]) - float(ref[4])) <= tol
        assert abs(float(ours[5]) - float(ref[5])) <= tol
    np.testing.assert_allclose(tapp.server.theta.numpy(),
                               np.asarray(japp.server.theta),
                               rtol=APP_RTOL, atol=APP_ATOL)
    stores = [w._slab_store for w in tapp.workers]
    assert all(s.dtype == dtype and s.incremental_applies for s in stores)
    assert tapp.gang.dispatches > 0


def _strip(rows):
    return [r.split(";", 1)[1] for r in rows]


@pytest.mark.parametrize("task", ["logreg", "mlp"])
@pytest.mark.parametrize("lever", [{"use_gang": False},
                                   {"slab_incremental": False}])
def test_int8_levers_are_bitwise(task, lever):
    """With int8 slabs, gang on == off and incremental == full upload: the
    same theta bits and the same CSV rows apart from timestamps."""
    rows, tx, ty = _data()
    runs = [_drive(StreamingPSApp,
                   _configs(config, 0, task, slab_dtype="int8", **kw),
                   rows, tx, ty, 36, device="cpu") for kw in ({}, lever)]
    (a, sa, wa), (b, sb, wb) = runs
    assert torch.equal(a.server.theta, b.server.theta)
    assert _strip(sa) == _strip(sb) and _strip(wa) == _strip(wb)
    if "slab_incremental" in lever:
        assert all(w._slab_store.incremental_applies == 0
                   for w in b.workers)


def test_cli_slab_flags_reach_the_config(tmp_path, monkeypatch):
    args = cli_run.build_parser().parse_args([])
    assert (args.slab_dtype, args.full_slab_upload) == ("f32", False)
    x, y = generate(60, 16, 3, seed=1)
    write_csv(str(tmp_path / "test.csv"), x, y)
    args = cli_run.build_parser().parse_args(
        ["--slab-dtype", "int8", "--full-slab-upload", "--num_features",
         "16", "--num_classes", "3", "-test", str(tmp_path / "test.csv")])
    app, logs = cli_run.make_app_from_args(args, "cpu")
    for log in logs:
        log.close()
    app.close_logs()
    assert (app.cfg.slab_dtype, app.cfg.slab_incremental) == ("int8", False)
    assert all(w._slab_store.dtype == "int8" for w in app.workers)
    with pytest.raises(SystemExit):
        cli_run.build_parser().parse_args(["--slab-dtype", "fp8"])


@pytest.mark.parametrize("dtype", KINDS)
def test_cli_run_reports_the_slab(dtype, tmp_path, monkeypatch, capsys):
    x, y = generate(300, 16, 3, seed=1)
    write_csv(str(tmp_path / "train.csv"), x[:240], y[:240])
    write_csv(str(tmp_path / "test.csv"), x[240:], y[240:])
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("KPS_PLATFORM", "cpu")
    rc = cli_run.main(["-training", "train.csv", "-test", "test.csv",
                       "--num_features", "16", "--num_classes", "3",
                       "--num_workers", "2", "-c", "0", "-p", "0", "-l",
                       "-min", "8", "-max", "32", "--mode", "serial",
                       "--max_iterations", "12", "--slab-dtype", dtype])
    assert rc == 0
    line = [ln for ln in capsys.readouterr().err.splitlines()
            if ln.startswith("kafka_ps_tpu_torch run: ")][-1]
    stats = json.loads(line.split(": ", 1)[1])["slab"]
    # two workers' slabs of 32 rows: x as stored, y and mask 4 bytes each
    per_row = {"bf16": 16 * 2, "int8": 16 + 4}[dtype] + 8
    assert (stats["dtype"], stats["device_bytes"]) == (dtype,
                                                       2 * 32 * per_row)
    assert stats["bytes_uploaded"] > 0
