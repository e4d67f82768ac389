"""The kernels (K1-K6) and the trainer on an NVIDIA card.  Every
test here needs CUDA and skips without it.  The file imports no JAX, so
it also runs where only PyTorch is installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances of a kernel against its plain version on the card (float32;
the kernel and cuBLAS sum in different orders; TF32 is switched off for
the plain version's matmuls): K1/K2 rtol=1e-4, atol=1e-6; K4/K6
rtol=1e-4, atol=1e-5 (two more products per step, and the relu gate).
K3 and K5 (bf16 and int8 slabs) take K1's and K4's tolerances: the
kernel decodes each element exactly as the plain version's decode_x does,
so both run the same arithmetic on the same decoded values.  A gang
member and a single call on the same inputs are bitwise equal.  K4-K6
run their B*F*H products on the tensor cores (TF32 mma.sync, or for f32
at a wide hidden layer wgmma fed by TMA; each f32 operand split into two
TF32 terms) and keep these tolerances (tests/test_torch_mlp_split.py
models both summation orders on the CPU).  K1-K3 are
one cooperative launch per call with x resident in shared memory where it
fits and re-staged at each step where it does not; both give the same
bits (tests/test_torch_logreg_tiling.py models their summation order on
the CPU).
"""

import dataclasses
import json
import re

import numpy as np
import pytest
import torch

from kafka_ps_tpu_torch.compress.slab import encode_x
from kafka_ps_tpu_torch.data.synth import generate
from kafka_ps_tpu_torch.models import mlp
from kafka_ps_tpu_torch.ops import fused_update
from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
from kafka_ps_tpu_torch.utils.config import (BufferConfig, ModelConfig,
                                             PSConfig)

pytestmark = pytest.mark.cuda
RTOL, ATOL = 1e-4, 1e-6
MLP_RTOL, MLP_ATOL = 1e-4, 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, batch, features, classes=5, k=2, seed=0, hidden=None):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(batch, features))
         * (rng.random((batch, features)) < 0.5)).astype(np.float32)
    y = rng.integers(1, classes + 1, size=batch).astype(np.int32)
    y[min(1, batch - 1)] = classes + 1      # out of range
    mask = (np.arange(batch) < batch - batch // 10).astype(np.float32)
    cfg = ModelConfig(num_features=features, num_classes=classes,
                      num_max_iter=k, hidden_dim=hidden or 128)
    if hidden is None:
        theta = rng.normal(scale=0.05, size=cfg.num_params)
    else:
        theta = mlp.init_params(cfg, "cpu").numpy() + rng.normal(
            scale=0.01, size=mlp.num_params(cfg))
    theta = theta.astype(np.float32)
    return cfg, [torch.from_numpy(a).to(dev) for a in (theta, x, y, mask)]


@pytest.mark.parametrize("batch,features,classes,k", [
    (1024, 1024, 5, 2), (37, 64, 5, 2), (1, 8, 1, 1), (300, 130, 15, 3),
    (64, 32, 5, 0)])
def test_kernel_matches_plain_version(card, batch, features, classes, k):
    cfg, args = _case(card, batch, features, classes, k)
    before = fused_update.launches
    d, loss = fused_update.local_update(*args, cfg=cfg)
    torch.cuda.synchronize()
    assert fused_update.launches == before + 1
    d_ref, loss_ref = fused_update.local_update_plain(*args, cfg=cfg)
    torch.testing.assert_close(d, d_ref, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(loss, loss_ref, rtol=RTOL, atol=ATOL)


def test_kernel_is_bitwise_repeatable(card):
    cfg, args = _case(card, 1024, 1024)
    d1, l1 = fused_update.local_update(*args, cfg=cfg)
    d2, l2 = fused_update.local_update(*args, cfg=cfg)
    assert torch.equal(d1, d2) and torch.equal(l1, l2)


def test_wrapper_raises_on_bad_cuda_arguments(card):
    cfg, args = _case(card, 64, 64)
    bad = list(args)
    bad[1] = bad[1].double()
    with pytest.raises(TypeError):
        fused_update.local_update(*bad, cfg=cfg)
    bad = list(args)
    bad[1] = bad[1].t().contiguous().t()
    with pytest.raises(ValueError):
        fused_update.local_update(*bad, cfg=cfg)
    bad = list(args)
    bad[0] = bad[0].cpu()
    with pytest.raises(ValueError):
        fused_update.local_update(*bad, cfg=cfg)


def _gang(dev, members, batch, features, hidden=None, shared=False,
          classes=5):
    """A gang's inputs; `shared` True gives every member the first theta,
    False a tensor each, "packed" a view each into one flat tensor (member
    m's theta at m P floats, so at an odd P an odd member's theta is only
    4-byte aligned)."""
    cases = [_case(dev, batch, features, classes, seed=s, hidden=hidden)
             for s in range(members)]
    cfg = cases[0][0]
    thetas, xs, ys, masks = (list(a) for a in zip(*(c[1] for c in cases)))
    if shared == "packed":
        thetas = list(torch.cat(thetas).split(thetas[0].numel()))
    elif shared:
        thetas = [thetas[0]] * members
    return cfg, thetas, xs, ys, masks


@pytest.mark.parametrize("family", ["logreg", "mlp"])
@pytest.mark.parametrize("members,batch,features,shared", [
    (4, 1024, 1024, False), (4, 1024, 1024, True), (3, 37, 64, False),
    (34, 40, 32, True)])
def test_gang_member_is_bitwise_a_single_call(card, family, members, batch,
                                              features, shared):
    """K2 member i == K1 on member i's inputs, K6 member i == K4, bit for
    bit; more than MAX_MEMBERS members split into several calls."""
    hidden = None if family == "logreg" else 100
    cfg, thetas, xs, ys, masks = _gang(card, members, batch, features,
                                       hidden, shared)
    batched, single = {
        "logreg": (fused_update.local_update_batched,
                   fused_update.local_update),
        "mlp": (fused_update.mlp_local_update_batched,
                fused_update.mlp_local_update)}[family]
    deltas, losses = batched(thetas, xs, ys, masks, cfg=cfg)
    assert deltas.shape[0] == losses.shape[0] == members
    for i in range(members):
        d, loss = single(thetas[i], xs[i], ys[i], masks[i], cfg=cfg)
        assert torch.equal(deltas[i], d) and torch.equal(losses[i], loss)


@pytest.mark.parametrize("batch,features,hidden,classes,k", [
    (1024, 1024, 128, 5, 2), (1000, 1024, 100, 5, 2), (37, 64, 32, 5, 2),
    (1, 8, 3, 1, 1), (300, 130, 70, 15, 3), (64, 32, 16, 5, 0)])
def test_mlp_kernel_matches_plain_version(card, batch, features, hidden,
                                          classes, k):
    cfg, args = _case(card, batch, features, classes, k, hidden=hidden)
    before = fused_update.mlp_launches
    d, loss = fused_update.mlp_local_update(*args, cfg=cfg)
    torch.cuda.synchronize()
    assert fused_update.mlp_launches == before + 1
    d_ref, loss_ref = fused_update.mlp_local_update_plain(*args, cfg=cfg)
    torch.testing.assert_close(d, d_ref, rtol=MLP_RTOL, atol=MLP_ATOL)
    torch.testing.assert_close(loss, loss_ref, rtol=MLP_RTOL, atol=MLP_ATOL)
    d2, loss2 = fused_update.mlp_local_update(*args, cfg=cfg)
    assert torch.equal(d, d2) and torch.equal(loss, loss2)


def test_mlp_kernel_all_masked_and_bad_labels(card):
    cfg, args = _case(card, 64, 32, hidden=20)
    args[3] = torch.zeros_like(args[3])
    d, loss = fused_update.mlp_local_update(*args, cfg=cfg)
    assert torch.count_nonzero(d) == 0 and float(loss) == 0.0
    cfg, args = _case(card, 64, 32, hidden=20)
    args[2] = torch.full_like(args[2], cfg.num_classes + 3)
    d, loss = fused_update.mlp_local_update(*args, cfg=cfg)
    # every label out of range: zero gradient and zero NLL
    assert torch.count_nonzero(d) == 0 and float(loss) == 0.0


# -- the wide MLP passes: f32 at H >= WIDE_MIN_HIDDEN, F a multiple of 4 -----


@pytest.mark.parametrize("batch,features,hidden,k", [
    (1000, 1020, 1056, 2), (1024, 1024, 4096, 2), (37, 64, 1024, 1),
    (300, 128, 1100, 3), (64, 32, 1024, 0), (1024, 1024, 1025, 2)])
def test_mlp_wide_passes_match_plain_version(card, batch, features, hidden,
                                             k):
    """K4 on the wide passes (wgmma, TMA): ragged B, F and H (none a
    multiple of the 128-wide tile or the 32-deep chunk; H=1025 makes the
    parameter count P odd), within the MLP's tolerance of the plain
    version, counted as a wide launch, and bitwise repeatable."""
    cfg, args = _case(card, batch, features, 5, k, hidden=hidden)
    before = fused_update.counts()
    d, loss = fused_update.mlp_local_update(*args, cfg=cfg)
    torch.cuda.synchronize()
    after = fused_update.counts()
    assert after["mlp_launches"] == before["mlp_launches"] + 1
    assert after["mlp_wide_launches"] == before["mlp_wide_launches"] + 1
    d_ref, loss_ref = fused_update.mlp_local_update_plain(*args, cfg=cfg)
    torch.testing.assert_close(d, d_ref, rtol=MLP_RTOL, atol=MLP_ATOL)
    torch.testing.assert_close(loss, loss_ref, rtol=MLP_RTOL, atol=MLP_ATOL)
    d2, loss2 = fused_update.mlp_local_update(*args, cfg=cfg)
    assert torch.equal(d, d2) and torch.equal(loss, loss2)


@pytest.mark.parametrize("members,shared,hidden,classes", [
    (1, True, 4096, 5), (4, True, 4096, 5), (4, False, 4096, 5),
    (3, False, 4096, 5), (34, True, 4096, 5), (3, "packed", 4096, 2),
    (3, "packed", 1025, 5)], ids=[
    "1-True", "4-True", "4-False", "3-False", "34-True",
    "3-packed-h4096-c2", "3-packed-h1025-c5"])
def test_mlp_wide_gang_member_is_bitwise_a_single_call(card, members,
                                                       shared, hidden,
                                                       classes):
    """K6 on the wide passes: member i == K4 on member i's inputs bit for
    bit (34 members: two calls of 32 and 2), and two launches are bitwise
    equal.  Member 1's rows of the W scratch and of delta [members, P]
    are only 8-byte aligned at H=4096, C=5 (P even, 2 mod 4), and only
    4-byte aligned, its packed theta's too, where P is odd (C=2, or
    H=1025)."""
    cfg, thetas, xs, ys, masks = _gang(card, members, 1024, 1024, hidden,
                                       shared, classes)
    before = fused_update.counts()
    deltas, losses = fused_update.mlp_local_update_batched(
        thetas, xs, ys, masks, cfg=cfg)
    after = fused_update.counts()
    assert after["mlp_wide_launches"] == before["mlp_wide_launches"] + 1
    again = fused_update.mlp_local_update_batched(thetas, xs, ys, masks,
                                                  cfg=cfg)
    assert torch.equal(deltas, again[0]) and torch.equal(losses, again[1])
    for i in range(members):
        d, loss = fused_update.mlp_local_update(thetas[i], xs[i], ys[i],
                                                masks[i], cfg=cfg)
        assert torch.equal(deltas[i], d) and torch.equal(losses[i], loss)


@pytest.mark.parametrize("members", [1, 4, 34])
def test_mlp_wide_counts_update_tiles_from_the_launch_geometry(card,
                                                               members):
    """A wide K4 or K6 call at H=4096, B=F=1024 adds k launches of 32 x 8
    update tiles a member (34 members: launches of 32 and of 2), of which
    all but one a CTA (one CTA an SM, at most one a tile) overlap the
    CTA's next tile: 1,024 and 892 a launch for 4 members on 132 SMs."""
    cfg, thetas, xs, ys, masks = _gang(card, members, 1024, 1024, 4096,
                                       True)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    k = cfg.num_max_iter
    before = fused_update.counts()
    if members == 1:
        fused_update.mlp_local_update(thetas[0], xs[0], ys[0], masks[0],
                                      cfg=cfg)
    else:
        fused_update.mlp_local_update_batched(thetas, xs, ys, masks,
                                              cfg=cfg)
    after = fused_update.counts()
    launches = [32 * 8 * n for n in (32, members - 32)] if members > 32 \
        else [32 * 8 * members]
    assert after["mlp_wide_update_tiles"] - before[
        "mlp_wide_update_tiles"] == k * sum(launches)
    assert after["mlp_wide_overlapped_tiles"] - before[
        "mlp_wide_overlapped_tiles"] == k * sum(n - min(n, sms)
                                                for n in launches)


def test_mlp_wide_all_masked_and_bad_labels(card):
    cfg, args = _case(card, 64, 32, hidden=1024)
    args[3] = torch.zeros_like(args[3])
    d, loss = fused_update.mlp_local_update(*args, cfg=cfg)
    assert torch.count_nonzero(d) == 0 and float(loss) == 0.0
    cfg, args = _case(card, 64, 32, hidden=1024)
    args[2] = torch.full_like(args[2], cfg.num_classes + 3)
    before = fused_update.mlp_wide_launches
    d, loss = fused_update.mlp_local_update(*args, cfg=cfg)
    assert fused_update.mlp_wide_launches == before + 1
    assert torch.count_nonzero(d) == 0 and float(loss) == 0.0


@pytest.mark.parametrize("features,kind", [(33, "f32"), (32, "bf16"),
                                           (32, "int8")])
def test_mlp_wide_width_keeps_narrow_passes_off_f32(card, features, kind):
    """At H=1024 a ragged F (rows not 16-byte strided) and the stored
    forms (K5) keep the narrow passes: no wide launch, and the plain
    version's tolerance."""
    cfg, args = _case(card, 64, features, hidden=1024)
    args = _in_form(args, kind)
    before = fused_update.mlp_wide_launches
    d, loss = fused_update.mlp_local_update(*args, cfg=cfg)
    torch.cuda.synchronize()
    assert fused_update.mlp_wide_launches == before
    d_ref, loss_ref = fused_update.mlp_local_update_plain(*args, cfg=cfg)
    torch.testing.assert_close(d, d_ref, rtol=MLP_RTOL, atol=MLP_ATOL)
    torch.testing.assert_close(loss, loss_ref, rtol=MLP_RTOL, atol=MLP_ATOL)


@pytest.mark.parametrize("batch,features,hidden,kind", [
    (1024, 1024, 4096, "f32"), (1001, 1020, 1024, "f32"),
    (1024, 1024, 1023, "f32"), (1024, 1022, 4096, "f32"),
    (1024, 1024, 4096, "bf16"), (1024, 1024, 4096, "int8")])
def test_mlp_wide_rule_and_scratch_match_the_library(card, batch, features,
                                                     hidden, kind):
    """fused_update's mirror of the path rule and of the split scratch
    equals what mlp_update.cu decides and sizes (_mlp_scratch raises where
    they differ)."""
    from kafka_ps_tpu_torch.ops import _build
    lib = _build.load(fused_update.MLP_SOURCE)
    form = ("f32", "bf16", "int8").index(kind)
    assert bool(lib.kps_mlp_wide(batch, features, hidden, form)) == \
        fused_update.mlp_wide_path(batch, features, hidden, kind)
    sizes = fused_update._mlp_scratch(batch, features, hidden, 6, 3, kind)
    # the stored forms' entries take no split scratch at all
    want = (fused_update.mlp_wide_scratch(batch, features, hidden, 3, kind)
            if kind == "f32" else ())
    assert sizes[5:] == want


def test_mlp_wide_call_replays_bitwise_in_a_cuda_graph(card):
    """A wide K6 call captured in a CUDA graph (its tensor maps encoded at
    capture from the graph's buffers) replays to the eager call's bits."""
    cfg, thetas, xs, ys, masks = _gang(card, 2, 256, 256, 1024, True)
    eager = fused_update.mlp_local_update_batched(thetas, xs, ys, masks,
                                                  cfg=cfg)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fused_update.mlp_local_update_batched(thetas, xs, ys, masks,
                                                    cfg=cfg)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], eager[0]) and torch.equal(out[1],
                                                             eager[1])


def _serial_run(device, c, task="logreg", **kw):
    cfg = PSConfig(num_workers=3, consistency_model=c, task=task,
                   model=ModelConfig(num_features=64, num_classes=5,
                                     hidden_dim=32),
                   buffer=BufferConfig(min_size=8, max_size=32), **kw)
    x, y = generate(200, 64, 5, seed=2, center_scale=0.3)
    server, worker = [], []
    app = StreamingPSApp(cfg, test_x=x[150:], test_y=y[150:],
                         server_log=server.append, worker_log=worker.append,
                         clock_ms=iter(range(0, 10 ** 9, 40)).__next__,
                         device=device)
    for i in range(150):
        app.data_sink(i % 3, x[i], int(y[i]))
    app.run_serial(30)
    app.close_logs()
    return app, server, worker


@pytest.mark.parametrize("task", ["logreg", "mlp"])
@pytest.mark.parametrize("c", [0, 2, -1])
def test_trainer_on_card_matches_cpu(card, c, task):
    fused_update.reset_counts()
    gpu, gs, gw = _serial_run(card, c, task)
    n = fused_update.counts()
    prefix = "" if task == "logreg" else "mlp_"
    assert (n[f"{prefix}launches"] + n[f"{prefix}batched_members"]
            == len(gw) >= 30)
    cpu, cs, cw = _serial_run("cpu", c, task)
    assert [r.split(";")[1:3] for r in gs] == [r.split(";")[1:3] for r in cs]
    assert [r.split(";")[1:3] + r.split(";")[6:] for r in gw] == \
        [r.split(";")[1:3] + r.split(";")[6:] for r in cw]
    torch.testing.assert_close(gpu.server.theta.cpu(), cpu.server.theta,
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("task", ["logreg", "mlp"])
def test_gang_and_async_eval_are_bitwise_on_card(card, task):
    runs = {(g, e): _serial_run(card, 0, task, use_gang=g, eval_async=e)
            for g in (True, False) for e in (True, False)}

    def strip(rows):
        return [r.split(";", 1)[1] for r in rows]
    ref_app, ref_s, ref_w = runs[(False, False)]
    for app, s, w in runs.values():
        assert torch.equal(app.server.theta, ref_app.server.theta)
        assert strip(s) == strip(ref_s) and strip(w) == strip(ref_w)


def _stored(args, kind):
    """The case's inputs with x in storage form `kind`, encoded on the
    card."""
    return [args[0], encode_x(kind, args[1]), args[2], args[3]]


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("batch,features,classes,k", [
    (1024, 1024, 5, 2), (37, 64, 5, 2), (1, 8, 1, 1), (300, 130, 15, 3),
    (64, 32, 5, 0)])
def test_stream_kernel_matches_plain_version(card, kind, batch, features,
                                             classes, k):
    """K3: the logreg kernel on a bf16 / int8 slab, decoded in the kernel,
    against decode_x + K1's plain version; no K1 launch."""
    cfg, args = _case(card, batch, features, classes, k)
    args = _stored(args, kind)
    before = fused_update.counts()
    d, loss = fused_update.local_update(*args, cfg=cfg)
    torch.cuda.synchronize()
    after = fused_update.counts()
    assert after["stream_launches"] == before["stream_launches"] + 1
    assert after["launches"] == before["launches"]
    d_ref, loss_ref = fused_update.local_update_plain(*args, cfg=cfg)
    torch.testing.assert_close(d, d_ref, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(loss, loss_ref, rtol=RTOL, atol=ATOL)
    d2, loss2 = fused_update.stream_update(*args, cfg=cfg)
    assert torch.equal(d, d2) and torch.equal(loss, loss2)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("batch,features,hidden,classes,k", [
    (1024, 1024, 128, 5, 2), (1000, 1024, 100, 5, 2), (37, 64, 32, 5, 2),
    (1, 8, 3, 1, 1), (64, 32, 16, 5, 0)])
def test_mlp_stream_kernel_matches_plain_version(card, kind, batch,
                                                 features, hidden, classes,
                                                 k):
    """K5: the MLP kernel on a bf16 / int8 slab against decode_x + K4's
    plain version; no K4 launch."""
    cfg, args = _case(card, batch, features, classes, k, hidden=hidden)
    args = _stored(args, kind)
    before = fused_update.counts()
    d, loss = fused_update.mlp_local_update(*args, cfg=cfg)
    torch.cuda.synchronize()
    after = fused_update.counts()
    assert (after["mlp_stream_launches"]
            == before["mlp_stream_launches"] + 1)
    assert after["mlp_launches"] == before["mlp_launches"]
    d_ref, loss_ref = fused_update.mlp_local_update_plain(*args, cfg=cfg)
    torch.testing.assert_close(d, d_ref, rtol=MLP_RTOL, atol=MLP_ATOL)
    torch.testing.assert_close(loss, loss_ref, rtol=MLP_RTOL, atol=MLP_ATOL)
    d2, loss2 = fused_update.mlp_stream_update(*args, cfg=cfg)
    assert torch.equal(d, d2) and torch.equal(loss, loss2)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("family", ["logreg", "mlp"])
@pytest.mark.parametrize("members,batch,features,shared", [
    (4, 1024, 1024, False), (4, 1024, 1024, True), (3, 37, 64, False),
    (34, 40, 32, True)])
def test_stream_gang_member_is_bitwise_a_single_call(card, kind, family,
                                                     members, batch,
                                                     features, shared):
    """The batched K3 (K5) member i == K3 (K5) on member i's stored slab,
    bit for bit; every member's q and scales are pointers of its own."""
    hidden = None if family == "logreg" else 100
    cfg, thetas, xs, ys, masks = _gang(card, members, batch, features,
                                       hidden, shared)
    xs = [encode_x(kind, x) for x in xs]
    batched, single = {
        "logreg": (fused_update.local_update_batched,
                   fused_update.local_update),
        "mlp": (fused_update.mlp_local_update_batched,
                fused_update.mlp_local_update)}[family]
    prefix = "" if family == "logreg" else "mlp_"
    before = fused_update.counts()
    deltas, losses = batched(thetas, xs, ys, masks, cfg=cfg)
    after = fused_update.counts()
    assert (after[f"{prefix}stream_batched_members"]
            == before[f"{prefix}stream_batched_members"] + members)
    assert after[f"{prefix}batched_launches"] == \
        before[f"{prefix}batched_launches"]
    for i in range(members):
        d, loss = single(thetas[i], xs[i], ys[i], masks[i], cfg=cfg)
        assert torch.equal(deltas[i], d) and torch.equal(losses[i], loss)


@pytest.mark.parametrize("task", ["logreg", "mlp"])
def test_int8_trainer_runs_k3_k5_only(card, task):
    """--slab-dtype int8 on the card: every worker step is a K3 (K5) call,
    single or gang member, no f32 kernel runs, and the run matches the
    same run on the CPU."""
    fused_update.reset_counts()
    gpu, gs, gw = _serial_run(card, 0, task, slab_dtype="int8")
    n = fused_update.counts()
    prefix = "" if task == "logreg" else "mlp_"
    assert (n[f"{prefix}stream_launches"]
            + n[f"{prefix}stream_batched_members"] == len(gw) >= 30)
    assert n[f"{prefix}stream_batched_launches"] > 0
    assert all(v == 0 for name, v in n.items() if "stream" not in name)
    cpu, cs, cw = _serial_run("cpu", 0, task, slab_dtype="int8")
    assert [r.split(";")[1:3] for r in gs] == [r.split(";")[1:3] for r in cs]
    torch.testing.assert_close(gpu.server.theta.cpu(), cpu.server.theta,
                               rtol=1e-4, atol=1e-5)


def _in_form(args, kind):
    return list(args) if kind == "f32" else _stored(args, kind)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("batch,features,hidden,classes,k", [
    (1024, 1024, 128, 5, 2), (64, 33, 16, 5, 2), (100, 64, 1, 5, 2),
    (300, 130, 200, 15, 3), (37, 33, 200, 5, 1)])
def test_mlp_tensor_core_passes_any_shape_and_form(card, kind, batch,
                                                   features, hidden,
                                                   classes, k):
    """K4 and K5 on the tensor-core passes: F=33 (rows not 16-byte
    aligned in any form), H=1 and H=200 (not a multiple of the 32-wide
    tile), and the main path's shape, within the f32 tolerance of the
    plain version and bitwise repeatable."""
    cfg, args = _case(card, batch, features, classes, k, hidden=hidden)
    args = _in_form(args, kind)
    name = "mlp_launches" if kind == "f32" else "mlp_stream_launches"
    before = fused_update.counts()[name]
    d, loss = fused_update.mlp_local_update(*args, cfg=cfg)
    torch.cuda.synchronize()
    assert fused_update.counts()[name] == before + 1
    d_ref, loss_ref = fused_update.mlp_local_update_plain(*args, cfg=cfg)
    torch.testing.assert_close(d, d_ref, rtol=MLP_RTOL, atol=MLP_ATOL)
    torch.testing.assert_close(loss, loss_ref, rtol=MLP_RTOL, atol=MLP_ATOL)
    d2, loss2 = fused_update.mlp_local_update(*args, cfg=cfg)
    assert torch.equal(d, d2) and torch.equal(loss, loss2)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_mlp_gang_of_34_is_bitwise_single_calls(card, kind):
    """34 members (two kernel calls of 32 and 2) at F=33, H=200: each
    member bitwise equal to a single call, and the gang within tolerance
    of the plain version."""
    cfg, thetas, xs, ys, masks = _gang(card, 34, 40, 33, hidden=200)
    xs = [x if kind == "f32" else encode_x(kind, x) for x in xs]
    deltas, losses = fused_update.mlp_local_update_batched(
        thetas, xs, ys, masks, cfg=cfg)
    for i in range(34):
        d, loss = fused_update.mlp_local_update(thetas[i], xs[i], ys[i],
                                                masks[i], cfg=cfg)
        assert torch.equal(deltas[i], d) and torch.equal(losses[i], loss)
    d_ref, loss_ref = fused_update.mlp_local_update_batched_plain(
        thetas, xs, ys, masks, cfg=cfg)
    torch.testing.assert_close(deltas, d_ref, rtol=MLP_RTOL, atol=MLP_ATOL)
    torch.testing.assert_close(losses, loss_ref, rtol=MLP_RTOL,
                               atol=MLP_ATOL)


def _kernels(fn, reps=10) -> dict[str, int]:
    """The CUDA kernels `reps` calls of `fn` launch, by name, from
    torch.profiler (which can drop an event now and then, never add one)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0)) > 0}


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("batch,features,classes,k,resident", [
    (16384, 1024, 5, 2, None),  # more x than one wave of shared memory
    (16, 70000, 5, 2, 0),       # a row wider than a CTA's shared memory
    (300, 130, 15, 0, 1),       # R=16, k=0
    (1020, 33, 15, 2, 1)])      # R=16, a ragged last tile, F=33
def test_logreg_kernel_resident_or_restaged_matches_plain(
        card, kind, batch, features, classes, k, resident):
    """K1/K3 whether x stays resident in shared memory for the call or is
    re-staged at each step (in column chunks where a row is wider than a
    CTA's shared memory): within tolerance of the plain version, bitwise
    repeatable, and one CUDA launch per call."""
    cfg, args = _case(card, batch, features, classes, k)
    args = _in_form(args, kind)
    plan = fused_update.logreg_plan(batch, features, cfg.num_rows, 1, kind)
    if resident is not None:
        assert plan["resident"] == resident
    if features == 70000:
        assert plan["chunks"] > 1
    d, loss = fused_update.local_update(*args, cfg=cfg)
    torch.cuda.synchronize()
    d_ref, loss_ref = fused_update.local_update_plain(*args, cfg=cfg)
    torch.testing.assert_close(d, d_ref, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(loss, loss_ref, rtol=RTOL, atol=ATOL)
    d2, loss2 = fused_update.local_update(*args, cfg=cfg)
    assert torch.equal(d, d2) and torch.equal(loss, loss2)
    # one kernel, launched at most once a call
    seen = _kernels(lambda: fused_update.local_update(*args, cfg=cfg))
    assert len(seen) == 1 and "logreg_update" in next(iter(seen))
    assert 1 <= sum(seen.values()) <= 10


def test_logreg_slab_beyond_one_wave_is_restaged(card):
    """B=16384, F=1024 f32 (64 MiB of x) cannot stay resident: the plan
    re-stages its tiles, several per CTA, and the main shape keeps one
    resident tile per CTA."""
    big = fused_update.logreg_plan(16384, 1024, 6, 1, "f32")
    assert big["resident"] == 0 and big["tiles_per_cta"] > 1
    main = fused_update.logreg_plan(1024, 1024, 6, 1, "f32")
    assert main["resident"] == 1 and main["tiles_per_cta"] == 1
    assert main["grid"] == 1024 // 8


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_logreg_gang_beyond_one_wave_is_bitwise_single_calls(card, kind):
    """34 members at the main shape: the first kernel call (32 members,
    more x than the card's shared memory holds) re-stages its tiles, the
    second (2 members) and every single call keep theirs resident; each
    member is bitwise the single call, and the gang is within tolerance
    of the plain version."""
    cfg, thetas, xs, ys, masks = _gang(card, 34, 1024, 1024)
    xs = [x if kind == "f32" else encode_x(kind, x) for x in xs]
    R = cfg.num_rows
    assert fused_update.logreg_plan(1024, 1024, R, 32, kind)["resident"] == 0
    assert fused_update.logreg_plan(1024, 1024, R, 2, kind)["resident"] == 1
    deltas, losses = fused_update.local_update_batched(thetas, xs, ys, masks,
                                                       cfg=cfg)
    for i in range(34):
        d, loss = fused_update.local_update(thetas[i], xs[i], ys[i],
                                            masks[i], cfg=cfg)
        assert torch.equal(deltas[i], d) and torch.equal(losses[i], loss)
    d_ref, loss_ref = fused_update.local_update_batched_plain(
        thetas, xs, ys, masks, cfg=cfg)
    torch.testing.assert_close(deltas, d_ref, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(losses, loss_ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_logreg_two_launches_bitwise_at_main_shape(card, kind):
    """Two calls at the main path's shape, single and as a gang of 4, give
    the same bits: no sum depends on which CTA ran a tile or when."""
    cfg, thetas, xs, ys, masks = _gang(card, 4, 1024, 1024)
    xs = [x if kind == "f32" else encode_x(kind, x) for x in xs]
    one = [fused_update.local_update(thetas[0], xs[0], ys[0], masks[0],
                                     cfg=cfg) for _ in range(2)]
    gang = [fused_update.local_update_batched(thetas, xs, ys, masks,
                                              cfg=cfg) for _ in range(2)]
    for a, b in (one, gang):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# -- the fused BSP path (parallel/bsp.py, run_fused_bsp) -----------------------

# K4/K6 at H=4096 hold the MLP's tolerance, but for the last member of the
# gang below: its float32 update is ill-conditioned (after the first step
# the logits reach ~100, where a relu gate or a softmax near-tie flips
# with the summation order; on the CPU the plain version strays from a
# float64 update on a few hundred of the 4.2M elements), so there the
# kernel holds it on all but OUTLIER_SHARE of delta's elements, each
# within OUTLIER_ABS (tests/test_torch_mlp_wide.py, chip_smoke.py)
OUTLIER_SHARE, OUTLIER_ABS = 5e-4, 5e-4


@pytest.mark.parametrize("hidden", [4096])
def test_wide_mlp_kernels_match_plain_and_share_theta(card, hidden):
    cfg, args = _case(card, 1024, 1024, hidden=hidden)
    theta = args[0]
    gang = [args[1:]] + [_case(card, 1024, 1024, seed=s, hidden=hidden)[1][1:]
                         for s in (1, 2, 3)]
    members = [[theta] * 4] + [[g[i] for g in gang] for i in range(3)]
    d, loss = fused_update.mlp_local_update(*args, cfg=cfg)
    ref = fused_update.mlp_local_update_plain(*args, cfg=cfg)
    torch.testing.assert_close(d, ref[0], rtol=MLP_RTOL, atol=MLP_ATOL)
    torch.testing.assert_close(loss, ref[1], rtol=MLP_RTOL, atol=MLP_ATOL)
    before = fused_update.mlp_batched_launches
    b = fused_update.mlp_local_update_batched(*members, cfg=cfg)
    assert fused_update.mlp_batched_launches == before + 1
    bref = fused_update.mlp_local_update_batched_plain(*members, cfg=cfg)
    torch.testing.assert_close(b[0][:3], bref[0][:3], rtol=MLP_RTOL,
                               atol=MLP_ATOL)
    err = (b[0][3] - bref[0][3]).abs()
    outside = err > MLP_ATOL + MLP_RTOL * bref[0][3].abs()
    assert int(outside.sum()) <= OUTLIER_SHARE * err.numel()
    assert float(err.max()) <= OUTLIER_ABS
    torch.testing.assert_close(b[1], bref[1], rtol=MLP_RTOL, atol=MLP_ATOL)
    assert torch.equal(b[0][0], d) and torch.equal(b[1][0], loss)
    for i, m in enumerate(zip(*members)):
        s = fused_update.mlp_local_update(*m, cfg=cfg)
        assert torch.equal(b[0][i], s[0]) and torch.equal(b[1][i], s[1])


@pytest.mark.parametrize("task,hidden", [("logreg", 128), ("mlp", 128),
                                         ("mlp", 4096)])
def test_graph_chunk_is_bitwise_eager_rounds(card, task, hidden):
    from kafka_ps_tpu_torch.models.task import get_task
    from kafka_ps_tpu_torch.parallel import bsp
    cases = [_case(card, 256, 1024, seed=s,
                   hidden=hidden if task == "mlp" else None)
             for s in range(4)]
    cfg = cases[0][0]
    t = get_task(task, cfg)
    theta = cases[0][1][0]
    slab = [torch.stack([c[1][i] for c in cases]) for i in (1, 2, 3)]
    step = bsp.make_bsp_step(cfg, 4, 0.25, task=t)
    multi = bsp.make_bsp_multi_step(cfg, 4, 0.25, 8, task=t)

    def eager(th):
        losses = []
        for _ in range(8):
            th, loss = step(th, *slab)
            losses.append(loss)
        return th, torch.stack(losses)

    key = "batched_launches" if task == "logreg" else "mlp_batched_launches"
    fused_update.reset_counts()
    g1 = multi(theta, *slab)
    assert fused_update.counts()[key] == 8      # one replay, 8 calls
    g2 = multi(g1[0], *slab)
    assert multi.captures == 1 and fused_update.counts()[key] == 16
    e1 = eager(theta)
    e2 = eager(e1[0])
    slab[0].mul_(0.5)          # a slab written in place is copied again
    g3, e3 = multi(theta, *slab), eager(theta)
    for a, b in zip((*g1, *g2, *g3), (*e1, *e2, *e3)):
        assert torch.equal(a, b)
    assert not torch.equal(g3[0], g1[0])


@pytest.mark.parametrize("task", ["logreg", "mlp"])
@pytest.mark.parametrize("eval_every", [1, 10])
def test_fused_trainer_on_card_matches_cpu(card, task, eval_every):
    def run(device):
        cfg = PSConfig(num_workers=3, consistency_model=0, task=task,
                       model=ModelConfig(num_features=64, num_classes=5,
                                         hidden_dim=32),
                       buffer=BufferConfig(min_size=8, max_size=32),
                       eval_every=eval_every)
        x, y = generate(200, 64, 5, seed=2, center_scale=0.3)
        server, worker = [], []
        app = StreamingPSApp(cfg, test_x=x[150:], test_y=y[150:],
                             server_log=server.append,
                             worker_log=worker.append,
                             clock_ms=iter(range(0, 10 ** 9, 40)).__next__,
                             device=device)
        for i in range(150):
            app.data_sink(i % 3, x[i], int(y[i]))
        app.run_fused_bsp(60)
        app.close_logs()
        return app, server, worker

    fused_update.reset_counts()
    gpu, gs, gw = run(card)
    prefix = "" if task == "logreg" else "mlp_"
    assert fused_update.counts()[f"{prefix}batched_launches"] == 20
    assert fused_update.counts()[f"{prefix}launches"] == 0
    cpu, cs, cw = run("cpu")
    assert [r.split(";")[1:3] for r in gs] == [r.split(";")[1:3] for r in cs]
    assert [r.split(";")[1:3] + r.split(";")[6:] for r in gw] == \
        [r.split(";")[1:3] + r.split(";")[6:] for r in cw]
    torch.testing.assert_close(gpu.server.theta.cpu(), cpu.server.theta,
                               rtol=1e-4, atol=1e-5)


# -- the codecs of --compress (compress/codecs.py) ---------------------------

@pytest.mark.parametrize("n", [6150, 131974, 4222982])
@pytest.mark.parametrize("name", ["bf16", "int8", "topk:0.01"])
def test_codec_parts_on_the_card_equal_the_cpu(card, name, n):
    from kafka_ps_tpu_torch import compress
    from kafka_ps_tpu_torch.compress.codecs import Codec
    codec = compress.get_codec(compress.parse_codec(name), n)
    v = torch.from_numpy((np.random.default_rng(n).standard_normal(n)
                          * 0.1).astype(np.float32))
    on_card = Codec.host_parts(codec.encode(v.to(card)))
    on_cpu = Codec.host_parts(codec.encode(v))
    for a, b in zip(on_card, on_cpu):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert torch.equal(codec.decode(*on_cpu, device=card).cpu(),
                       codec.decode(*on_cpu, device="cpu"))


@pytest.mark.parametrize("name", ["bf16", "int8", "topk:0.01"])
def test_error_feedback_continues_after_a_restore_on_the_card(card, name):
    from kafka_ps_tpu_torch import compress
    n = 131974
    codec = compress.get_codec(compress.parse_codec(name), n)
    gen = torch.Generator(device=card).manual_seed(3)
    deltas = [torch.randn(n, generator=gen, device=card) * 0.1
              for _ in range(12)]
    ef = compress.ErrorFeedback(codec, card)
    for d in deltas[:6]:
        ef.step(d)
    restored = compress.ErrorFeedback(codec, card)
    restored.restore(ef.state())
    assert restored.residual.device.type == "cuda"
    for d in deltas[6:]:
        a, ea = ef.step(d)
        b, eb = restored.step(d)
        assert torch.equal(a, b) and torch.equal(ef.residual,
                                                 restored.residual)
        assert all(torch.equal(p, q) for p, q in zip(ea.parts, eb.parts))


def test_int8_slab_encode_on_the_card_equals_the_cpu(card):
    """quantize_rows divides by a tensor 127: a Python 127.0 makes the
    CUDA kernel multiply by the reciprocal, 1 ulp off on some rows (61 of
    these 1024)."""
    from kafka_ps_tpu_torch.compress.slab import quantize_rows
    x, _ = generate(1024, 1024, 5, seed=7)
    x = torch.from_numpy(x)
    q_card, s_card = quantize_rows(x.to(card))
    q_cpu, s_cpu = quantize_rows(x)
    assert torch.equal(s_card.cpu(), s_cpu)
    assert torch.equal(q_card.cpu(), q_cpu)
    stored = encode_x("int8", x.to(card))
    assert torch.equal(stored.scale.cpu(), encode_x("int8", x).scale)


# -- serde and the durable log on the card (runtime/serde.py, log/) ----------

@pytest.mark.parametrize("codec_name", ["none", "bf16", "int8", "topk:0.01"])
def test_serde_frames_of_card_tensors_equal_the_cpu_bytes(card, codec_name):
    """to_bytes of a message whose tensors are on the card gives the CPU
    message's bytes; from_bytes puts the values back on the card,
    bitwise."""
    from kafka_ps_tpu_torch import compress
    from kafka_ps_tpu_torch.runtime import serde
    from kafka_ps_tpu_torch.runtime.messages import (GradientMessage,
                                                     KeyRange)
    n = 6150
    v = torch.from_numpy(np.random.default_rng(5).standard_normal(
        n).astype(np.float32))
    msgs = {}
    for dev in ("cpu", card):
        values, enc = v.to(dev), None
        if codec_name != "none":
            codec = compress.get_codec(compress.parse_codec(codec_name), n)
            values, parts = codec.roundtrip(values)
            enc = codec.encoded(parts)
        msgs[str(dev)] = GradientMessage(vector_clock=3,
                                         key_range=KeyRange(0, n),
                                         values=values, encoded=enc,
                                         worker_id=1)
    blob = serde.to_bytes(msgs["cuda"])
    assert blob == serde.to_bytes(msgs["cpu"])
    out = serde.from_bytes(blob)              # the card by default
    assert out.values.device.type == "cuda"
    assert torch.equal(out.values, msgs["cuda"].values)
    if codec_name != "none":
        assert all(p.device.type == "cuda" for p in out.encoded.parts)
        assert serde.to_bytes(out) == blob


def test_durable_restart_on_the_card_is_bitwise_uninterrupted(card,
                                                             tmp_path):
    """A durable serial -c 0 run on the card abandoned after a commit
    point, restored and replayed onto the card, ends with the θ and
    clocks of an uninterrupted run on the card."""
    from kafka_ps_tpu_torch.log import DurableFabric, LogConfig
    from kafka_ps_tpu_torch.runtime import fabric as fabric_mod

    x, y = generate(200, 64, 5, seed=2, center_scale=0.3)
    cfg = PSConfig(num_workers=4, consistency_model=0,
                   model=ModelConfig(num_features=64, num_classes=5),
                   buffer=BufferConfig(min_size=8, max_size=32))

    def app(fabric=None):
        a = StreamingPSApp(cfg, test_x=x[150:], test_y=y[150:],
                           clock_ms=lambda: 0.0, device=card, fabric=fabric)
        a.server.checkpoint_path = str(tmp_path / "ck.npz")
        a.server.checkpoint_every = 16
        a.server.checkpoint_buffers = a.buffers
        return a

    base = app()
    base.server.checkpoint_path = None
    for i in range(150):
        base.data_sink(i % 4, x[i], int(y[i]))
    base.run_serial(60)
    first = app(DurableFabric(str(tmp_path / "wal"), LogConfig(fsync="none")))
    for i in range(150):
        first.data_sink(i % 4, x[i], int(y[i]))
    first.run_serial(40)                     # abandoned past a commit
    again = app(DurableFabric(str(tmp_path / "wal"), LogConfig(fsync="none")))
    assert again.restore_checkpoint(str(tmp_path / "ck.npz"))
    counts = again.recover_durable()
    assert counts[fabric_mod.GRADIENTS_TOPIC] > 0
    queued = again.fabric._queues[(fabric_mod.WEIGHTS_TOPIC, 0)]
    assert queued and queued[0][1].values.device.type == card.type
    again.run_serial(60)
    assert torch.equal(again.server.theta, base.server.theta)
    assert again.server.tracker.clocks == base.server.tracker.clocks
    assert again.server.duplicate_gradients_dropped > 0
    for a in (base, first, again):
        a.close_logs()


@pytest.mark.parametrize("task,slab", [("logreg", "f32"), ("mlp", "f32"),
                                       ("logreg", "int8"), ("mlp", "bf16")])
def test_one_bridge_round_on_the_card_is_bitwise_in_process(card, task,
                                                            slab):
    """One -c 0 round through a localhost ServerBridge/WorkerBridge pair
    (tests/torch_split_round.py) at the reference width: the gradients
    decode onto the card, and they and the theta the server holds after
    applying them are bitwise the in-process round's; each worker's
    iteration ran the family's kernel once."""
    from torch_split_round import bridge_round
    fused_update.reset_counts()
    (ref_grads, ref_theta), (grads, theta) = bridge_round(
        card, task, features=1024, classes=5, hidden=128, workers=4,
        rows=256, slab=slab)
    for a, b in zip(ref_grads, grads):
        assert b.values.device.type == "cuda"
        assert torch.equal(a.values, b.values)
    assert torch.equal(ref_theta, theta) and theta.device.type == "cuda"
    n = fused_update.counts()
    key = (("" if task == "logreg" else "mlp_")
           + ("" if slab == "f32" else "stream_") + "launches")
    assert n[key] == 8 and sum(n.values()) == 8


# -- the scale-out paths on the card (tests/torch_scaleout_runs.py) ----------


def _scaleout_cfg(c=0, task="logreg"):
    from torch_scaleout_runs import config
    return config(c, task, features=64, classes=5, hidden=32, workers=4,
                  rows=32)


@pytest.mark.parametrize("task", ["logreg", "mlp"])
def test_sharded_groups_assemble_the_n1_theta_on_the_card(card, task):
    from torch_scaleout_runs import dataset, group_run
    cfg = _scaleout_cfg(0, task)
    x, y = dataset(cfg, 128)
    one, _ = group_run(card, 1, cfg, 24, x, y)
    for n in (2, 4):
        many, _ = group_run(card, n, cfg, 24, x, y)
        assert many.assembled_theta().device.type == "cuda"
        assert torch.equal(many.assembled_theta(), one.assembled_theta())


def test_sparse_slices_match_the_dense_apply_on_the_card(card):
    from torch_scaleout_runs import dataset, group_run
    cfg = _scaleout_cfg(-1)
    x, y = dataset(cfg, 128)
    one, _ = group_run(card, 1, cfg, 24, x, y, topk="topk:0.05")
    two, _ = group_run(card, 2, cfg, 24, x, y, topk="topk:0.05")
    assert sum(s.sparse_applies for s in two.shards) > 0
    assert torch.equal(two.assembled_theta(), one.assembled_theta())


@pytest.mark.parametrize("c", [0, 3, -1])
def test_n1_aggregator_is_bitwise_direct_on_the_card(card, c):
    from torch_scaleout_runs import aggregated_run, dataset, direct_run
    cfg = _scaleout_cfg(c)
    x, y = dataset(cfg, 128)
    test = dataset(cfg, 64, seed=1)
    direct = direct_run(card, cfg, 24, x, y, test)
    agg = aggregated_run(card, cfg, 24, x, y, test)
    assert torch.equal(agg.server.theta, direct.server.theta)
    assert [r.split(";", 1)[1] for r in agg.rows] == \
        [r.split(";", 1)[1] for r in direct.rows]
    if c == 0:
        plain = aggregated_run(card, cfg, 24, x, y, test, codec="int8")
        again = aggregated_run(card, cfg, 24, x, y, test, codec="int8",
                               restart_at=3)
        assert torch.equal(plain.server.theta, again.server.theta)
        direct8 = direct_run(card, dataclasses.replace(cfg,
                                                       compress="int8"),
                             24, x, y, test)
        assert torch.equal(direct8.server.theta, plain.server.theta)


@pytest.mark.parametrize("task,slab", [("logreg", "f32"), ("mlp", "bf16")])
def test_one_sharded_bridge_round_on_the_card_is_bitwise(card, task, slab):
    """One -c 0 round at the reference width through two shard servers
    behind localhost bridges: the workers' deltas and the assembled
    theta are bitwise the unsharded in-process round's."""
    from torch_scaleout_runs import sharded_bridge_round
    (ref_grads, ref_theta), (grads, theta) = sharded_bridge_round(
        card, task, shards=2, features=1024, classes=5, hidden=128,
        workers=4, rows=256, slab=slab)
    for a, b in zip(ref_grads, grads):
        assert torch.equal(a.values, b.values)
    assert torch.equal(ref_theta, theta) and theta.device.type == "cuda"


# -- the serving plane on the card (tests/torch_serving_runs.py) -------------


@pytest.mark.parametrize("task,hidden", [("logreg", 128), ("mlp", 128),
                                         ("mlp", 4096)])
def test_serving_engine_on_the_card_matches_the_cpu(card, task, hidden):
    """The engine's answers on the card against its answers on the CPU
    from the same snapshot at F=1024, C=5, at every bucket size 1..16:
    confidences within rtol 1e-5, atol 1e-6, labels equal wherever the
    top-two logit margin exceeds 1e-5."""
    from torch_serving_runs import engine_card_vs_cpu
    out = engine_card_vs_cpu(card, task, hidden)
    assert out["snapshot_device"] == "cuda" and out["clock"] == 6
    assert out["within"], out
    assert out["label_mismatches"] == 0 and out["defined"] >= 14, out


@pytest.mark.parametrize("c", [0, 3, -1])
def test_serving_does_not_perturb_a_serial_run_on_the_card(card, c):
    """A serial run on the card under a live read load: theta and the
    rows bitwise the same run without serving."""
    from torch_serving_runs import read_load_run, serve_config, strip_ts
    cfg = serve_config(c)
    on = read_load_run(cfg, card, serve=True)
    off = read_load_run(cfg, card, serve=False)
    assert on["stats"]["requests"] > 0 and on["stats"]["errors"] == 0
    assert torch.equal(on["theta"], off["theta"])
    assert strip_ts(on["worker"]) == strip_ts(off["worker"])
    assert strip_ts(on["server"]) == strip_ts(off["server"])


# -- tiered residency on the card (store/) -------------------------------------


def test_param_page_slab_on_the_card(card):
    """The hot tier holds its pages on the card: a host page is uploaded
    and counted, a card tensor is kept as it is, a tensor elsewhere is
    refused, and the demotion's fetch gives back the same bytes."""
    from kafka_ps_tpu_torch.compress.slab import ParamPageSlab
    slab = ParamPageSlab(card)
    host = np.random.default_rng(0).normal(size=1024).astype(np.float32)
    t = slab.put(0, host)
    assert t.device.type == "cuda" and slab.uploads == 1
    assert slab.bytes_uploaded == host.nbytes
    on_card = torch.ones(512, device=card)
    assert slab.put(1, on_card) is on_card and slab.uploads == 1
    assert slab.device_bytes() == host.nbytes + on_card.nbytes
    with pytest.raises(ValueError, match="hot tier"):
        slab.put(2, torch.ones(4))
    assert slab.pop_host(0).tobytes() == host.tobytes()
    assert slab.device_bytes() == on_card.nbytes


def _tier_run(dev, c, task, cold_dir=None, iters=24):
    from kafka_ps_tpu_torch.utils.config import StreamConfig, TierConfig
    x, y = generate(160, 32, 3, seed=2)
    tier = TierConfig()
    if cold_dir is not None:
        # 99 (logreg) or 627 (the MLP at H=16) parameters in pages of 8:
        # two pages hot, three warm, the rest cold
        tier = TierConfig(hot_bytes=64, warm_bytes=96, page_params=8,
                          rebalance_interval_s=0.002)
    cfg = PSConfig(num_workers=3, consistency_model=c, task=task,
                   model=ModelConfig(num_features=32, num_classes=3,
                                     hidden_dim=16),
                   buffer=BufferConfig(min_size=8, max_size=48),
                   stream=StreamConfig(time_per_event_ms=1.0), tier=tier)
    server, worker = [], []
    app = StreamingPSApp(cfg, test_x=x[-32:], test_y=y[-32:],
                         server_log=server.append, worker_log=worker.append,
                         device=dev)
    store = app.enable_tiering(cold_dir)
    for i in range(128):
        app.data_sink(i % 3, {j: float(v) for j, v in enumerate(x[i]) if v},
                      int(y[i]))
    app.run_serial(iters)
    stats = store.stats() if store is not None else None
    theta = app.server.theta.cpu()
    app.close_tiering()
    app.close_logs()
    strip = [[r.split(";")[1:] for r in rows] for rows in (server, worker)]
    return theta, strip, stats


@pytest.mark.parametrize("task", ["logreg", "mlp"])
@pytest.mark.parametrize("c", [0, 2, -1])
def test_capped_run_is_bitwise_resident_on_the_card(card, tmp_path, c, task):
    """Per-page applies on the card (warm pages uploaded, applied there
    and fetched back) and the eval applies on the assembled slice give
    the resident run's bits: theta and the rows."""
    theta, rows, _ = _tier_run(card, c, task)
    ctheta, crows, stats = _tier_run(card, c, task, str(tmp_path / "cold"))
    assert torch.equal(ctheta, theta) and crows == rows
    assert stats["faults"] > 0 and stats["demotions"] > 0
    assert stats["device_bytes"] <= 64
    assert stats["host_upload_bytes"] > 0 and stats["host_fetch_bytes"] > 0


def test_per_page_apply_is_bitwise_the_full_apply_on_the_card(card):
    from kafka_ps_tpu_torch.runtime.messages import KeyRange
    from kafka_ps_tpu_torch.store import TieredParamStore
    rng = np.random.default_rng(3)
    n, page, lr = 70001, 4096, 0.25
    theta = torch.tensor(rng.normal(size=n).astype(np.float32), device=card)
    delta = torch.tensor(rng.normal(size=n).astype(np.float32), device=card)
    full = theta + lr * delta
    store = TieredParamStore(theta, KeyRange(0, n), hot_bytes=8 * page * 4,
                             page_params=page, device=card)
    for i, kr, value in store.pin_pages(KeyRange(0, n)):
        store.update_page(i, store.to_device(value)
                          + lr * delta[kr.start:kr.end])
    assert torch.equal(store.assembled_tensor(), full)
    assert store.assembled().tobytes() == full.cpu().numpy().tobytes()
    store.close()


# -- telemetry on the card (kafka_ps_tpu_torch/telemetry/, utils/trace.py) --

def _telemetry_run(device, c, task, on):
    """_serial_run with the tracer, the registry and the flight recorder
    all on, or all off."""
    from kafka_ps_tpu_torch.telemetry import FLIGHT, Telemetry
    from kafka_ps_tpu_torch.utils.trace import Tracer
    kw = {}
    if on:
        tracer = Tracer(counter_sample_s=0.0)
        kw = {"tracer": tracer, "telemetry": Telemetry(tracer=tracer)}
        FLIGHT.enable(role="run")
    try:
        cfg = PSConfig(num_workers=3, consistency_model=c, task=task,
                       model=ModelConfig(num_features=64, num_classes=5,
                                         hidden_dim=32),
                       buffer=BufferConfig(min_size=8, max_size=32))
        x, y = generate(200, 64, 5, seed=2, center_scale=0.3)
        server, worker = [], []
        app = StreamingPSApp(cfg, test_x=x[150:], test_y=y[150:],
                             server_log=server.append,
                             worker_log=worker.append,
                             clock_ms=iter(range(0, 10 ** 9, 40)).__next__,
                             device=device, **kw)
        for i in range(150):
            app.data_sink(i % 3, x[i], int(y[i]))
        fused_update.reset_counts()
        app.run_serial(30)
        app.close_logs()
        return app, server, worker, fused_update.counts(), kw
    finally:
        FLIGHT.disable()


@pytest.mark.parametrize("task", ["logreg", "mlp"])
@pytest.mark.parametrize("c", [0, 2, -1])
def test_telemetry_on_is_bitwise_off_on_the_card(card, c, task):
    def strip(rows):
        return [r.split(";", 1)[1] for r in rows]
    off_app, off_s, off_w, off_n, _ = _telemetry_run(card, c, task, False)
    on_app, on_s, on_w, on_n, kw = _telemetry_run(card, c, task, True)
    assert torch.equal(on_app.server.theta, off_app.server.theta)
    assert strip(on_s) == strip(off_s) and strip(on_w) == strip(off_w)
    assert on_n == off_n                   # the same kernel launches
    snap = kw["telemetry"].snapshot()
    assert sum(snap["gradients_applied_total"].values()) == 30
    assert kw["tracer"].counters()["server.gradients_applied"] == 30


@pytest.mark.parametrize("task,symbol", [("logreg", "logreg_update"),
                                         ("mlp", "hidden_pass")])
def test_telemetry_device_trace_names_the_hand_kernels(card, task, symbol,
                                                        tmp_path):
    from kafka_ps_tpu_torch.utils import trace
    with trace.device_trace(str(tmp_path), card):
        _telemetry_run(card, 0, task, False)
    names = trace.kernel_names(trace.device_trace_path(str(tmp_path)))
    assert any(symbol in name for name in names), sorted(names)[:20]
    with pytest.raises(RuntimeError, match="no CUDA kernel"):
        with trace.device_trace(str(tmp_path / "idle"), card):
            pass                           # nothing ran on the card


@pytest.mark.parametrize("task,slab", [("logreg", "f32"), ("mlp", "f32"),
                                       ("logreg", "int8")])
def test_traced_bridge_round_on_the_card_is_bitwise_the_untraced(card, task,
                                                                 slab):
    """The bridge round with a tracer and a registry on both sides
    (tests/torch_split_round.py): trace context negotiated, every
    gradients and weights frame 16 bytes longer (the flow id suffix), and
    the gradients and theta bitwise the untraced round's."""
    from torch_split_round import bridge_round
    from kafka_ps_tpu_torch.telemetry import Telemetry
    from kafka_ps_tpu_torch.utils.trace import Tracer

    def obs(role):
        tracer = Tracer()
        return tracer, Telemetry(tracer=tracer)

    kw = dict(features=1024, classes=5, hidden=128, workers=4, rows=256,
              slab=slab)
    plain, traced = {}, {}
    _, (grads, theta) = bridge_round(card, task, info=plain, **kw)
    _, (tgrads, ttheta) = bridge_round(card, task, obs=obs, info=traced,
                                       **kw)
    assert torch.equal(theta, ttheta)
    assert all(torch.equal(a.values, b.values)
               for a, b in zip(grads, tgrads))
    assert (plain["trace_negotiated"], traced["trace_negotiated"]) == \
        (False, True)
    for side, topic in (("worker_wire", "gradients"),
                        ("server_wire", "weights")):
        a, b = plain[side][topic], traced[side][topic]
        assert a["frames_out"] == b["frames_out"] > 0
        assert b["bytes_out"] - a["bytes_out"] == 16 * b["frames_out"]


SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


def test_fused_device_spans_sit_on_their_kernels_without_a_sync(
        card, monkeypatch, tmp_path):
    """A traced fused MLP call at H=4096 under torch.profiler: each
    bsp.step device span starts within 0.5 ms of its dispatch's first
    device operation (the span placed on the epoch by wallClockT0) and
    lasts within 5 % of its operations' extent; a dispatch's operations
    are the kernels and copies launched inside its bsp.step profiler
    range (by correlation id).  A chunk opens with the copies into its
    graph's static inputs, so where the host is behind, as at a call's
    first dispatch, its first program kernel waits for the graph's
    launch: that offset is printed, not held.  Before the exit's log
    flush the call synchronises once, for the tracer's clock anchor: no
    round waits."""
    from torch.profiler import ProfilerActivity, profile

    from kafka_ps_tpu_torch.utils import asynclog
    from kafka_ps_tpu_torch.utils.trace import Tracer
    # no drain thread fetch (a synchronise of its own) inside the call
    monkeypatch.setattr(asynclog, "DRAIN_INTERVAL_S", 3600.0)
    n, rows = 4, 1024
    cfg = PSConfig(num_workers=n, consistency_model=0, task="mlp",
                   model=ModelConfig(num_features=1024, num_classes=5,
                                     hidden_dim=4096),
                   buffer=BufferConfig(min_size=rows, max_size=rows),
                   eval_every=10)
    x, y = generate(n * rows + 500, 1024, 5, seed=3, center_scale=0.3)
    tracer = Tracer()
    app = StreamingPSApp(cfg, test_x=x[n * rows:], test_y=y[n * rows:],
                         device=card, tracer=tracer)
    for i in range(n * rows):
        app.data_sink(i % n, x[i], int(y[i]))
    app.run_fused_bsp(n * 20)       # kernels built, the chunk captured
    tracer.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        app.run_fused_bsp(app.server.iterations + n * 30)
    app.close_logs()
    events = list(prof.profiler.kineto_results.events())
    data = json.load(open(tracer.dump(str(tmp_path / "t.json"))))
    spans = sorted((e for e in data["traceEvents"]
                    if e["ph"] == "X" and e["name"] == "bsp.step"),
                   key=lambda e: e["ts"])
    host = sorted((e for e in events if e.name() == "bsp.step"
                   and not str(e.device_type()).endswith("CUDA")),
                  key=lambda e: e.start_ns())
    assert len(spans) == len(host) >= 3
    assert sum(e["args"]["rounds"] for e in spans) == 30
    launched = {e.correlation_id(): e.start_ns() for e in events
                if not str(e.device_type()).endswith("CUDA")
                and e.name().startswith(("cudaLaunch", "cuLaunch",
                                         "cudaGraphLaunch", "cudaMemcpy",
                                         "cudaMemset"))}
    ops = [e for e in events if str(e.device_type()).endswith("CUDA")
           and not e.is_user_annotation()]
    found = []
    for span, rng in zip(spans, host):
        lo, hi = rng.start_ns(), rng.start_ns() + rng.duration_ns()
        mine = [k for k in ops
                if lo <= launched.get(k.correlation_id(), -1) <= hi]
        assert mine, f"no operation launched in the bsp.step at {lo}"
        program = [k.start_ns() for k in mine if not re.search(
            r"at::|at_cuda_detail|c10::|cublas|cutlass|gemm|gemv|"
            r"splitKreduce|cudnn|nvjet|xmma|^Memcpy|^Memset", k.name(),
            re.IGNORECASE)]
        first = min(k.start_ns() for k in mine)
        start_ns = (data["wallClockT0"] + span["ts"] / 1e6) * 1e9
        extent = max(k.start_ns() + k.duration_ns() for k in mine) - first
        found.append((span, start_ns - first, extent))
        print(f"bsp.step clock {span['args']['clock']} rounds "
              f"{span['args']['rounds']}: start - first operation "
              f"{(start_ns - first) / 1e3:.1f} us, - first program kernel "
              f"{(start_ns - min(program)) / 1e3:.1f} us; dur "
              f"{span['dur']:.1f} us, extent {extent / 1e3:.1f} us")
    for span, offset, extent in found:
        assert abs(offset) <= 0.5e6, (offset, span)
        assert abs(span["dur"] * 1e3 - extent) <= 0.05 * extent, \
            (span["dur"] * 1e3, extent, span)
    flush = min(e.start_ns() for e in events
                if e.name() == "fused.flush_logs")
    syncs = [e.start_ns() for e in events if e.name() in SYNCS]
    assert sum(t < flush for t in syncs) == 1, syncs


def test_deferred_card_deltas_resolve_to_the_inline_bits_without_a_sync(
        card):
    """The model-health plane fed CUDA tensors, as the in-process fabric
    feeds it: observe_update and observe_eval only keep the references
    (nothing synchronises: they run under sync debug mode "error"), and
    the sampler's copy to the host resolves them to bitwise the gauges,
    histogram and drift verdict the inline numpy path gives for the same
    values."""
    from argparse import Namespace
    from kafka_ps_tpu_torch.telemetry import Telemetry
    from kafka_ps_tpu_torch.telemetry.modelhealth import plane_from_args
    args = Namespace(model_health=True, drift_detector="ph",
                     drift_threshold=None)
    rng = np.random.default_rng(11)
    deltas = [rng.normal(0.0, 0.1 + 0.01 * (i % 4), 6150).astype(np.float32)
              for i in range(48)]
    # float32 values: the card's scalars hold what the inline path gets
    evals = [(float(np.float32(0.5 + 0.01 * i)),
              float(np.float32(0.8 - 0.001 * i))) for i in range(48)]
    out = {}
    for mode in ("inline", "card"):
        tel = Telemetry()
        plane = plane_from_args(args, tel, num_features=1024)
        if mode == "inline":
            for i, d in enumerate(deltas):
                plane.observe_update(i % 4, d)
                plane.observe_eval(*evals[i])
        else:
            ones = torch.ones(6150, device=card)
            host = [torch.from_numpy(d).to(card) for d in deltas]
            scalars = [tuple(torch.tensor(v, device=card) for v in e)
                       for e in evals]
            torch.cuda.synchronize()
            # kernel outputs still being computed when they are observed
            values = [h * ones for h in host]
            torch.cuda.set_sync_debug_mode("error")
            try:
                for i, v in enumerate(values):
                    plane.observe_update(i % 4, v)
                    plane.observe_eval(*scalars[i])
            finally:
                torch.cuda.set_sync_debug_mode("default")
        polled = plane.poll()
        text = [ln for ln in tel.prometheus_text().splitlines()
                if not ln.startswith("modelhealth_deferred_total ")]
        out[mode] = (polled["updates"], plane.summary(), plane.detail(),
                     text, tel.snapshot()["modelhealth_deferred_total"])
    assert out["card"][:4] == out["inline"][:4]
    assert out["card"][4] == {"_total": 48} and out["inline"][4] == \
        {"_total": 0}
    assert out["card"][0] == 48 and out["card"][2]["drift"]["evals"] == 48


# -- the multi-device fused path (parallel/{mesh,multihost,range_sharded}) --


def _md_jobs():
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_multidevice_runs
    return torch_multidevice_runs


MD_APP = {"task": "logreg", "F": 64, "C": 5, "H": 16, "lr": 0.5,
          "workers": 4, "buffer": 64, "n_train": 256, "n_test": 100,
          "seed": 0, "iters": 40, "eval_every": 5, "param_shards": 1}


def test_one_rank_nccl_job_is_bitwise_no_job_on_the_card(card, tmp_path):
    jobs = _md_jobs()
    cfg, (theta, x, y, mask) = _case("cpu", 4 * 32, 64)
    steps = {"task": "logreg", "F": 64, "C": 5, "lr": 0.5,
             "theta": theta.numpy(), "x": x.numpy().reshape(4, 32, 64),
             "y": y.numpy().reshape(4, 32),
             "mask": mask.numpy().reshape(4, 32), "server_lr": 0.25,
             "rounds": 8}
    out = jobs.run_job("one_rank_bitwise", 1,
                       {"steps": steps, "app": MD_APP}, str(tmp_path))[0]
    none, job = out["none"], out["job"]
    for key in ("bsp", "bsp_multi"):
        for a, b in zip(none["steps"][key], job["steps"][key]):
            assert np.array_equal(a, b)
    assert np.array_equal(none["app"]["theta"], job["app"]["theta"])
    strip = (lambda rows: [r.split(";", 1)[1] for r in rows])
    assert strip(none["app"]["worker"]) == strip(job["app"]["worker"])
    assert none["app"]["counts"]["batched_launches"] == 10


def test_two_ranks_share_the_card_over_gloo(card, tmp_path):
    """run_fused_bsp over 2 ranks on one card: every rank's theta the same
    bits, the bsp branch within the K2 tolerance of --param_shards 2's
    range-sharded server, each rank one K2 call a round over 2 workers."""
    jobs = _md_jobs()
    res = [r["app"] for r in jobs.run_job("job", 2, {"runs": [
        MD_APP, dict(MD_APP, param_shards=2)]}, str(tmp_path))]
    for r in res:
        assert np.array_equal(r[0]["theta"], res[0][0]["theta"])
        assert np.array_equal(r[1]["theta"], res[0][1]["theta"])
        for run in r:
            assert (run["counts"]["batched_launches"],
                    run["counts"]["batched_members"]) == (10, 20)
    np.testing.assert_allclose(res[0][1]["theta"], res[0][0]["theta"],
                               rtol=RTOL, atol=MLP_ATOL)


def test_ground_truth_fit_on_the_card_matches_the_cpu(card):
    from kafka_ps_tpu_torch.evaluation import ground_truth
    x, y = generate(600, 64, 5, seed=3)
    cfg = ModelConfig(num_features=64, num_classes=5)
    on_card = ground_truth.train_offline(x, y, cfg, steps=100, device=card)
    on_cpu = ground_truth.train_offline(x, y, cfg, steps=100, device="cpu")
    np.testing.assert_allclose(on_card, on_cpu, rtol=RTOL, atol=MLP_ATOL)
