"""The kernels (K1, K2, K4, K6) and the trainer on an NVIDIA card.  Every
test here needs CUDA and skips without it.  The file imports no JAX, so
it also runs where only PyTorch is installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances of a kernel against its plain version on the card (float32;
the kernel and cuBLAS sum in different orders; TF32 is switched off for
the plain version's matmuls): K1/K2 rtol=1e-4, atol=1e-6; K4/K6
rtol=1e-4, atol=1e-5 (two more products per step, and the relu gate).
A gang member and a single call on the same inputs are bitwise equal.
"""

import numpy as np
import pytest
import torch

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


def _gang(dev, members, batch, features, hidden=None, shared=False):
    cases = [_case(dev, batch, features, seed=s, hidden=hidden)
             for s in range(members)]
    cfg = cases[0][0]
    thetas, xs, ys, masks = (list(a) for a in zip(*(c[1] for c in cases)))
    if shared:
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
