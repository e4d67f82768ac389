"""K1 and the trainer on an NVIDIA card.  Every test here needs CUDA and
skips without it.  The file imports no JAX, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerance of the kernel against its plain version on the card: rtol=1e-4,
atol=1e-6 (float32; the kernel and cuBLAS sum in different orders).
TF32 is switched off for the plain version's matmuls.
"""

import numpy as np
import pytest
import torch

from kafka_ps_tpu_torch.data.synth import generate
from kafka_ps_tpu_torch.ops import fused_update
from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
from kafka_ps_tpu_torch.utils.config import (BufferConfig, ModelConfig,
                                             PSConfig)

pytestmark = pytest.mark.cuda
RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, batch, features, classes=5, k=2, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(batch, features))
         * (rng.random((batch, features)) < 0.5)).astype(np.float32)
    y = rng.integers(1, classes + 1, size=batch).astype(np.int32)
    y[min(1, batch - 1)] = classes + 1      # out of range
    mask = (np.arange(batch) < batch - batch // 10).astype(np.float32)
    cfg = ModelConfig(num_features=features, num_classes=classes,
                      num_max_iter=k)
    theta = rng.normal(scale=0.05, size=cfg.num_params).astype(np.float32)
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


def _serial_run(device, c):
    cfg = PSConfig(num_workers=3, consistency_model=c,
                   model=ModelConfig(num_features=64, num_classes=5),
                   buffer=BufferConfig(min_size=8, max_size=32))
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


@pytest.mark.parametrize("c", [0, 2, -1])
def test_trainer_on_card_matches_cpu(card, c):
    before = fused_update.launches
    gpu, gs, gw = _serial_run(card, c)
    assert fused_update.launches - before >= 30
    cpu, cs, cw = _serial_run("cpu", c)
    assert [r.split(";")[1:3] for r in gs] == [r.split(";")[1:3] for r in cs]
    assert [r.split(";")[1:3] + r.split(";")[6:] for r in gw] == \
        [r.split(";")[1:3] + r.split(";")[6:] for r in cw]
    torch.testing.assert_close(gpu.server.theta.cpu(), cpu.server.theta,
                               rtol=1e-4, atol=1e-5)
