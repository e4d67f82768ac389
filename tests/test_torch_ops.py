"""K1 (kafka_ps_tpu_torch.ops.fused_update) on the CPU: its plain version
against the JAX package's Pallas kernel run in interpret mode, and the
wrapper's argument checks, which run before any dispatch.

The kernel itself runs only on a card: tests/test_torch_cuda.py and
chip_smoke.py hold it against the plain version there.

Tolerance: rtol=1e-4, atol=1e-6 (float32, different summation orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kafka_ps_tpu.ops import fused_update as jfused
from kafka_ps_tpu.utils.config import ModelConfig as JModelConfig
from kafka_ps_tpu_torch.ops import fused_update
from kafka_ps_tpu_torch.utils.config import ModelConfig

RTOL, ATOL = 1e-4, 1e-6


def _case(batch, features=64, classes=5, k=2, masked=5, bad_label=None,
          seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(batch, features))
         * (rng.random((batch, features)) < 0.5)).astype(np.float32)
    y = rng.integers(1, classes + 1, size=batch).astype(np.int32)
    if bad_label is not None:
        y[1] = bad_label
    mask = (np.arange(batch) < batch - masked).astype(np.float32)
    cfg = ModelConfig(num_features=features, num_classes=classes,
                      num_max_iter=k)
    jcfg = JModelConfig(num_features=features, num_classes=classes,
                        num_max_iter=k)
    theta = rng.normal(scale=0.1, size=cfg.num_params).astype(np.float32)
    return cfg, jcfg, theta, x, y, mask


@pytest.mark.parametrize("batch,kw", [
    (48, {}),                               # a multiple of 8
    (37, {}),                               # not a multiple of 8
    (40, {"masked": 40}),                   # every row masked
    (33, {"bad_label": 6}),                 # label == C+1: out of range
    (64, {"bad_label": 11, "k": 3, "features": 128, "classes": 3}),
])
def test_plain_matches_pallas_kernel(batch, kw):
    cfg, jcfg, theta, x, y, mask = _case(batch, **kw)
    dj, lj = jfused.local_update(jnp.asarray(theta), jnp.asarray(x),
                                 jnp.asarray(y), jnp.asarray(mask), cfg=jcfg,
                                 interpret=True, allow_fallback=False)
    before = fused_update.launches
    dt, lt = fused_update.local_update(
        torch.from_numpy(theta), torch.from_numpy(x), torch.from_numpy(y),
        torch.from_numpy(mask), cfg=cfg)
    assert fused_update.launches == before      # CPU tensors: no kernel
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(lt), float(lj), rtol=RTOL, atol=ATOL)
    assert np.isfinite(dt.numpy()).all() and np.isfinite(float(lt))


def _args(batch=16, features=64):
    cfg, _, theta, x, y, mask = _case(batch, features=features)
    return cfg, [torch.from_numpy(a) for a in (theta, x, y, mask)]


@pytest.mark.parametrize("which,bad,err", [
    (1, lambda t: t.to(torch.float64), TypeError),       # x float64
    (2, lambda t: t.to(torch.int64), TypeError),         # y int64
    (3, lambda t: t.to(torch.float16), TypeError),       # mask float16
    (1, lambda t: t.t().contiguous().t(), ValueError),   # x not contiguous
    (1, lambda t: t[:, :-1], ValueError),                # x too narrow
    (0, lambda t: t[:-1], ValueError),                   # theta too short
    (2, lambda t: t[:-1], ValueError),                   # y too short
])
def test_wrapper_checks_arguments_before_dispatch(which, bad, err):
    cfg, args = _args()
    args[which] = bad(args[which])
    before = fused_update.launches
    with pytest.raises(err):
        fused_update.local_update(*args, cfg=cfg)
    with pytest.raises(err):
        fused_update.check_args(*args, cfg)
    assert fused_update.launches == before


def test_wrapper_refuses_too_many_classes():
    cfg = ModelConfig(num_features=8, num_classes=fused_update.MAX_ROWS)
    args = [torch.zeros(cfg.num_params), torch.zeros(4, 8),
            torch.zeros(4, dtype=torch.int32), torch.ones(4)]
    with pytest.raises(ValueError, match="at most"):
        fused_update.local_update(*args, cfg=cfg)


def test_wrapper_refuses_mixed_devices():
    cfg, args = _args()
    args[0] = args[0].to("meta")
    with pytest.raises(ValueError, match="is on"):
        fused_update.check_args(*args, cfg)


def test_plain_version_is_the_cpu_path():
    cfg, args = _args(batch=24)
    d1, l1 = fused_update.local_update(*args, cfg=cfg)
    d2, l2 = fused_update.local_update_plain(*args, cfg=cfg)
    assert torch.equal(d1, d2) and torch.equal(l1, l2)
