"""kafka_ps_tpu_torch.models against kafka_ps_tpu.models: the same numpy
inputs through both, on the CPU.

Tolerance: rtol=1e-4, atol=1e-6 on float32 results.  The two frameworks
sum in different orders; at F=1024, B=1024, k=2 the measured gap is
~6e-8 absolute on delta and ~1e-7 relative on loss, and elementwise
relative error grows only on entries near zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kafka_ps_tpu.models import logreg as jlogreg
from kafka_ps_tpu.models import metrics as jmetrics
from kafka_ps_tpu.utils.config import ModelConfig as JModelConfig
from kafka_ps_tpu_torch.models import logreg, metrics
from kafka_ps_tpu_torch.models.task import get_task
from kafka_ps_tpu_torch.utils.config import ModelConfig

RTOL, ATOL = 1e-4, 1e-6
F, C = 128, 5
CFG = ModelConfig(num_features=F, num_classes=C)
JCFG = JModelConfig(num_features=F, num_classes=C)


def _inputs(batch=64, seed=0, masked=7, bad_label=None):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(batch, F)) * (rng.random((batch, F)) < 0.4)
         ).astype(np.float32)
    y = rng.integers(1, C + 1, size=batch).astype(np.int32)
    if bad_label is not None:
        y[3] = bad_label
    mask = (np.arange(batch) < batch - masked).astype(np.float32)
    theta = rng.normal(scale=0.1, size=CFG.num_params).astype(np.float32)
    return theta, x, y, mask


def _both(fn_j, fn_t, *arrays):
    out_j = fn_j(*(jnp.asarray(a) for a in arrays))
    out_t = fn_t(*(torch.from_numpy(a) for a in arrays))
    return out_j, out_t


@pytest.mark.parametrize("case", ["plain", "all_masked", "bad_label",
                                  "negative_label"])
def test_local_update_matches_jax(case):
    kw = {"all_masked": dict(masked=64), "bad_label": dict(bad_label=7),
          "negative_label": dict(bad_label=-1)}.get(case, {})
    arrays = _inputs(**kw)
    (dj, lj), (dt, lt) = _both(
        lambda *a: jlogreg.local_update(*a, cfg=JCFG),
        lambda *a: logreg.local_update(*a, cfg=CFG), *arrays)
    assert dt.dtype == torch.float32 and dt.shape == (CFG.num_params,)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(lt), float(lj), rtol=RTOL, atol=ATOL)
    assert np.isfinite(dt.numpy()).all() and np.isfinite(float(lt))


def test_grad_loss_onehot_matches_jax():
    theta, x, y, mask = _inputs(bad_label=9)
    onehot = (y[:, None] == np.arange(CFG.num_rows)).astype(np.float32)
    (gj, lj), (gt, lt) = _both(
        lambda *a: jlogreg.grad_loss_onehot(*a, JCFG),
        lambda *a: logreg.grad_loss_onehot(*a, CFG),
        theta, x, onehot, mask)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(lt), float(lj), rtol=RTOL, atol=ATOL)


def test_one_hot_gives_zero_row_out_of_range():
    y = torch.tensor([0, 5, 6, -1, 100], dtype=torch.int32)
    oh = logreg.one_hot(y, 6)
    np.testing.assert_array_equal(
        oh.numpy(), np.asarray(jnp.eye(6)[np.array([0, 5])].tolist()
                               + [[0.0] * 6] * 3, dtype=np.float32))


def test_evaluate_matches_jax():
    theta, x, y, _ = _inputs(batch=200, seed=3)
    theta *= 20.0          # spread the predictions over the classes
    mj, mt = _both(lambda t, a, b: jmetrics.evaluate(t, a, b, cfg=JCFG),
                   lambda t, a, b: metrics.evaluate(t, a, b, cfg=CFG),
                   theta, x, y)
    # one flipped argmax of a near tie may move F1/accuracy by 1/200
    assert abs(float(mt.accuracy) - float(mj.accuracy)) <= 1 / 200
    assert abs(float(mt.f1) - float(mj.f1)) <= 1 / 200
    np.testing.assert_allclose(float(mt.loss), float(mj.loss), rtol=RTOL,
                               atol=ATOL)


def test_flat_layout_round_trips():
    theta = torch.arange(CFG.num_params, dtype=torch.float32)
    p = logreg.unflatten(theta, CFG)
    assert p.weights.shape == (CFG.num_rows, F)
    assert p.intercept.shape == (CFG.num_rows,)
    assert torch.equal(p.flat, theta)
    z = logreg.init_params(CFG, "cpu").flat
    assert torch.equal(z, torch.zeros(CFG.num_params))
    np.testing.assert_array_equal(
        logreg.sparse_to_dense([{0: 1.5, 3: -2.0}, {}], 4),
        jlogreg.sparse_to_dense([{0: 1.5, 3: -2.0}, {}], 4))


def test_get_task():
    task = get_task("logreg", CFG)
    assert task.num_params == 6 * F + 6
    mlp_task = get_task("mlp", CFG)
    assert mlp_task.num_params == 128 * F + 128 + 6 * 128 + 6
    with pytest.raises(ValueError, match="unknown task"):
        get_task("svm", CFG)
