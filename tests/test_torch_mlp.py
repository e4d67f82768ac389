"""The MLP family (kafka_ps_tpu_torch.models.mlp, K4's plain version in
ops/fused_update.py) against kafka_ps_tpu's: the same numpy inputs, and
the JAX package's θ₀ carried across, through both, on the CPU.

Tolerances: delta and loss rtol=1e-4, atol=1e-6 against both the JAX
package's XLA path (`MLPTask.local_update`, `jax.grad`) and its Pallas
kernel in interpret mode (float32, different summation orders; the
measured gap is ~6e-8 absolute); F1/accuracy within 1/len(test) (one
flipped argmax of a near tie).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kafka_ps_tpu.models import mlp as jmlp
from kafka_ps_tpu.ops import fused_update as jfused
from kafka_ps_tpu.utils.config import ModelConfig as JModelConfig
from kafka_ps_tpu_torch.models import mlp
from kafka_ps_tpu_torch.models.task import get_task
from kafka_ps_tpu_torch.ops import fused_update
from kafka_ps_tpu_torch.utils.config import ModelConfig
from kafka_ps_tpu_torch.weights import from_jax_params

RTOL, ATOL = 1e-4, 1e-6
F, C = 64, 5


def _cfgs(hidden=32, k=2):
    return (ModelConfig(num_features=F, num_classes=C, hidden_dim=hidden,
                        num_max_iter=k),
            JModelConfig(num_features=F, num_classes=C, hidden_dim=hidden,
                         num_max_iter=k))


def _case(batch, hidden=32, k=2, masked=5, bad_label=None, seed=0):
    cfg, jcfg = _cfgs(hidden, k)
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(batch, F))
         * (rng.random((batch, F)) < 0.6)).astype(np.float32)
    y = rng.integers(1, C + 1, size=batch).astype(np.int32)
    if bad_label is not None:
        y[2] = bad_label
    mask = (np.arange(batch) < batch - masked).astype(np.float32)
    theta = np.array(jmlp.MLPTask(jcfg).init_params())
    return cfg, jcfg, theta, x, y, mask


CASES = [
    (48, {}),                                # H=32, B a multiple of 8
    (37, {"hidden": 100}),                   # H and B not tile multiples
    (40, {"masked": 40}),                    # every row masked
    (33, {"bad_label": C + 3}),              # label out of range
    (30, {"bad_label": -1, "hidden": 100}),  # negative label
    (24, {"k": 3, "seed": 4}),
    (16, {"k": 0}),
]


@pytest.mark.parametrize("batch,kw", CASES)
def test_plain_update_matches_jax_xla_path(batch, kw):
    cfg, jcfg, theta, x, y, mask = _case(batch, **kw)
    dj, lj = jmlp.MLPTask(jcfg).local_update(
        *(jnp.asarray(a) for a in (theta, x, y, mask)))
    before = fused_update.mlp_launches
    dt, lt = fused_update.mlp_local_update(
        *(torch.from_numpy(a) for a in (theta, x, y, mask)), cfg=cfg)
    assert fused_update.mlp_launches == before    # CPU tensors: no kernel
    assert dt.shape == (mlp.num_params(cfg),)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(lt), float(lj), rtol=RTOL, atol=ATOL)
    assert np.isfinite(dt.numpy()).all() and np.isfinite(float(lt))


@pytest.mark.parametrize("batch,kw", [c for c in CASES if
                                      c[1].get("k", 2) > 0])
def test_plain_update_matches_pallas_kernel(batch, kw):
    cfg, jcfg, theta, x, y, mask = _case(batch, **kw)
    dj, lj = jfused.mlp_local_update(
        *(jnp.asarray(a) for a in (theta, x, y, mask)), cfg=jcfg,
        interpret=True, allow_fallback=False)
    dt, lt = fused_update.mlp_local_update_plain(
        *(torch.from_numpy(a) for a in (theta, x, y, mask)), cfg=cfg)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(lt), float(lj), rtol=RTOL, atol=ATOL)


def test_out_of_range_label_row_gets_zero_gradient():
    """Two batches that differ only in the features of a row whose label
    is out of range (masked in) give the same gradient: with jax.grad
    semantics that row contributes nothing but its mask to the
    denominator — unlike logreg, whose closed form keeps its softmax
    term."""
    cfg, _, theta, x, y, mask = _case(20, masked=0, bad_label=C + 7)
    x_other = x.copy()
    x_other[2] = np.random.default_rng(9).normal(size=F)
    onehot = mlp.one_hot(torch.from_numpy(y), cfg.num_rows)
    assert float(onehot[2].sum()) == 0.0
    t, m = torch.from_numpy(theta), torch.from_numpy(mask)
    g, _ = mlp.grad_loss_onehot(t, torch.from_numpy(x), onehot, m, cfg)
    g_other, _ = mlp.grad_loss_onehot(t, torch.from_numpy(x_other), onehot,
                                      m, cfg)
    torch.testing.assert_close(g, g_other, rtol=0, atol=0)
    assert torch.count_nonzero(g) > 0


def test_closed_form_gradient_equals_jax_grad():
    cfg, jcfg, theta, x, y, mask = _case(40, hidden=100, bad_label=C + 1)
    onehot = (y[:, None] == np.arange(cfg.num_rows)).astype(np.float32)
    gj = jax.grad(jmlp._loss_onehot)(jnp.asarray(theta), jnp.asarray(x),
                                     jnp.asarray(onehot), jnp.asarray(mask),
                                     jcfg)
    lj = jmlp._loss_onehot(jnp.asarray(theta), jnp.asarray(x),
                           jnp.asarray(onehot), jnp.asarray(mask), jcfg)
    gt, lt = mlp.grad_loss_onehot(
        *(torch.from_numpy(a) for a in (theta, x, onehot, mask)), cfg)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(lt), float(lj), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hidden", [32, 100])
def test_evaluate_matches_jax(hidden):
    cfg, jcfg, theta, x, y, _ = _case(200, hidden=hidden, seed=3)
    theta = theta * 3.0       # spread the predictions over the classes
    mj = jmlp.MLPTask(jcfg).evaluate(jnp.asarray(theta), jnp.asarray(x),
                                     jnp.asarray(y))
    mt = get_task("mlp", cfg).evaluate(torch.from_numpy(theta),
                                       torch.from_numpy(x),
                                       torch.from_numpy(y))
    assert abs(float(mt.accuracy) - float(mj.accuracy)) <= 1 / 200
    assert abs(float(mt.f1) - float(mj.f1)) <= 1 / 200
    np.testing.assert_allclose(float(mt.loss), float(mj.loss), rtol=RTOL,
                               atol=ATOL)


def test_evaluate_batch_rows_are_standalone_evals():
    cfg, _, theta, x, y, _ = _case(60, seed=5)
    task = get_task("mlp", cfg)
    rng = np.random.default_rng(1)
    thetas = torch.from_numpy(
        theta + rng.normal(scale=0.1, size=(3, theta.size)).astype(
            np.float32))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    stacked = task.evaluate_batch(thetas, tx, ty)
    for i in range(3):
        m = task.evaluate(thetas[i], tx, ty)
        for field in ("loss", "f1", "accuracy"):
            assert torch.equal(getattr(stacked, field)[i], getattr(m, field))


def test_flat_layout_matches_jax():
    cfg, jcfg, theta, _, _, _ = _case(8, hidden=100)
    assert mlp.num_params(cfg) == jmlp.num_params(jcfg) == theta.size
    t = from_jax_params(theta, cfg, "cpu", task="mlp")
    pt, pj = mlp.unflatten(t, cfg), jmlp.unflatten(jnp.asarray(theta), jcfg)
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert torch.equal(mlp.flatten(pt), t)
    with pytest.raises(ValueError, match="mlp parameters"):
        from_jax_params(theta[:-1], cfg, "cpu", task="mlp")
    with pytest.raises(ValueError, match="logreg parameters"):
        from_jax_params(theta, cfg, "cpu")


def test_init_is_he_normal_from_a_seeded_generator():
    cfg = ModelConfig(num_features=256, num_classes=C, hidden_dim=64)
    a, b = mlp.init_params(cfg, "cpu"), mlp.init_params(cfg, "cpu")
    assert torch.equal(a, b)           # deterministic
    p = mlp.unflatten(a, cfg)
    assert torch.count_nonzero(p.b1) == 0 and torch.count_nonzero(p.b2) == 0
    # He scale: std sqrt(2 / fan_in), within sampling error
    assert abs(float(p.w1.std()) / (2 / 256) ** 0.5 - 1) < 0.05
    assert abs(float(p.w2.std()) / (2 / 64) ** 0.5 - 1) < 0.25
    gen = torch.Generator().manual_seed(mlp.INIT_SEED)
    w1 = torch.randn((64, 256), generator=gen) * (2 / 256) ** 0.5
    assert torch.equal(p.w1, w1)


def test_wrapper_checks_mlp_shapes():
    cfg, _, theta, x, y, mask = _case(16)
    args = [torch.from_numpy(a) for a in (theta, x, y, mask)]
    with pytest.raises(ValueError, match="theta must be"):
        fused_update.mlp_local_update(args[0][:-1], *args[1:], cfg=cfg)
    with pytest.raises(ValueError, match="theta must be"):
        # a logreg-sized theta is not an MLP's
        fused_update.mlp_local_update(torch.zeros(cfg.num_params),
                                      *args[1:], cfg=cfg)
    with pytest.raises(TypeError):
        fused_update.mlp_local_update(args[0], args[1].double(), *args[2:],
                                      cfg=cfg)
