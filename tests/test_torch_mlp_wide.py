"""The MLP at the fused path's width (H=4096, F=1024, B=1024, k=2, lr 0.5)
on the CPU: the port's plain update against the JAX package's and against
the same update in float64.

After the first step the logits reach ~100 (losses 66-249), where a relu
gate or a softmax near-tie can flip under a change of float32 summation
order.  On data seed 8 the plain version and the JAX function, which agree
with each other, are both ~2e-4 away from float64 on a few hundred of the
4.2M elements: float32 itself is ill-conditioned there.  So the plain
version is held to the JAX function at the MLP's tolerance (rtol 1e-4,
atol 1e-5) on every member, and to float64 at that tolerance where
float32 is well conditioned; on seed 8 all but at most OUTLIER_SHARE of
the elements hold it, each of those within OUTLIER_ABS (the bound
chip_smoke.py holds the kernel to against the plain version on these
members).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kafka_ps_tpu.models import mlp as jmlp
from kafka_ps_tpu.utils.config import ModelConfig as JModelConfig
from kafka_ps_tpu_torch.data.synth import generate
from kafka_ps_tpu_torch.models import mlp
from kafka_ps_tpu_torch.ops import fused_update
from kafka_ps_tpu_torch.utils.config import ModelConfig

F, C, B, H = 1024, 5, 1024, 4096
RTOL, ATOL = 1e-4, 1e-5
OUTLIER_SHARE, OUTLIER_ABS = 5e-4, 5e-4


def _update_f64(theta, x, y, mask, cfg):
    """The plain version's k steps with every operand in float64."""
    theta, x, mask = theta.double(), x.double(), mask.double()
    onehot = mlp.one_hot(y, cfg.num_rows).double()
    denom = torch.clamp(mask.sum(), min=1.0)

    def grad_loss(t):
        p = mlp.unflatten(t, cfg)
        pre = x @ p.w1.T + p.b1
        hid = torch.relu(pre)
        logp = torch.log_softmax(hid @ p.w2.T + p.b2, dim=-1)
        loss = (-(logp * onehot).sum(-1) * mask).sum() / denom
        g = (torch.exp(logp) - onehot) * (mask * onehot.sum(-1)
                                          / denom)[:, None]
        dh = (g @ p.w2) * (pre > 0).double()
        return mlp.flatten(mlp.MLPParams(w1=dh.T @ x, b1=dh.sum(0),
                                         w2=g.T @ hid, b2=g.sum(0))), loss

    t = theta
    for _ in range(cfg.num_max_iter):
        t = t - cfg.local_learning_rate * grad_loss(t)[0]
    return t - theta, grad_loss(t)[1]


@pytest.mark.parametrize("seed,outliers", [(5, 0), (6, 0), (7, 0),
                                            (8, OUTLIER_SHARE)])
def test_wide_plain_update_matches_jax_and_float64(seed, outliers):
    cfg = ModelConfig(num_features=F, num_classes=C, hidden_dim=H)
    jcfg = JModelConfig(num_features=F, num_classes=C, hidden_dim=H)
    n = mlp.num_params(cfg)
    theta0 = mlp.init_params(cfg, "cpu").numpy()
    theta = (theta0 + np.random.default_rng(5).normal(scale=0.01, size=n)
             ).astype(np.float32)
    x, y = generate(B, F, C, seed=seed)
    mask = (np.arange(B) < B - 100).astype(np.float32)
    args = [torch.from_numpy(a) for a in (theta, x, y, mask)]
    d, loss = fused_update.mlp_local_update(*args, cfg=cfg)
    d64, loss64 = _update_f64(*args, cfg)
    dj, lj = jmlp.MLPTask(jcfg).local_update(
        *(jnp.asarray(a) for a in (theta, x, y, mask)))
    assert float(loss64) > 50.0          # the ill-conditioned regime
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(loss), float(lj), rtol=RTOL)
    err = np.abs(d.numpy() - d64.numpy())
    outside = err > ATOL + RTOL * np.abs(d64.numpy())
    assert outside.sum() <= outliers * err.size
    assert err.max() <= OUTLIER_ABS
    np.testing.assert_allclose(float(loss), float(loss64), rtol=RTOL)
