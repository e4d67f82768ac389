"""The arithmetic of the MLP kernels' tensor-core products, modelled in
plain PyTorch on the CPU (csrc/mlp_update.cu runs only on the card).

The kernels run each of the update's five B*F*H products (x @ W1.T at
every step and at the end, dh.T @ x at every step) as TF32 mma.sync with
f32 accumulation.  An f32 operand a is split into hi = tf32(a) (cvt.rna:
round to 10 fraction bits, ties away from zero) and lo = tf32(a - hi), and
a product is hi*hi + (lo*hi + hi*lo).  A bf16 x, and an int8 q, are exact
in TF32, so x enters with one term and each product has two: x*W_hi +
x*W_lo and dh_hi*x + dh_lo*x; for int8 the row scale s multiplies the row
of pre after q @ W1.T, and the row of dh before dh.T @ q.  Here TF32 is
emulated on the f32 bits and a tensor-core product is a float32 matmul of
TF32 values (their products are exact in f32).  At the main path's shape
the split update stays within the kernels' tolerance of the plain
version, for each storage form; a single TF32 term does not.
"""

import numpy as np
import pytest
import torch

from kafka_ps_tpu_torch.compress.slab import decode_x, encode_x
from kafka_ps_tpu_torch.models import mlp
from kafka_ps_tpu_torch.models.logreg import one_hot
from kafka_ps_tpu_torch.ops import fused_update
from kafka_ps_tpu_torch.utils.config import ModelConfig

MLP_RTOL, MLP_ATOL = 1e-4, 1e-5
F, B, H, C, K = 1024, 1024, 128, 5, 2


def tf32(a: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on float32 values: the 13 low bits rounded off,
    half away from zero (a carry into the exponent is the right result)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32(a)
    return hi, tf32(a - hi)


def product(a, b, exact_a=False, exact_b=False, terms=3):
    """a @ b as the kernels run it: big = hi @ hi, small = lo @ hi +
    hi @ lo without the terms of an exact operand, big + small; with
    terms=1, the single TF32 product."""
    if terms == 1:
        return tf32(a) @ tf32(b)
    ahi, alo = (a, None) if exact_a else split(a)
    bhi, blo = (b, None) if exact_b else split(b)
    small = torch.zeros(a.shape[0], b.shape[1])
    if alo is not None:
        small = small + alo @ bhi
    if blo is not None:
        small = small + ahi @ blo
    return ahi @ bhi + small


def split_update(theta, x, y, mask, cfg, kind, terms=3):
    """The k-step update with the kernels' products (models/mlp.py's
    closed form otherwise) → (delta, loss)."""
    if kind == "int8":
        xv, s = x.q.to(torch.float32), x.scale      # q exact, row scales
    else:
        xv, s = decode_x(x), None
    exact = kind != "f32"
    onehot = one_hot(y, cfg.num_rows)
    denom = torch.clamp(mask.sum(), min=1.0)
    row_valid = onehot.sum(dim=-1)

    def pre_of(p):
        acc = product(xv, p.w1.T, exact_a=exact, terms=terms)
        return (acc if s is None else acc * s) + p.b1

    t = theta
    for _ in range(cfg.num_max_iter):
        p = mlp.unflatten(t, cfg)
        pre = pre_of(p)
        hid = torch.relu(pre)
        logp = torch.log_softmax(hid @ p.w2.T + p.b2, dim=-1)
        g = (torch.exp(logp) - onehot) * (mask * row_valid / denom)[:, None]
        dh = (g @ p.w2) * (pre > 0).to(torch.float32)
        da = dh if s is None else dh * s
        dw1 = product(da.T.contiguous(), xv, exact_b=exact, terms=terms)
        grad = mlp.flatten(mlp.MLPParams(w1=dw1, b1=dh.sum(dim=0),
                                         w2=g.T @ hid, b2=g.sum(dim=0)))
        t = t - cfg.local_learning_rate * grad
    p = mlp.unflatten(t, cfg)
    logp = torch.log_softmax(torch.relu(pre_of(p)) @ p.w2.T + p.b2, dim=-1)
    loss = (-(logp * onehot).sum(dim=-1) * mask).sum() / denom
    return t - theta, loss


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    cfg = ModelConfig(num_features=F, num_classes=C, num_max_iter=K,
                      local_learning_rate=0.5, hidden_dim=H)
    x = rng.normal(size=(B, F)).astype(np.float32)
    y = rng.integers(0, C + 1, size=B).astype(np.int32)
    y[3] = C + 2                                   # out of range
    mask = (np.arange(B) < B - 100).astype(np.float32)
    theta = (mlp.init_params(cfg, "cpu").numpy()
             + rng.normal(scale=0.01, size=mlp.num_params(cfg)))
    return cfg, [torch.from_numpy(a) for a in
                 (theta.astype(np.float32), x, y, mask)]


def test_tf32_split_carries_22_bits():
    a = torch.from_numpy(np.random.default_rng(1).normal(
        size=10_000).astype(np.float32))
    hi, lo = split(a)
    for v in (hi, lo):
        assert (v.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((hi - a).abs() <= a.abs() * 2.0 ** -11).all()
    assert ((hi + lo - a).abs() <= a.abs() * 2.0 ** -21).all()
    # bf16 values and int8 codes are exact in TF32
    b = a.to(torch.bfloat16).to(torch.float32)
    assert torch.equal(tf32(b), b)
    q = torch.arange(-127, 128, dtype=torch.float32)
    assert torch.equal(tf32(q), q)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_split_update_is_within_tolerance_of_plain(kind):
    cfg, (theta, x, y, mask) = _inputs()
    xs = x if kind == "f32" else encode_x(kind, x)
    d, loss = split_update(theta, xs, y, mask, cfg, kind)
    d_ref, loss_ref = fused_update.mlp_local_update_plain(theta, xs, y,
                                                          mask, cfg=cfg)
    torch.testing.assert_close(d, d_ref, rtol=MLP_RTOL, atol=MLP_ATOL)
    torch.testing.assert_close(loss, loss_ref, rtol=MLP_RTOL, atol=MLP_ATOL)


def test_single_tf32_term_is_outside_tolerance():
    """The negative control: one TF32 product per B*F*H product (3 digits)
    misses the tolerance the split meets on the same inputs."""
    cfg, (theta, x, y, mask) = _inputs()
    d, loss = split_update(theta, x, y, mask, cfg, "f32", terms=1)
    d_ref, loss_ref = fused_update.mlp_local_update_plain(theta, x, y, mask,
                                                          cfg=cfg)
    out, ref = torch.cat([d, loss[None]]), torch.cat([d_ref, loss_ref[None]])
    assert not torch.allclose(out, ref, rtol=MLP_RTOL, atol=MLP_ATOL)
