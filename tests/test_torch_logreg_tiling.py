"""The summation order of the logreg kernels (K1, K2, K3), modelled in
plain PyTorch on the CPU (csrc/local_update.cu runs only on the card).

The kernel cuts each member's batch into tiles of kTileRows rows (a
constant of the .cu, read here from the source), whatever the member
count, grid or storage form.  Per step it computes every row's f32 logits
and g, writes one partial g.T @ x | sum(g) per tile, sums each parameter's
partials in tile order, and applies w - lr * s with one rounding each
(__fmul_rn, __fsub_rn); the loss is a per-tile sum of masked NLL, summed in
tile order and divided by denom.  Here that order runs at the main path's
shape (F=B=1024, C=5, k=2, 100 masked rows, one out-of-range label) for
the f32, bf16 and int8 slabs, and holds within rtol 1e-4, atol 1e-6 (K1's
tolerance: float32 in other summation orders) of the port's plain version
and of the JAX package's Pallas kernels in interpret mode (the resident
kernel for f32, the streaming kernel for bf16 and int8, as
tests/test_torch_slab_dtypes.py runs them).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kafka_ps_tpu.compress import slab as jslab
from kafka_ps_tpu.ops import fused_update as jfused
from kafka_ps_tpu.utils.config import ModelConfig as JModelConfig
from kafka_ps_tpu_torch.compress.slab import decode_x
from kafka_ps_tpu_torch.models import logreg
from kafka_ps_tpu_torch.ops import _build, fused_update
from kafka_ps_tpu_torch.utils.config import ModelConfig
from kafka_ps_tpu_torch.weights import from_jax_slab

RTOL, ATOL = 1e-4, 1e-6
F, B, C, K, MASKED = 1024, 1024, 5, 2, 100


def tile_rows() -> int:
    """kTileRows of csrc/local_update.cu: a literal, the same for every
    call (so no member count or grid can change it)."""
    with open(f"{_build.CSRC}/local_update.cu") as f:
        found = re.findall(r"constexpr int kTileRows = (\d+);", f.read())
    assert len(found) == 1
    return int(found[0])


def tiled_update(theta, x, y, mask, cfg, tile):
    """The k-step update in the kernel's order of summation → (delta,
    loss): per-row logits, one partial per tile of `tile` rows, the tiles'
    partials summed in tile order."""
    xv = decode_x(x)
    batch, R = xv.shape[0], cfg.num_rows
    onehot = logreg.one_hot(y, R)
    denom = torch.clamp(mask.sum(), min=1.0)
    tiles = [slice(i, min(i + tile, batch)) for i in range(0, batch, tile)]
    lr = torch.tensor(cfg.local_learning_rate, dtype=torch.float32)

    def logp_of(t):
        p = logreg.unflatten(t, cfg)
        return torch.log_softmax(xv @ p.weights.T + p.intercept, dim=-1)

    t = theta
    for _ in range(cfg.num_max_iter):
        logp = logp_of(t)
        g = (torch.exp(logp) - onehot) * (mask / denom)[:, None]
        s = torch.zeros_like(theta)
        for sl in tiles:
            part = torch.cat([(g[sl].T @ xv[sl]).reshape(-1),
                              g[sl].sum(dim=0)])
            s = s + part
        t = t - lr * s
    nll = -(logp_of(t) * onehot).sum(dim=-1) * mask
    loss = torch.zeros(())
    for sl in tiles:
        loss = loss + nll[sl].sum()
    return t - theta, loss / denom


def _inputs(batch=B, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, F)).astype(np.float32)
    y = rng.integers(0, C + 1, size=batch).astype(np.int32)
    y[3] = C + 2                                   # out of range
    mask = (np.arange(batch) < batch - MASKED).astype(np.float32)
    cfg = ModelConfig(num_features=F, num_classes=C, num_max_iter=K,
                      local_learning_rate=0.5)
    theta = rng.normal(scale=0.01, size=cfg.num_params).astype(np.float32)
    return cfg, theta, x, y, mask


def _port_and_jax(kind, theta, x, y, mask):
    """The port's inputs and the JAX package's, with x in storage form
    `kind` encoded once by the JAX package (the same stored bytes)."""
    stored = jnp.asarray(x) if kind == "f32" else jslab.encode_x(
        kind, jnp.asarray(x))
    port_x = torch.from_numpy(x) if kind == "f32" else from_jax_slab(stored)
    targs = (torch.from_numpy(theta), port_x, torch.from_numpy(y),
             torch.from_numpy(mask))
    jargs = (jnp.asarray(theta), stored, jnp.asarray(y), jnp.asarray(mask))
    return targs, jargs


def _close(ours, ref):
    np.testing.assert_allclose(np.asarray(ours[0]), np.asarray(ref[0]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(ours[1]), float(ref[1]), rtol=RTOL,
                               atol=ATOL)
    assert np.isfinite(np.asarray(ours[0])).all()


def test_tile_is_a_constant_of_the_kernel():
    tile = tile_rows()
    assert tile == 8
    # the main shape's tiles: 128 per member, none spanning two members
    assert -(-B // tile) * tile == B


@pytest.mark.parametrize("kind,batch", [
    ("f32", B), ("bf16", B), ("int8", B), ("f32", 1020)])
def test_tiled_order_matches_plain_version(kind, batch):
    """The kernel's order against fused_update.local_update_plain (the
    port's oracle on the card); B=1020 ends in a ragged tile."""
    cfg, theta, x, y, mask = _inputs(batch)
    targs, _ = _port_and_jax(kind, theta, x, y, mask)
    ours = tiled_update(*targs, cfg, tile_rows())
    ref = fused_update.local_update_plain(*targs, cfg=cfg)
    _close(ours, ref)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_tiled_order_matches_pallas_kernel(kind):
    """The kernel's order against the JAX package's local_update (its
    resident kernel for f32, its streaming kernel for a bf16 or int8
    slab), interpret mode, no fallback."""
    cfg, theta, x, y, mask = _inputs()
    jcfg = JModelConfig(num_features=F, num_classes=C, num_max_iter=K,
                        local_learning_rate=0.5)
    targs, jargs = _port_and_jax(kind, theta, x, y, mask)
    ref = jfused.local_update(*jargs, cfg=jcfg, interpret=True,
                              allow_fallback=False)
    _close(tiled_update(*targs, cfg, tile_rows()), ref)


def tiled_gang_update(gang, cfg, tile):
    """The kernel's walk over a gang's tiles laid end to end: global tile
    g is member g // tiles' tile g % tiles, and its partial joins that
    member's sum; the members' sums run in tile order, side by side."""
    xs = [decode_x(x) for _, x, _, _ in gang]
    batch, R = xs[0].shape[0], cfg.num_rows
    tiles = -(-batch // tile)
    onehots = [logreg.one_hot(y, R) for _, _, y, _ in gang]
    denoms = [torch.clamp(m.sum(), min=1.0) for _, _, _, m in gang]
    lr = torch.tensor(cfg.local_learning_rate, dtype=torch.float32)
    ts = [t for t, _, _, _ in gang]
    for _ in range(cfg.num_max_iter):
        gs = []
        for m, (t, _, _, mask) in enumerate(gang):
            p = logreg.unflatten(ts[m], cfg)
            logp = torch.log_softmax(xs[m] @ p.weights.T + p.intercept, -1)
            gs.append((torch.exp(logp) - onehots[m])
                      * (mask / denoms[m])[:, None])
        sums = [torch.zeros_like(t) for t in ts]
        for g in range(len(gang) * tiles):
            m, j = divmod(g, tiles)
            sl = slice(j * tile, min((j + 1) * tile, batch))
            sums[m] = sums[m] + torch.cat([(gs[m][sl].T @ xs[m][sl])
                                           .reshape(-1), gs[m][sl].sum(0)])
        ts = [t - lr * s for t, s in zip(ts, sums)]
    return [t - t0 for t, (t0, _, _, _) in zip(ts, gang)]


@pytest.mark.parametrize("batch", [B, 1020])
def test_gang_tiles_end_to_end_give_each_member_its_own_result(batch):
    """With every member's batch cut into whole tiles of its own (a
    ragged last tile at B=1020 included), the walk over a gang's tiles
    laid end to end gives each member bitwise its single result, at any
    member count."""
    tile = tile_rows()
    members = [_inputs(batch, seed=s) for s in range(3)]
    cfg = members[0][0]
    gang = [tuple(map(torch.from_numpy, (t, x, y, m)))
            for _, t, x, y, m in members]
    singles = [tiled_update(*g, cfg, tile)[0] for g in gang]
    for count in (1, 2, 3):
        deltas = tiled_gang_update(gang[:count], cfg, tile)
        assert all(torch.equal(d, s) for d, s in zip(deltas, singles))
