"""The choice between the MLP kernel's two sets of passes, on the CPU.

csrc/mlp_update.cu runs K4/K6 on f32 slabs at a wide hidden layer (H >=
1024, F a multiple of 4) on its wide passes (wgmma fed by TMA from split
operands in scratch) and every other call on the narrow ones (mma.sync).
The rule runs in C; ops/fused_update.py mirrors it (`mlp_wide_path`) and
the split scratch it sizes (`mlp_wide_scratch`), and holds the library to
both on the card (`_mlp_scratch`, tests/test_torch_cuda.py).  Here: the
mirror depends on the shape and the storage form and never on the member
count, the stored forms and ragged F keep the narrow passes, and the
scratch covers the split and transposed operands.  The wide passes'
arithmetic (32-deep chunks), as tests/test_torch_mlp_split.py models it,
is held to the JAX package's update at a wide-ish shape.
"""

import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kafka_ps_tpu.models import mlp as jmlp
from kafka_ps_tpu.utils.config import ModelConfig as JModelConfig
from kafka_ps_tpu_torch.models import mlp
from kafka_ps_tpu_torch.ops import _build, fused_update
from kafka_ps_tpu_torch.utils.config import ModelConfig
from test_torch_mlp_split import split_update

MLP_RTOL, MLP_ATOL = 1e-4, 1e-5


def test_rule_takes_the_shape_and_form_and_no_member_count():
    params = list(inspect.signature(fused_update.mlp_wide_path).parameters)
    assert params == ["batch", "features", "hidden", "kind"]
    assert fused_update.WIDE_MIN_HIDDEN == 1024


@pytest.mark.parametrize("batch,features,hidden,kind,wide", [
    (1024, 1024, 4096, "f32", True), (1000, 1020, 1056, "f32", True),
    (1, 4, 1024, "f32", True), (1024, 1024, 1023, "f32", False),
    (1024, 1024, 128, "f32", False), (1024, 33, 4096, "f32", False),
    (1024, 1022, 4096, "f32", False), (1024, 1024, 4096, "bf16", False),
    (1024, 1024, 4096, "int8", False), (1000, 1024, 100, "f32", False)])
def test_wide_path_rule(batch, features, hidden, kind, wide):
    """H >= 1024 with F a multiple of 4 on an f32 slab; H=128, K5's bf16
    and int8 slabs and ragged F such as F=33 stay on the narrow passes."""
    assert fused_update.mlp_wide_path(batch, features, hidden, kind) is wide
    sizes = fused_update.mlp_wide_scratch(batch, features, hidden, 4, kind)
    assert (sum(sizes) > 0) is wide


@pytest.mark.parametrize("batch,bp", [(1024, 1024), (1000, 1000),
                                      (1001, 1004), (3, 4)])
def test_wide_scratch_covers_split_and_transposed_operands(batch, bp):
    """Per member: x and W1 split (hi, lo planes of [B, F] and [H, F]),
    x.T and dh.T split (planes of [F, Bp] and [H, Bp], rows padded to 4
    floats for TMA's 16-byte strides); linear in the member count."""
    features, hidden = 1020, 1056
    one = fused_update.mlp_wide_scratch(batch, features, hidden, 1)
    assert one == (2 * batch * features, 2 * features * bp,
                   2 * hidden * features, 2 * hidden * bp)
    for members in (2, 32):
        assert fused_update.mlp_wide_scratch(
            batch, features, hidden, members) == tuple(members * n
                                                       for n in one)
    # at H=4096 with 4 members the split scratch is about 0.3 GB
    big = fused_update.mlp_wide_scratch(1024, 1024, 4096, 4)
    assert 0.25e9 < 4 * sum(big) < 0.35e9


@pytest.mark.parametrize("features,hidden,members,steps,sms,want", [
    (1024, 4096, 4, 1, 132, (1024, 892)), (1024, 4096, 4, 2, 132,
                                           (2048, 1784)),
    (1024, 4096, 1, 2, 132, (512, 248)), (1024, 1024, 1, 1, 132, (64, 0)),
    (1020, 1056, 1, 1, 132, (72, 0)), (1024, 4096, 34, 1, 132,
                                       (8704, 8440)),
    (1024, 4096, 4, 1, 78, (1024, 946))])
def test_wide_tiles_follow_the_launch_geometry(features, hidden, members,
                                               steps, sms, want):
    """An update-pass launch covers [H, F] in 128 x 128 tiles a member on
    min(tiles, SMs) CTAs, at most 32 members a launch; every tile but each
    CTA's last hands its epilogue over while the next one runs (the cell's
    shape: 1,024 and 892 a launch on 132 SMs).  The tile is the kernel's."""
    with open(f"{_build.CSRC}/mlp_update.cu") as f:
        found = re.findall(r"constexpr int kGM = (\d+), kGN = (\d+),",
                           f.read())
    assert found == [(str(fused_update.WIDE_TILE),) * 2]
    assert fused_update.mlp_wide_tiles(features, hidden, members, steps,
                                       sms) == want


def _wide_cpu_case():
    cfg = ModelConfig(num_features=8, num_classes=2, num_max_iter=1,
                      hidden_dim=1024)
    rng = np.random.default_rng(0)
    theta = torch.from_numpy((mlp.init_params(cfg, "cpu").numpy()
                              ).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, size=16).astype(np.int32))
    return cfg, theta, x, y, torch.ones(16)


@pytest.mark.parametrize("name", ["mlp_wide_launches",
                                  "mlp_wide_update_tiles",
                                  "mlp_wide_overlapped_tiles"])
def test_wide_counter_is_one_of_the_counters(name):
    """The wide path's counters are kernel counters: added to, reset with
    the others, and left at 0 by a CPU call at a wide shape."""
    fused_update.reset_counts()
    assert fused_update.counts()[name] == 0
    fused_update.add_counts({name: 3})
    assert fused_update.counts()[name] == 3
    fused_update.reset_counts()
    assert not any(fused_update.counts().values())
    cfg, *args = _wide_cpu_case()
    fused_update.mlp_local_update(*args, cfg=cfg)
    assert fused_update.counts()[name] == 0


def test_cpu_tensors_run_the_plain_version_at_a_wide_shape():
    """On the CPU a wide-shape call runs the plain version: no kernel
    launch counted, the wide counters included."""
    cfg, theta, x, y, mask = _wide_cpu_case()
    fused_update.reset_counts()
    d, loss = fused_update.mlp_local_update(theta, x, y, mask, cfg=cfg)
    ds, ls = fused_update.mlp_local_update_batched([theta] * 2, [x] * 2,
                                                   [y] * 2, [mask] * 2,
                                                   cfg=cfg)
    assert not any(fused_update.counts().values())
    assert torch.equal(ds[0], d) and torch.equal(ls[1], loss)


@pytest.mark.parametrize("seed", [0, 1])
def test_wide_arithmetic_matches_jax_update(seed):
    """The wide passes' products (32-deep chunks, split operands) on the
    JAX package's inputs at H=512, B=F=256, k=2: within the MLP's
    tolerance of the JAX function."""
    B, F, H, C = 256, 256, 512, 5
    cfg = ModelConfig(num_features=F, num_classes=C, num_max_iter=2,
                      local_learning_rate=0.5, hidden_dim=H)
    jcfg = JModelConfig(num_features=F, num_classes=C, num_max_iter=2,
                        local_learning_rate=0.5, hidden_dim=H)
    rng = np.random.default_rng(seed)
    theta = (mlp.init_params(cfg, "cpu").numpy() + rng.normal(
        scale=0.01, size=mlp.num_params(cfg))).astype(np.float32)
    x = rng.normal(size=(B, F)).astype(np.float32)
    y = rng.integers(0, C + 1, size=B).astype(np.int32)
    y[3] = C + 2
    mask = (np.arange(B) < B - 30).astype(np.float32)
    d, loss = split_update(*(torch.from_numpy(a) for a in
                             (theta, x, y, mask)), cfg, "f32", depth=32)
    dj, lj = jmlp.MLPTask(jcfg).local_update(
        *(jnp.asarray(a) for a in (theta, x, y, mask)))
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=MLP_RTOL,
                               atol=MLP_ATOL)
    np.testing.assert_allclose(float(loss), float(lj), rtol=MLP_RTOL,
                               atol=MLP_ATOL)
