"""K4 at the wide MLP's width (H=4096, B=F=1024, C=5, k=2, lr 0.5) against
its plain version and against the same update in float64, on one NVIDIA
card, for each checkout of the repo given.

    python3 scripts/torch_mlp_wide_accuracy.py TREE [TREE ...]

At this width the logits reach ~100 after the first step, where a relu
gate sits within float32 rounding of zero on some rows: every float32
version (the kernel, the plain version through cuBLAS, the JAX function
on the CPU) then strays from float64 on a few hundred elements of delta,
each on its own inputs.  A kernel change is judged against float64 over
several input sets, not against the plain version on one.  Eight sets:
`ab` (normal x, the A/B script's inputs), `case` (x half zeros, the CUDA
tests' `_case`), `synth5`-`synth8` (chip_smoke.py's data seeds 5-8 with
its theta), `member51`, `member52` (chip_smoke.py's wide members with a
theta of their own).  Per tree and set one JSON line: the kernel against
the plain version and against float64, and the plain version against
float64, each as the largest difference, the count of delta and loss
elements outside rtol 1e-4, atol 1e-5, and the mean difference; and the
SHA-256 of the bytes of delta and loss from K4 and from K6 on 4 members
sharing the set's theta (member j's rows of x, y and mask rolled by j B/4),
which trees with the same arithmetic give bit for bit.  Each tree runs in
a process of its own; list the trees as A B B A.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

F, B, H, C = 1024, 1024, 4096, 5
RTOL, ATOL = 1e-4, 1e-5


def inputs(torch, np, generate, theta0, num_params):
    dev = torch.device("cuda")

    def t(*a):
        return [torch.from_numpy(np.asarray(v)).to(dev) for v in a]

    out = {}
    rng = np.random.default_rng(51)
    x = rng.normal(size=(B, F)).astype(np.float32)
    y = rng.integers(0, C, size=B).astype(np.int32)
    y[3] = C + 2
    mask = (np.arange(B) < B - 100).astype(np.float32)
    theta = (rng.normal(scale=0.01, size=num_params) + theta0)
    out["ab"] = t(theta.astype(np.float32), x, y, mask)
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(B, F)) * (rng.random((B, F)) < 0.5)).astype(
        np.float32)
    y = rng.integers(1, C + 1, size=B).astype(np.int32)
    y[1] = C + 1
    theta = theta0 + rng.normal(scale=0.01, size=num_params)
    out["case"] = t(theta.astype(np.float32), x, y,
                    (np.arange(B) < B - B // 10).astype(np.float32))
    theta = theta0 + np.random.default_rng(5).normal(scale=0.01,
                                                     size=num_params)
    for seed in (5, 6, 7, 8):
        x, y = generate(B, F, C, seed=seed)
        out[f"synth{seed}"] = t(theta.astype(np.float32), x, y, mask)
    for seed in (51, 52):
        x, y = generate(B, F, C, seed=seed)
        y[3] = C + 2
        theta = theta0 + np.random.default_rng(seed).normal(
            scale=0.01, size=num_params)
        out[f"member{seed}"] = t(theta.astype(np.float32), x, y, mask)
    return out


def update_f64(torch, mlp, cfg, theta, x, y, mask):
    """The plain version's k steps with every operand in float64."""
    theta, x, mask = theta.double(), x.double(), mask.double()
    onehot = mlp.one_hot(y.long(), cfg.num_rows).double()
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


def diff(torch, out, ref) -> dict:
    o = torch.cat([out[0].reshape(-1), out[1].reshape(-1)]).double()
    r = torch.cat([ref[0].reshape(-1), ref[1].reshape(-1)]).double()
    e = (o - r).abs()
    return {"max": float(e.max()),
            "outside": int((e > ATOL + RTOL * r.abs()).sum()),
            "mean": float(e.mean())}


def digest(deltas, losses) -> str:
    h = hashlib.sha256()
    for t in (deltas, losses):
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def measure_one(tree: str, label: str) -> None:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from kafka_ps_tpu_torch.data.synth import generate
    from kafka_ps_tpu_torch.models import mlp
    from kafka_ps_tpu_torch.ops import fused_update as fu
    from kafka_ps_tpu_torch.utils.config import ModelConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(num_features=F, num_classes=C, num_max_iter=2,
                      local_learning_rate=0.5, hidden_dim=H)
    theta0 = mlp.init_params(cfg, "cpu").numpy()
    sets = inputs(torch, np, generate, theta0, mlp.num_params(cfg))
    for name, args in sets.items():
        out = fu.mlp_local_update(*args, cfg=cfg)
        theta, x, y, mask = args
        gang = fu.mlp_local_update_batched(
            [theta] * 4, *([torch.roll(v, j * B // 4, 0) for j in range(4)]
                           for v in (x, y, mask)), cfg=cfg)
        plain = fu.mlp_local_update_plain(*args, cfg=cfg)
        f64 = update_f64(torch, mlp, cfg, *args)
        torch.cuda.synchronize()
        row = {"tree": label, "set": name,
               "kernel_vs_plain": diff(torch, out, plain),
               "kernel_vs_f64": diff(torch, out, f64),
               "plain_vs_f64": diff(torch, plain, f64),
               "sha256": {"k4": digest(*out), "k6": digest(*gang)}}
        print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 3 and argv[1] == "--measure-one":
        measure_one(argv[2], argv[0])
        return 0
    if not argv:
        raise SystemExit(__doc__)
    me = os.path.abspath(__file__)
    for label in argv:
        subprocess.run([sys.executable, me, label, "--measure-one",
                        os.path.abspath(label)], check=True, timeout=900)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
