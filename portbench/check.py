"""The comparison that decides a run's `correct`.

Set-up drives the program's own entry point round by round through the
first SETUP_ROUNDS rounds (one call each, so that the weights after
every round can be read), then CALL_ROUNDS rounds in one call shaped as
the window's calls are: CUDA graph chunks, the single rounds before each
eval clock, two evals, the deferred log rows flushed at its exit.  What
the program produced there (`Produced`: the logged losses, the weights
after each of those calls, the logged test metrics at clocks
SETUP_ROUNDS and SETUP_ROUNDS + CALL_ROUNDS) and its buffers at the
window's close are held against the plain reference (`reference/`),
which works everything out again from the inputs the harness handed
both sides.

The early rounds of the MLP at H=4096 (losses in the hundreds, then a
fall to below 1 within ten rounds) amplify a rounding difference from
round to round, so only the start is followed from the reference's own
initial weights; every later stage is followed one stretch at a time
from the program's own weights at its start (PERF.md):

  loss_gap         rounds 1..START_ROUNDS from the reference's initial
                   weights: the largest |loss - ref| / |ref| of the
                   logged losses (the workers' mean)
  update_gap       round 1's change of the weights, by the worst leaf:
                   | |d_leaf| - |d_leaf ref| | / max(|d_leaf ref|, the
                   median leaf's |d ref|)
  change_gap       the same for the change over rounds 1..START_ROUNDS,
                   by the median leaf
  step_loss_gap,   each round 1..SETUP_ROUNDS from the program's weights
  step_update_gap  before it: its losses, and its change by the worst leaf
  call_loss_gap,   the CALL_ROUNDS rounds of one call, from the program's
  call_change_gap  weights before it: their losses, and their change by
                   the median leaf
  eval_loss_gap,   the logged test loss (relative), weighted F1 and
  eval_f1_gap,     accuracy (absolute) at both calls' last clocks, of the
  eval_acc_gap     program's weights then; the larger of the two
  buffer_mismatch  elements of the buffers at the close (rows, labels,
                   ids) that differ from the reference's replay of every
                   row handed over, with its arrival stamp: exact

Over a stretch of rounds a flipped relu gate moves the hidden bias b1,
a small leaf, by up to 1.6e-5 of the median leaf's change on some seeds
where the others read 1e-7 (PERF.md): a stretch's change is taken by the
median leaf, a single round's by the worst.  Leaves whose reference
change is under a thousandth of the median leaf's are left out (none are
at these shapes); a reading that is not a number fails.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference import mlp
from portbench.reference.rounds import Model, make_buffers, rounds, slabs

HERE = os.path.dirname(os.path.abspath(__file__))
SETUP_ROUNDS = 10
CALL_ROUNDS = 20
START_ROUNDS = 3
LAST_CLOCK = SETUP_ROUNDS + CALL_ROUNDS


@dataclass
class Produced:
    losses: dict        # round -> the workers' mean, rounds 1..LAST_CLOCK
    thetas: list        # weights after rounds 1..SETUP_ROUNDS
    theta_call: np.ndarray      # after the call of CALL_ROUNDS rounds
    evals: dict         # clock -> (loss, f1, acc) logged there
    buffers: list       # per worker (x, y, ids) at the close


def load_limits(cell: str) -> dict[str, float]:
    with open(os.path.join(HERE, "checks", f"{cell}.json")) as f:
        return json.load(f)["limits"]


def _rel(p: float, r: float) -> float:
    return abs(p - r) / max(abs(r), 1e-30)


def leaf_gaps(model: Model, change_p: torch.Tensor,
              change_r: torch.Tensor) -> dict[str, float]:
    """Each leaf's | |p| - |r| | over max(|r|, the median leaf's |r|),
    leaves with |r| under 1e-3 of the median left out."""
    lp, lr_ = model.leaves(change_p), model.leaves(change_r)
    norms_r = {k: float(torch.linalg.vector_norm(v)) for k, v in lr_.items()}
    median = float(np.median(list(norms_r.values())))
    return {name: abs(float(torch.linalg.vector_norm(v)) - norms_r[name])
            / max(norms_r[name], median)
            for name, v in lp.items() if norms_r[name] >= 1e-3 * median}


def leaf_gap(model: Model, change_p: torch.Tensor,
             change_r: torch.Tensor, detail: dict | None = None,
             key: str = "", median: bool = False) -> float:
    """The worst leaf's gap (`leaf_gaps`), or with `median` the median
    leaf's; NaN where any is NaN.  With `detail`, every leaf's gap is
    kept there under `key`."""
    gaps = leaf_gaps(model, change_p, change_r)
    if detail is not None:
        detail[key] = gaps
    values = list(gaps.values())
    if any(map(math.isnan, values)):
        return math.nan
    return float(np.median(values)) if median else max(values)


class Reference:
    """The reference's run of one cell on the handed inputs: `handed`
    is every row both sides got, (worker, dense row, label, stamp ms),
    in the order the program received them."""

    def __init__(self, cfg: dict, handed: list, test, device,
                 prec: mlp.Precision = mlp.F32, half_batch: bool = False):
        self.model = Model.from_config(cfg)
        self.device = device
        self.prec = prec
        self.test = tuple(torch.from_numpy(a).to(device) for a in test)
        self.buffers = make_buffers(cfg)
        for w, row, label, stamp in handed:
            self.buffers[w].add(row, label, stamp)
        self.slabs = slabs(self.buffers, device, half_batch)
        self.theta0 = mlp.init(**self.model.sizes).to(device)

    def tensor(self, theta: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(theta).to(self.device)

    def rounds(self, theta: torch.Tensor, count: int):
        """`count` rounds from `theta` on the buffers."""
        return rounds(self.model, theta, self.slabs, count, self.prec)

    def evaluate(self, theta: torch.Tensor):
        """The test metrics (loss, f1, acc) of weights `theta`."""
        return self.model.evaluate(theta, self.test, self.prec)


def _loss_gap(produced: Produced, first_clock: int,
              ref_losses: list) -> float:
    """The largest relative gap of the logged losses of rounds
    first_clock+1 .. against the reference's (the workers' mean)."""
    return max(_rel(produced.losses[first_clock + 1 + i], float(np.mean(r)))
               for i, r in enumerate(ref_losses))


def readings(produced: Produced, ref: Reference,
             detail: dict | None = None) -> dict[str, float]:
    """Every number compared, of the program's outputs (`produced`), or
    of another reference's put in the program's place (`as_produced`);
    `detail` collects the leaf gaps behind them."""
    model = ref.model
    out: dict[str, float] = {}
    prog = [ref.theta0] + [ref.tensor(t) for t in produced.thetas]

    thetas, losses, _ = ref.rounds(ref.theta0, START_ROUNDS)
    out["loss_gap"] = _loss_gap(produced, 0, losses)
    out["update_gap"] = leaf_gap(model, prog[1] - ref.theta0,
                                 thetas[0] - ref.theta0, detail,
                                 "update_gap")
    out["change_gap"] = leaf_gap(model, prog[START_ROUNDS] - ref.theta0,
                                 thetas[-1] - ref.theta0, detail,
                                 "change_gap", median=True)

    step_loss, step_update = [], []
    for c in range(1, SETUP_ROUNDS + 1):
        t, losses, _ = ref.rounds(prog[c - 1], 1)
        step_loss.append(_loss_gap(produced, c - 1, losses))
        step_update.append(leaf_gap(model, prog[c] - prog[c - 1],
                                    t[0] - prog[c - 1], detail,
                                    f"step_update_gap.{c}"))
    out["step_loss_gap"] = max(step_loss)
    out["step_update_gap"] = max(step_update)

    start = prog[SETUP_ROUNDS]
    end = ref.tensor(produced.theta_call)
    thetas, losses, _ = ref.rounds(start, CALL_ROUNDS)
    out["call_loss_gap"] = _loss_gap(produced, SETUP_ROUNDS, losses)
    out["call_change_gap"] = leaf_gap(
        model, end - start, thetas[-1] - start, detail, "call_change_gap",
        median=True)

    gaps = []
    for clock, theta in ((SETUP_ROUNDS, start), (LAST_CLOCK, end)):
        p_loss, p_f1, p_acc = produced.evals[clock]
        r_loss, r_f1, r_acc = ref.evaluate(theta)
        gaps.append((_rel(p_loss, r_loss), abs(p_f1 - r_f1),
                     abs(p_acc - r_acc)))
    out["eval_loss_gap"], out["eval_f1_gap"], out["eval_acc_gap"] = (
        max(g) for g in zip(*gaps))

    mismatch = 0
    for (x, y, ids), buf in zip(produced.buffers, ref.buffers):
        mismatch += int(np.count_nonzero(x != buf.x))
        mismatch += int(np.count_nonzero(y != buf.y))
        mismatch += int(np.count_nonzero(ids != buf.ids))
    out["buffer_mismatch"] = float(mismatch)
    return out


def start_gaps(produced: Produced, ref: Reference) -> list[float]:
    """Diagnostic: each set-up round's loss gap when the reference
    follows all of them from its own initial weights."""
    _, losses, _ = ref.rounds(ref.theta0, SETUP_ROUNDS)
    return [_loss_gap(produced, c, [r]) for c, r in enumerate(losses)]


def as_produced(other: Reference) -> Produced:
    """The program's numbers replaced by those of `other`, a reference
    in another precision or with a fault planted: the control, put in
    the program's place.  It runs the set-up's rounds from its own
    initial weights; its buffers are its own replay."""
    thetas, losses, _ = other.rounds(other.theta0, SETUP_ROUNDS)
    call, call_losses, _ = other.rounds(thetas[-1], CALL_ROUNDS)
    logged = {c + 1: float(np.mean(x))
              for c, x in enumerate(losses + call_losses)}
    evals = {SETUP_ROUNDS: other.evaluate(thetas[-1]),
             LAST_CLOCK: other.evaluate(call[-1])}
    return Produced(logged, [t.cpu().numpy() for t in thetas],
                    call[-1].cpu().numpy(), evals,
                    [(b.x, b.y, b.ids) for b in other.buffers])


def verdict(values: dict[str, float],
            limits: dict[str, float]) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number within its
    limit; a number without a limit, or one that is not finite, fails."""
    checks = {}
    ok = True
    for name, value in values.items():
        limit = limits.get(name)
        good = (limit is not None and math.isfinite(value)
                and value <= limit)
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
