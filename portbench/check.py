"""The comparison that decides a run's `correct`.

Set-up drives the program's own entry point round by round through the
first SETUP_ROUNDS rounds (one call each, so that the weights after
every round can be read), then CALL_ROUNDS rounds in one call shaped as
the window's calls are: CUDA graph chunks, the single rounds before each
eval clock, two evals, the deferred log rows flushed at its exit.  What
the program produced there (`Produced`: the logged losses, the weights
after each of those calls, the logged test metrics at clocks
SETUP_ROUNDS and SETUP_ROUNDS + CALL_ROUNDS) and its buffers at the
window's close are held against the plain reference (`reference/`:
the configuration's model family, the buffer policy, the rounds), which
works everything out again from the inputs the harness handed both
sides.  The weights are the part of them that the family follows
(`Model.follow`), on both sides.

A model's rounds can amplify a rounding difference from round to round
(PERF.md §6): from the initial weights of mlp-h4096 the losses climb
from about 200 to 300 before they fall, and on some seeds three rounds
there turn float32's own rounding into a loss gap of 2e-4 against
float64, more than the TF32 control reads on calm seeds.  So a stretch
of rounds is judged against a float64 witness (the reference's rounds
in float64 from the same weights on the same slabs): by how far the
program's outputs lie from the witness's, over how far the plain
float32 reference's lie from it, the latter taken as at least a floor
(LOSS_FLOOR, CHANGE_FLOOR: about float32's own drift on a calm stretch).
A sound program reads about 1 on every seed; the TF32 control, 10 to
10,000.
The start is followed from the reference's own initial weights; every
later stage one stretch at a time from the program's own weights at its
start:

  loss_drift       rounds 1..START_ROUNDS from the reference's initial
                   weights: the largest |loss - witness| / |witness| of
                   the logged losses (the workers' mean), over the same
                   of the float32 reference's (at least LOSS_FLOOR)
  update_gap       round 1's change of the weights against the float32
                   reference's, by the worst leaf: | |d_leaf| - |d_leaf
                   ref| | / max(|d_leaf ref|, the median leaf's |d ref|)
  change_drift     the change over rounds 1..START_ROUNDS against the
                   witness's, by the median leaf, over the same of the
                   float32 reference's (at least CHANGE_FLOOR)
  step_loss_gap,   each round 1..SETUP_ROUNDS from the program's weights
  step_update_gap  before it, against the float32 reference: its losses,
                   and its change by the worst leaf
  call_loss_drift, the CALL_ROUNDS rounds of one call, from the program's
  call_change_drift  weights before it: their losses, and their change
                   by the median leaf, each as loss_drift and
                   change_drift are taken
  eval_loss_gap,   the logged test loss (relative), weighted F1 and
  eval_f1_gap,     accuracy (absolute) at both calls' last clocks, of the
  eval_acc_gap     program's weights then; the larger of the two
  buffer_mismatch  elements of the buffers at the close (every array
                   of the rows' records, labels, ids) that differ from
                   the reference's replay of every row handed over, with
                   its arrival stamp: exact

Over a stretch of rounds one flipped branch of the model can move a
small leaf far more than rounding does on other seeds (PERF.md §6): a
stretch's change is taken by the median leaf, a single round's by the
worst.  Leaves whose reference change is under a thousandth of the
median leaf's are left out; a reading that is not a number fails.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference.rounds import make_buffers, rounds, server_lr, slabs

HERE = os.path.dirname(os.path.abspath(__file__))
SETUP_ROUNDS = 10
CALL_ROUNDS = 20
START_ROUNDS = 3
# the float32 reference's own drift from the witness is taken as at least
# these: a loss's relative gap, a change's leaf gap
LOSS_FLOOR = 1e-6
CHANGE_FLOOR = 1e-7
LAST_CLOCK = SETUP_ROUNDS + CALL_ROUNDS


@dataclass
class Produced:
    losses: dict        # round -> the workers' mean, rounds 1..LAST_CLOCK
    thetas: list        # followed weights after rounds 1..SETUP_ROUNDS
    theta_call: np.ndarray      # after the call of CALL_ROUNDS rounds
    evals: dict         # clock -> (loss, f1, acc) logged there
    buffers: list       # per worker (record arrays, y, ids) at the close


def load_limits(cell: str) -> dict[str, float]:
    with open(os.path.join(HERE, "checks", f"{cell}.json")) as f:
        return json.load(f)["limits"]


def _rel(p: float, r: float) -> float:
    return abs(p - r) / max(abs(r), 1e-30)


def leaf_gaps(model, change_p: torch.Tensor,
              change_r: torch.Tensor) -> dict[str, float]:
    """Each leaf's | |p| - |r| | over max(|r|, the median leaf's |r|),
    leaves with |r| under 1e-3 of the median left out."""
    lp, lr_ = model.leaves(change_p), model.leaves(change_r)
    norms_r = {k: float(torch.linalg.vector_norm(v)) for k, v in lr_.items()}
    median = float(np.median(list(norms_r.values())))
    return {name: abs(float(torch.linalg.vector_norm(v)) - norms_r[name])
            / max(norms_r[name], median)
            for name, v in lp.items() if norms_r[name] >= 1e-3 * median}


def leaf_gap(model, change_p: torch.Tensor,
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
    """The reference's run of one cell on the handed inputs: `family`
    is the configuration's model family module, `fields` the (shape,
    dtype) of each array of a row's record, `handed` every row both
    sides got, (worker, record, label, stamp ms), in the order the
    program received them, and `test` the test set's arrays.  `prec`
    (the family's F32 by default) and `half_batch` make it a control or
    a fault."""

    def __init__(self, family, cfg: dict, fields, handed: list, test,
                 device, prec=None, half_batch: bool = False):
        self.model = family.Model(cfg, [h[1] for h in handed])
        self.device = device
        self.prec = family.F32 if prec is None else prec
        self.f32 = family.F32
        self.test = tuple(torch.from_numpy(a).to(device) for a in test)
        self.buffers = make_buffers(cfg, fields)
        for w, record, label, stamp in handed:
            self.buffers[w].add(record, label, stamp)
        self.slabs = slabs(self.buffers, device, half_batch)
        self.server_lr = server_lr(cfg)
        self.theta0 = self.model.theta0().to(device)
        self.slabs64 = None

    def tensor(self, theta: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(theta).to(self.device)

    def rounds(self, theta: torch.Tensor, count: int):
        """`count` rounds from `theta` on the buffers."""
        return rounds(self.model, theta, self.slabs, count, self.prec,
                      self.server_lr)

    def witness(self, theta: torch.Tensor, count: int):
        """The same rounds in float64, from `theta` in float64: the
        yardstick of how far float32 rounding alone moves them."""
        if self.slabs64 is None:
            self.slabs64 = [tuple(a.double() if a.is_floating_point() else a
                                  for a in slab) for slab in self.slabs]
        return rounds(self.model, theta.double(), self.slabs64, count,
                      self.f32, self.server_lr)

    def evaluate(self, theta: torch.Tensor):
        """The test metrics (loss, f1, acc) of weights `theta`."""
        return self.model.evaluate(theta, self.test, self.prec)


def _loss_gap(produced: Produced, first_clock: int,
              ref_losses: list) -> float:
    """The largest relative gap of the logged losses of rounds
    first_clock+1 .. against the reference's (the workers' mean)."""
    return max(_rel(produced.losses[first_clock + 1 + i], float(np.mean(r)))
               for i, r in enumerate(ref_losses))


def _drift(gap: float, own: float, floor: float) -> float:
    """The program's gap from the witness over the float32 reference's,
    the latter at least `floor`."""
    return gap / max(own, floor)


def _stretch(model, produced: Produced, first_clock: int,
             start: torch.Tensor, end: torch.Tensor, ref32, ref64,
             detail: dict | None, key: str) -> tuple[float, float]:
    """(loss drift, change drift) of the rounds after `first_clock`,
    from weights `start` to the program's `end`; ref32 and ref64 are the
    float32 reference's and the witness's (weights, losses) of them."""
    (t32, l32), (t64, l64) = ref32, ref64
    own = [_rel(float(np.mean(a)), float(np.mean(b)))
           for a, b in zip(l32, l64)]
    loss = _drift(_loss_gap(produced, first_clock, l64), max(own),
                  LOSS_FLOOR)
    s = start.double()
    change = _drift(
        leaf_gap(model, end.double() - s, t64[-1] - s, detail, key,
                 median=True),
        leaf_gap(model, t32[-1].double() - s, t64[-1] - s, detail,
                 key + ".float32", median=True),
        CHANGE_FLOOR)
    return loss, change


def readings(produced: Produced, ref: Reference,
             detail: dict | None = None) -> dict[str, float]:
    """Every number compared, of the program's outputs (`produced`), or
    of another reference's put in the program's place (`as_produced`);
    `detail` collects the leaf gaps behind them."""
    model = ref.model
    out: dict[str, float] = {}
    prog = [ref.theta0] + [ref.tensor(t) for t in produced.thetas]

    thetas, losses, _ = ref.rounds(ref.theta0, START_ROUNDS)
    w_thetas, w_losses, _ = ref.witness(ref.theta0, START_ROUNDS)
    loss, change = _stretch(
        model, produced, 0, ref.theta0, prog[START_ROUNDS],
        (thetas, losses), (w_thetas, w_losses), detail, "change_drift")
    out["loss_drift"] = loss
    out["update_gap"] = leaf_gap(model, prog[1] - ref.theta0,
                                 thetas[0] - ref.theta0, detail,
                                 "update_gap")
    out["change_drift"] = change

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
    w_thetas, w_losses, _ = ref.witness(start, CALL_ROUNDS)
    out["call_loss_drift"], out["call_change_drift"] = _stretch(
        model, produced, SETUP_ROUNDS, start, end, (thetas, losses),
        (w_thetas, w_losses), detail, "call_change_drift")

    gaps = []
    for clock, theta in ((SETUP_ROUNDS, start), (LAST_CLOCK, end)):
        p_loss, p_f1, p_acc = produced.evals[clock]
        r_loss, r_f1, r_acc = ref.evaluate(theta)
        gaps.append((_rel(p_loss, r_loss), abs(p_f1 - r_f1),
                     abs(p_acc - r_acc)))
    out["eval_loss_gap"], out["eval_f1_gap"], out["eval_acc_gap"] = (
        max(g) for g in zip(*gaps))

    out["buffer_mismatch"] = float(buffer_mismatch(produced.buffers,
                                                   ref.buffers))
    return out


def buffer_mismatch(produced: list, replayed: list) -> int:
    """The elements of the program's buffers, (record arrays, y, ids) a
    worker, that differ from the reference's replayed buffers: every
    array of the record, the labels and the ids."""
    mismatch = 0
    for (records, y, ids), buf in zip(produced, replayed, strict=True):
        for held, want in zip(records, buf.records, strict=True):
            mismatch += int(np.count_nonzero(held != want))
        mismatch += int(np.count_nonzero(y != buf.y))
        mismatch += int(np.count_nonzero(ids != buf.ids))
    return mismatch


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
                    [(b.records, b.y, b.ids) for b in other.buffers])


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
