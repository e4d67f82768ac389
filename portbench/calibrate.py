"""Readings for the correctness check's limits, on the card, at a cell's
own size (not run by the benchmark's runs).

    python3 portbench/calibrate.py --workload <cell> --seeds a,b,... \\
        --seconds <s> [--controls k]

For each seed, in one process: a run of the cell with a window of
--seconds, then the numbers the check compares for the program (sound
runs: the lower readings), and for the first k seeds the same numbers
of two references put in the program's place: the control, the
reference in its model family's control precision (CONTROL: TF32
operands), and the fault of half of every batch left out, the mean
taken over the rest; and of the program's outputs with its logged test
F1 and accuracy altered by 0.05.
A state left unchanged reads 1 by the leaf gaps' measure and needs no
run.  One JSON object per seed on standard output, with each leaf's gap
behind the leaf numbers.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--controls", type=int, default=3)
    args = p.parse_args(argv)

    import torch

    from portbench import cell as cell_mod
    from portbench import check, manifest
    cell = manifest.cell(args.workload)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        cr = cell_mod.CellRun(cell, seed, args.seconds, False, "cuda",
                              time.perf_counter())
        cr.build()
        cr.first_rounds()
        cr.window()
        produced = cr.produced()
        cr.close()
        ref = cr.reference()
        detail: dict = {}
        out = {"seed": seed, "program": check.readings(produced, ref, detail),
               "leaves": detail,
               "start_gaps": check.start_gaps(produced, ref),
               "updates_per_s": cr.run.updates / cr.run.window_s}
        if i < args.controls:
            for name, other in (
                    ("control_tf32", cr.reference(prec=cr.family.CONTROL)),
                    ("half_batch", cr.reference(half_batch=True))):
                leaves: dict = {}
                out[name] = check.readings(check.as_produced(other), ref,
                                           leaves)
                out[name + "_leaves"] = leaves
            # an answer altered where it is produced: the logged test
            # F1 and accuracy, 0.05 off
            altered = check.Produced(**{**vars(produced), "evals": {
                c: (loss, f1 + 0.05, acc + 0.05)
                for c, (loss, f1, acc) in produced.evals.items()}})
            out["eval_altered"] = check.readings(altered, ref)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
        del cr, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
