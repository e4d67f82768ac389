"""Run one cell of the benchmark of kafka_ps_tpu_torch on this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (`correct`, `attempted`, `failed`, `metrics`, `device`, with
--trace 1 `breakdown`, and last `checks`: each number the correctness
check compared, beside its limit); the same numbers end standard error.
Exits 1 without a result where the card or the program is missing or a
run fails.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# caches of anything the run compiles, at fixed paths in the checkout
CACHE = os.path.join(ROOT, ".portbench_cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = os.path.join(CACHE, sub)
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench import cell as cell_mod
    from portbench import manifest
    try:
        import kafka_ps_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is not in this checkout: {e}", file=sys.stderr)
        return 1
    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    out = cell_mod.execute(args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", T_PROCESS, cell)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
