"""The benchmark of kafka_ps_tpu_torch on one NVIDIA card.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json and prints its result as
the last line of standard output.  Everything a cell needs is found by
name: the configuration under `configs/`, the traffic mix under
`traffic/`, one reader per metric under `metrics/`, the operation counts
of a kernel family under `kernels/` and the limits of the correctness
check under `checks/`.  The plain reference that decides `correct` is
`reference/`, which imports nothing of the program; the configuration's
`reference` key names its model family's module there, which names the
rows its model reads (`rows/`).  A new model family is new files and
entries: its module, its rows if new, its kernel counts, a
configuration, a traffic mix, a checks file.

Tests: `python -m pytest portbench/tests` on the CPU; on the card also
`python -m pytest portbench/tests -m cuda`.  `calibrate.py` takes the
readings behind the check's limits on the card; the benchmark's runs do
not run it.
"""
