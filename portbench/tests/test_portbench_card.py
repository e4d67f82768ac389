"""One short run of mlp4096.fused.backlog on the card, through the
command the driver runs.  Skips where there is no card, decided inside
the test.  Run on the card with:

    python -m pytest portbench/tests -m cuda
"""

import json
import os
import subprocess
import sys

import pytest

from portbench import manifest


@pytest.mark.cuda
def test_a_short_run_of_the_first_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this run measures the card")
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "mlp4096.fused.backlog", "--seed", "2718281828", "--seconds", "2",
         "--trace", "0"], cwd=manifest.ROOT, capture_output=True, text=True,
        timeout=1200)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["metrics"]["updates_per_s"]["value"] > 0
    assert os.path.isdir(os.path.join(manifest.ROOT, "kafka_ps_tpu_torch",
                                      "_build"))
