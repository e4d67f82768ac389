"""PS203 positive fixture (torch twin of tests/analysis_fixtures/
psverify/ps203_bad.py, on the port's recorder): A-then-B on one path,
B-then-A on the other.  Tests drive ONLY `forward`, so the runtime
lockgraph records a single consistent edge and stays silent — the static
pass still proves the inversion from the never-exercised `backward`."""
from kafka_ps_tpu_torch.analysis.lockgraph import OrderedLock

A = OrderedLock("fxt203.A")
B = OrderedLock("fxt203.B")


def forward():
    with A:
        with B:
            return True


def backward():
    with B:
        with A:
            return True
