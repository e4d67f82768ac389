"""The readers of the fused loop's spans (metrics/slab_upload_ms.py,
eval_ms.py, log_flush_ms.py) on synthetic runs: the per-call readers
divide by the calls (one `fused.flush_logs` span each), the eval reader
averages its spans, and each reads nothing without the spans it divides
by."""

import pytest

from portbench import manifest
from portbench.cell import Run


def _run(spans):
    return Run("c", {"num_workers": 4}, {}, "cpu", None, spans=spans)


CALLS = {
    "fused.flush_logs": [(4.0, {"rows": 1404}), (6.0, {"rows": 1404})],
    "fused.slab_upload": [(10.0, {"bytes": 16 * 2 ** 20, "rows_new": 0}),
                          (12.0, {"bytes": 16 * 2 ** 20, "rows_new": 0}),
                          (2.0, {"bytes": 16 * 2 ** 20, "rows_new": 3})],
    "fused.eval": [(1.0, {"clock": 10}), (1.5, {"clock": 20}),
                   (0.5, {"clock": 30})],
    "bsp.step": [(22.4, {"clock": 1, "rounds": 8})],
}


@pytest.mark.parametrize("name,value", [("slab_upload_ms", 12.0),
                                        ("log_flush_ms", 5.0),
                                        ("eval_ms", 1.0)])
def test_reader_value(name, value):
    assert manifest.metric(name).read(_run(CALLS)) == pytest.approx(value)


def test_calls_without_uploads_read_zero_uploads():
    spans = {k: v for k, v in CALLS.items() if k != "fused.slab_upload"}
    assert manifest.metric("slab_upload_ms").read(_run(spans)) == 0.0


@pytest.mark.parametrize("name,absent", [
    ("slab_upload_ms", "fused.flush_logs"),
    ("log_flush_ms", "fused.flush_logs"),
    ("eval_ms", "fused.eval")])
def test_reader_reads_nothing_without_the_spans_it_divides_by(name, absent):
    spans = {k: v for k, v in CALLS.items() if k != absent}
    assert manifest.metric(name).read(_run(spans)) is None
