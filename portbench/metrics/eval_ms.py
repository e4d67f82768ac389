"""eval_ms: the mean device time of the fused loop's test-set
evaluations (`fused.eval` device spans, timed by CUDA events without a
synchronise) in the part of a traced window after the profiled part."""


def read(run):
    spans = run.spans.get("fused.eval")
    if not spans:
        return None
    return sum(ms for ms, _ in spans) / len(spans)
