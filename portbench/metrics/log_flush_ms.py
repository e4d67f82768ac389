"""log_flush_ms: the exit flush of the fused loop's log rows in the part
of a traced window after the profiled part, all its time over the calls
of run_fused_bsp there (one `fused.flush_logs` host span a call).  With
the tracer on, a call waits for its queued rounds before the span, so
the span holds the rows' fetch, formatting and writing alone."""


def read(run):
    spans = run.spans.get("fused.flush_logs")
    if not spans:
        return None
    return sum(ms for ms, _ in spans) / len(spans)
