"""slab_upload_ms: the fused loop's slab uploads in the part of a traced
window after the profiled part, all their time over the calls of
run_fused_bsp there (one `fused.flush_logs` span a call).  A
`fused.slab_upload` host span holds the buffers' snapshot and stack,
the pinned staging, the wait on the previous copy and the copy's
enqueue.  Reads 0 where the calls upload nothing."""


def read(run):
    calls = len(run.spans.get("fused.flush_logs", ()))
    if not calls:
        return None
    return sum(ms for ms, _ in run.spans.get("fused.slab_upload", ())) \
        / calls
