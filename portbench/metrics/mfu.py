"""mfu: the model operations of the training updates over the calls of
the profiled part of a traced window (the program's tracer off), over
the card's TF32 peak, in percent: each update is one worker's k-step
local update, counted from the shapes by the kernel counts that the
configuration's model family names (`COUNTS`: kernels/<COUNTS>.py).
The test-set evaluations are not counted.  Taken over the calls' own
time, so that reading the device trace after them does not count."""

from portbench import manifest


def read(run):
    if run.peak is None or not run.profiled_calls:
        return None
    n = run.config["num_workers"]
    updates = sum(rounds for rounds, _ in run.profiled_calls) * n
    seconds = sum(s for _, s in run.profiled_calls)
    counts = manifest.kernel(manifest.family(run.config).COUNTS)
    flops = updates * counts.flops_per_member(run.config)
    return 100.0 * flops / seconds / run.peak["tf32_flop_per_s"]
