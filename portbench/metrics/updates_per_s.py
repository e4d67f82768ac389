"""updates_per_s: the gradient updates the server applied in the window
(worker iterations; workers x rounds on the fused path), over the whole
window, which ends with a device synchronise.  Host clock."""


def read(run):
    return run.updates / run.window_s if run.window_s > 0 else None
