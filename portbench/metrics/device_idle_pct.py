"""device_idle_pct: 100 minus the union of device activity (kernels,
copies, sets) over the profiled window, in percent, from the device
trace."""


def read(run):
    p = run.profile
    return 100.0 * (1.0 - p.busy_ns / p.window_ns) if p is not None else None
