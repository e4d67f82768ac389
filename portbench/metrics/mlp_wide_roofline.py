"""mlp_wide_roofline: the summed bounds of the K4 and K6 calls the
profiled part of the window made (the program's kernel counters,
kernels/mlp_update.py) over the device time of every kernel of the
program in it (devtrace.py), in percent.  Listed for the cells whose
configuration takes the wide passes (csrc/mlp_update.cu, wgmma fed by
TMA: float32 at H >= 1024)."""

from portbench import manifest


def read(run):
    return manifest.roofline(run, "mlp_update")
