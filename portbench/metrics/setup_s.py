"""setup_s: from the start of the benchmark's process to the opening of
the window: imports, the CUDA context, the kernels' build or load, the
data, the burst, the first rounds (the chunk's graph capture among
them) and the warm-up.  Host clock."""


def read(run):
    return run.setup_s
