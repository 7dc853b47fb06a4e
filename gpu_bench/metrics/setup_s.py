"""setup_s: seconds from the process's start to the window's start: imports,
the CUDA context, the kernels' load (or build), the weights, the warm-up and
a backlog's fill.  Host clock."""


def read(run):
    return run.setup_s
