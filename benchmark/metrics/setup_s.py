"""Seconds from the process's start to the window's start: imports, the
CUDA context, the seeded state, the engine, the kernels' build and the
warm-up."""


def read(run):
    return run.setup_s
