"""Seconds of the first load of the program's kernel library in this
process (``ppsim_tpu_torch._build.kernel_build_s``: an nvcc build on a
checkout's first run, a cached library's load after it), part of the
set-up; nothing where the library was never loaded (off the card) or the
program does not count it."""


def read(run):
    from ppsim_tpu_torch import _build

    return getattr(_build, "kernel_build_s", None)
