"""Build and load the port's shared libraries at first use.

Two libraries, each compiled into ``ppsim_tpu_torch/_build/`` (listed in
``.gitignore``) under a name keyed by a hash of its sources and command, so a
changed source rebuilds and an unchanged one loads at once:

- the Hopper kernels, ``csrc/*.cu``, each compiled with
  ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -Xcompiler -fPIC -c``
  (one compiler process per source, all started together) and linked into
  one library with a plain C interface, loaded with ``ctypes`` (no PyTorch
  headers, so the build takes seconds);
- the native initializer and checker, ``native/ppsim_native.cpp`` (unchanged
  source of the JAX package), built with ``g++`` (:mod:`ppsim_tpu_torch.native`).

Concurrent builders (test workers) each compile to a private temporary name
and ``os.replace`` it into place, so a reader never sees a partial file.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Callable, List, Optional, Union

__all__ = ["BUILD_DIR", "build_shared", "library_path", "kernels", "kernel_build_log",
           "nvcc_path", "kernel_builds", "kernel_build_s"]

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CSRC_DIR = os.path.join(PKG_DIR, "csrc")

_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

Command = Callable[[str], Union[List[str], List[List[str]]]]


def _run_all(commands: List[List[str]], timeout: float):
    """Start every command at once and wait for all; returns
    ``[(argv, returncode, output), ...]``."""
    procs = [(argv, subprocess.Popen(argv, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True))
             for argv in commands]
    results = []
    try:
        for argv, proc in procs:
            out, _ = proc.communicate(timeout=timeout)
            results.append((argv, proc.returncode, out))
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return results


def _steps(command: Command, out_path: str) -> List[List[str]]:
    cmd = command(out_path)
    return [cmd] if isinstance(cmd[0], str) else cmd


def library_path(name: str, sources: List[str], command: Command) -> str:
    """Where :func:`build_shared` keeps the library of ``sources`` built
    with ``command``: named by a hash of both."""
    h = hashlib.sha256()
    for path in sources:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    h.update(repr(_steps(command, "OUT")).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_shared(name: str, sources: List[str], command: Command,
                 timeout: float = 600.0) -> str:
    """Build ``sources`` with ``command(out_path)`` unless an identical
    build exists; returns the library path. ``command`` gives one argv, or a
    list of argvs whose last one links: the others run first, all started
    together, and may write files named ``out_path + "." + anything``.
    Raises RuntimeError with the compiler's output on failure. The compiler's
    output of a successful build is kept beside the library as ``<lib>.log``."""
    out = library_path(name, sources, command)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}.so"
    try:
        *parallel, link = _steps(command, tmp)
        log = []
        for group in (parallel, [link]):
            for argv, rc, text in _run_all(group, timeout):
                log.append(text)
                if rc != 0:
                    raise RuntimeError(f"building {name} failed (exit {rc}): "
                                       f"{' '.join(argv)}\n{text}")
        with open(out + ".log", "w") as f:
            f.write("".join(log))
        os.replace(tmp, out)
    finally:
        for path in glob.glob(glob.escape(tmp) + "*"):
            os.remove(path)
    return out


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the Hopper kernels are built from csrc/ at first use")


_kernels: Optional[ctypes.CDLL] = None
_kernels_path: Optional[str] = None
#: This process's compiles of the kernel library (0 when a cached build was
#: loaded) and the seconds of :func:`kernels`' first call (None before it).
kernel_builds = 0
kernel_build_s: Optional[float] = None


def kernels() -> ctypes.CDLL:
    """The kernel library, built on first call and loaded once per process
    (the span ``ppsim.build``, ``built=1`` when it compiles)."""
    global _kernels, _kernels_path, kernel_builds, kernel_build_s
    if _kernels is not None:
        return _kernels
    from ppsim_tpu_torch.profiling import span

    t0 = time.perf_counter()
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    nvcc = nvcc_path()

    def command(out):
        objs = [f"{out}.{os.path.basename(src)}.o" for src in sources]
        return [[nvcc, *_NVCC_FLAGS, "-c", src, "-o", obj]
                for src, obj in zip(sources, objs)] + [
                    [nvcc, "-shared", "-o", out, *objs]]

    built = not os.path.exists(library_path("ppsim_kernels", sources + headers, command))
    with span("ppsim.build", {"built": int(built)}):
        path = build_shared("ppsim_kernels", sources + headers, command)
        lib = ctypes.CDLL(path)
    P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    for fn, types in (
            (lib.ppsim_grid_step, [P] * 17 + [I] * 12 + [F] * 10 + [P]),
            (lib.ppsim_grid_force, [P] * 4 + [I] * 10 + [F] * 8 + [P]),
            (lib.ppsim_rebin_axes, [P] * 31 + [I] * 14 + [F] * 2 + [P]),
            (lib.ppsim_rebin_counts, [P] * 4 + [I] * 7 + [F] + [P]),
            (lib.ppsim_rebin_shuffle, [P] * 24 + [I] * 13 + [F] * 2 + [P]),
            (lib.ppsim_grid3_step, [P] * 20 + [I] * 15 + [F] * 12 + [P]),
            (lib.ppsim_rebin3_inplane, [P] * 15 + [I] * 15 + [F] * 5 + [P]),
            (lib.ppsim_rebin3_ypass, [P] * 32 + [I] * 10 + [F] * 4 + [P]),
            (lib.ppsim_fma_chain, [P, P, L, I, I, I, P]),
            (lib.ppsim_stream_add, [P, P, L, I, P])):
        fn.argtypes = types
        fn.restype = I
    lib.ppsim_error_string.argtypes = [I]
    lib.ppsim_error_string.restype = ctypes.c_char_p
    _kernels, _kernels_path = lib, path
    kernel_builds += built
    kernel_build_s = time.perf_counter() - t0
    return lib


def kernel_build_log() -> str:
    """The compiler's output of the loaded kernel library (ptxas register and
    spill counts under ``-Xptxas -v``)."""
    if _kernels_path is None or not os.path.exists(_kernels_path + ".log"):
        return ""
    with open(_kernels_path + ".log") as f:
        return f.read()


def check_launch(err: int, what: str) -> None:
    """Raise when a kernel entry point returned a CUDA error code."""
    if err != 0:
        msg = kernels().ppsim_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
