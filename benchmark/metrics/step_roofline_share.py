"""100 * the least time of one step (benchmark/roofline.py: the problem's
bytes at the memory peak or its flops at the float32 peak, whichever is
larger) / the device's time per step over steps 1..nsteps of one
simulation in the traced run: CUDA events recorded before the first step
and after the last, the pack and the gather outside, the profiler off."""

from benchmark import roofline


def read(run):
    t = run.traced
    peaks = roofline.peaks_of(run.device_name)
    if t is None or not t.steps_device_s or peaks is None:
        return None
    sim = run.config["sim"]
    least, _ = roofline.least_step_s(run.n, sim["ndim"], sim["density"],
                                     sim["cutoff"], sim["force_law"], peaks)
    return 100.0 * least / (t.steps_device_s / run.nsteps)
