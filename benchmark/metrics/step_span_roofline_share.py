"""100 * the least time of one step (benchmark/roofline.py) / the self
device time of the program's span ``ppsim.steps`` (its kernels, not those
of the frame spans inside it) per step run, in the spans-on simulation of
the traced run (``benchmark/spans.py``). Prints its comparison with the
CUDA-event twin, ``step_roofline_share``, to standard error."""

import sys

from benchmark import roofline, spans


def read(run):
    m = spans.measure(run)
    peaks = roofline.peaks_of(run.device_name)
    if m is None or peaks is None or not m.steps:
        return None
    own = m.reading.device_s("ppsim.steps", self_only=True)
    if own <= 0:
        return None
    sim = run.config["sim"]
    least, _ = roofline.least_step_s(run.n, sim["ndim"], sim["density"],
                                     sim["cutoff"], sim["force_law"], peaks)
    share = 100.0 * least / (own / m.steps)
    t = run.traced
    if t is not None and t.steps_device_s:
        twin = 100.0 * least / (t.steps_device_s / run.nsteps)
        rel = abs(share - twin) / twin
        print(f"check step_span_roofline_share {share:.4f} against step_roofline_share "
              f"{twin:.4f}: {100 * rel:.3f}% apart (within 3: {'yes' if rel <= 0.03 else 'no'})",
              file=sys.stderr)
    return share
