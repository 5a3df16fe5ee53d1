"""100 * (1 - seconds of one unsaved simulation / the window's median
seconds of one saved simulation), the same configuration and state, both
on the host clock with the profiler off, in the traced run."""


def read(run):
    t = run.traced
    if t is None or not run.saves:
        return None
    return 100.0 * (1.0 - t.unsaved_sim_s / run.median_sim_s())
