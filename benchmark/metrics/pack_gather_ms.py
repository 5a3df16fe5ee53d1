"""Milliseconds of one simulation's pack (Engine.init_carry) and final
gather (Engine.final_state), each timed on the host clock between two
synchronizations, with the profiler off, in the traced run."""


def read(run):
    t = run.traced
    if t is None:
        return None
    return 1000.0 * (t.pack_s + t.gather_s)
