"""100 * K3's distance tests / (32 * its warp passes of the test), from the
engine's counters (``pair_tests``, ``test_warp_passes``) over the spans-on
simulation of the traced run (``benchmark/spans.py``), for a mix that saves
no frames: the share of a test pass's lanes that run a test, which K3's
ordered list and flat walk raise. None where the program counts neither, or
where no pass was counted (off the card, or no K3)."""

from benchmark import spans


def read(run):
    m = None if run.saves else spans.measure(run)
    if m is None or not {"pair_tests", "test_warp_passes"} <= set(m.after):
        return None
    passes = m.delta("test_warp_passes")
    if passes <= 0:
        return None
    return 100.0 * m.delta("pair_tests") / (32 * passes)
