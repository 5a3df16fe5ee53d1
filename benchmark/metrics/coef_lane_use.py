"""100 * K3's pairs inside the cutoff / (32 * its warp passes of the pair
coefficient), from the engine's counters (``pair_hits``,
``coef_warp_passes``) over the spans-on simulation of the traced run
(``benchmark/spans.py``), for a mix that saves no frames: the share of a
coefficient pass's lanes that evaluate a pair. None where the program counts
neither, or where no pass was counted (off the card, or no K3)."""

from benchmark import spans


def read(run):
    m = None if run.saves else spans.measure(run)
    if m is None or not {"pair_hits", "coef_warp_passes"} <= set(m.after):
        return None
    passes = m.delta("coef_warp_passes")
    if passes <= 0:
        return None
    return 100.0 * m.delta("pair_hits") / (32 * passes)
