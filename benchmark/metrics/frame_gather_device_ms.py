"""Milliseconds of device time a frame under the program's span
``ppsim.frame.gather`` (Engine.frame_of), in the spans-on simulation of
the traced run (``benchmark/spans.py``); nothing off the card."""

from benchmark import spans


def read(run):
    m = spans.measure(run)
    if m is None or not m.frames or m.reading.busy_s <= 0:
        return None
    return 1000.0 * m.reading.device_s("ppsim.frame.gather") / m.frames
