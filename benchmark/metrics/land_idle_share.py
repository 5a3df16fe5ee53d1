"""100 * the device's idle time while the host is inside the program's span
``ppsim.frame.land`` (FrameSink's landing of a frame in host memory) / the
wall time of the ``ppsim.run`` span, in the spans-on simulation of the
traced run (``benchmark/spans.py``); nothing off the card."""

from benchmark import spans


def read(run):
    m = spans.measure(run)
    if m is None or not m.frames or m.reading.busy_s <= 0:
        return None
    wall = m.reading.host_s("ppsim.run")
    return 100.0 * m.reading.idle_under("ppsim.frame.land") / wall
