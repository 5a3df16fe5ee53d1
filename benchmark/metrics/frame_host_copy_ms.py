"""Host milliseconds a frame in the program's span ``ppsim.frame.host_copy``
(FrameSink's copy of a frame into the run's host array), in the spans-on
simulation of the traced run (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    m = spans.measure(run)
    if m is None or not m.frames:
        return None
    return 1000.0 * m.reading.host_s("ppsim.frame.host_copy") / m.frames
