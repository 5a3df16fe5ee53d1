"""Host milliseconds a frame in the program's span ``ppsim.frame.wait``
(FrameSink's wait for a frame's copy to host memory), in the spans-on
simulation of the traced run (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    m = spans.measure(run)
    if m is None or not m.frames:
        return None
    return 1000.0 * m.reading.host_s("ppsim.frame.wait") / m.frames
