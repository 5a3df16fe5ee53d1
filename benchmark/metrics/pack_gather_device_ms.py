"""Milliseconds of device time under the program's spans ``ppsim.pack``
(Engine.init_carry) and ``ppsim.gather`` (Engine.final_state) of one
simulation, in the spans-on simulation of the traced run
(``benchmark/spans.py``); nothing off the card or for a program without
spans."""

from benchmark import spans


def read(run):
    m = spans.measure(run)
    packs = m.reading.count("ppsim.pack") if m is not None else 0
    if not packs or m.reading.busy_s <= 0:
        return None
    return 1000.0 * (m.reading.device_s("ppsim.pack")
                     + m.reading.device_s("ppsim.gather")) / packs
