"""Over one whole unsaved simulation through Engine.run in the traced run:
100 * (1 - union of the device's kernel and copy intervals / wall time)."""


def read(run):
    t = run.traced
    if run.saves or t is None or t.sim is None:
        return None
    return 100.0 * (1.0 - t.sim.busy_s / t.sim.wall_s)
