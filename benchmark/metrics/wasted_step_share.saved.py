"""100 * the steps of simulations that were then re-run after a capacity
escalation / all steps run, from the engine's counters
(``steps_discarded``, ``steps_run``) over the spans-on simulation of the
traced run (``benchmark/spans.py``: a fresh engine's first whole
simulation of the run's seed, as the window's first), for a mix that saves frames."""

from benchmark import spans


def read(run):
    m = None if not run.saves else spans.measure(run)
    if m is None or not m.steps:
        return None
    return 100.0 * m.delta("steps_discarded") / m.steps
