"""What the program's spans cost when they are on and no profiler runs.

    python3 benchmark/tools/span_cost.py --cells hw2_2d_16m.unsaved ... --seed 5 --reps 3

For each cell: the seeded state, a fresh engine of its configuration, the
window's warm-up, then ``2 * reps`` whole simulations through
``Engine.run`` at the mix's ``savefreq``, spans off and on in turns (off,
on, on, off, ...; on is ``ppsim_tpu_torch.profiling.tracing()``), each
timed on the host clock up to ``torch.cuda.synchronize()``. One JSON line
a cell: the seconds of each, their medians and the relative difference.
"""

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cells", nargs="+", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)
    import contextlib

    import torch

    from benchmark import core, spec
    from benchmark.initstate import lattice_state
    from benchmark.reference import Physics
    from ppsim_tpu_torch import profiling
    from ppsim_tpu_torch.state import ParticleState

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    bench = spec.load_benchmark()
    for name in args.cells:
        cell = spec.find_cell(bench, name)
        config, mix = spec.load_config(cell["config"]), spec.load_mix(cell["traffic"])
        sim = config["sim"]
        pos, vel = lattice_state(sim["num_parts"], sim["ndim"], Physics.of(sim).size,
                                 args.seed, dev)
        state = ParticleState(pos, vel)
        engine = core._engine(config, dev)
        core._warm_up(engine, state, mix)
        seconds = {"off": [], "on": []}
        for k in range(2 * args.reps):
            side = "off" if k % 4 in (0, 3) else "on"
            with profiling.tracing() if side == "on" else contextlib.nullcontext():
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                engine.run(state, mix["nsteps"], mix["savefreq"])
                torch.cuda.synchronize(dev)
                seconds[side].append(time.perf_counter() - t0)
        off, on = (statistics.median(seconds[s]) for s in ("off", "on"))
        print(json.dumps({"cell": name, "seconds": seconds, "median_off": off,
                          "median_on": on, "on_over_off": on / off - 1.0,
                          "runs": engine.counters.runs, "reruns": engine.counters.reruns}),
              flush=True)
        del engine, state, pos, vel
        torch.cuda.empty_cache()
    print(core.card_line(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
