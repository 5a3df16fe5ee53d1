"""The readings a configuration's limits are set from, on the card.

    python3 benchmark/tools/readings.py --config hw2_2d_16m --seeds 1 2 3 ...

For each seed: the seeded state, one simulation of the configuration's
engine through ``Engine.run`` at the timed size (1000 steps, a frame every
10 steps, which holds every frame the cells compare), the numbers the
comparison reads from it, and the same numbers for the control (the
reference in bfloat16 in the program's place, ``check.control``, on the
first ``--control-seeds``). One
JSON line a seed on standard output, then the largest reading of the
program and the smallest of the control per number.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--nsteps", type=int, default=1000)
    p.add_argument("--savefreq", type=int, default=10)
    p.add_argument("--control-seeds", type=int, default=3,
                   help="read the control on the first this many seeds")
    args = p.parse_args(argv)
    import torch

    from benchmark import check, core, spec
    from benchmark.initstate import lattice_state
    from benchmark.reference import Physics
    from ppsim_tpu_torch.state import ParticleState

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    config = spec.load_config(args.config)
    sim = config["sim"]
    phys = Physics.of(sim)
    steps = check.frame_steps(args.nsteps, args.savefreq)
    engine = core._engine(config, dev)
    lows, highs = {}, {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        pos0, vel0 = lattice_state(sim["num_parts"], sim["ndim"], phys.size, seed, dev)
        result = engine.run(ParticleState(pos0, vel0), args.nsteps, args.savefreq)
        failed = core._failed(engine, result)
        warning = core._warning(engine, result)
        final, frames = result.state, result.frames
        result = None
        t1 = time.perf_counter()
        prog = check.compare(phys, pos0, vel0, frames, steps, final.pos, final.vel,
                             args.nsteps, dev)
        t2 = time.perf_counter()
        ctl = {}
        if seed in args.seeds[:args.control_seeds]:
            ctl = check.control(phys, pos0, vel0, steps, final.pos, final.vel,
                                args.nsteps, dev)
        t3 = time.perf_counter()
        frames = final = None
        for k, v in prog.items():
            lows[k] = max(lows.get(k, v), v)
        for k, v in ctl.items():
            highs[k] = min(highs.get(k, v), v)
        print(json.dumps({"seed": seed, "failed": failed, "warning": warning, "program": prog, "control": ctl,
                          "sim_s": t1 - t0, "compare_s": t2 - t1, "control_s": t3 - t2}),
              flush=True)
    print(json.dumps({"config": args.config, "card": core.card_line(),
                      "lower": lows, "upper": highs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
