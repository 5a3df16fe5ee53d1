"""What one comparison costs on the card: its seconds and its peak memory.

    python3 benchmark/tools/compare_cost.py --config benchmark/configs/lj3d_20m.json \
        --n 201326592 --seed 5

The configuration's physics at ``--n`` particles. The seeded lattice state
(``initstate.lattice_state``) is made on the card, and the reference in
float32 runs 21 steps from it to make stand-ins for a program's outputs:
frames after steps 1 and 11, and a final state after step 21 with its frame
nine steps earlier, at step 12 (the forward and the backward reach of a
saved run's comparison, 11 + 9 force evaluations in float64). The state and
the stand-ins then wait in host memory, where ``core.run_cell`` keeps rank
0's, and one ``check.compare`` runs on the card: its seconds on the host
clock up to ``torch.cuda.synchronize()``, and its peak
``torch.cuda.max_memory_allocated()`` from a reset just before it, with
every input it moves to the card included.

One JSON line: ``n``, ``seconds``, ``peak_bytes``, ``peak_gib``, the numbers
compared, the card. Where the card runs out of memory, the line names the
stage (``stand_ins`` or ``compare``) and the peak until then, and the
command exits 1.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: Frames of the stand-ins, and the step of their final state.
STEPS, NSTEPS = (1, 11, 12), 21


def stand_ins(phys, pos0, vel0):
    """Frames after each of :data:`STEPS` and the state after :data:`NSTEPS`
    from the reference in float32, in host memory."""
    import torch

    from benchmark import reference

    pos, vel = pos0.to(torch.float32), vel0.to(torch.float32)
    frames = []
    for step in range(1, NSTEPS + 1):
        pos, vel = reference.forward_step(pos, vel, phys)
        if step in STEPS:
            frames.append(pos.cpu().numpy())
    return frames, pos.cpu(), vel.cpu()


def measure(config: dict, n: int, seed: int, device) -> dict:
    """One comparison of the stand-ins of ``config``'s physics at ``n``
    particles, on ``device``."""
    import torch

    from benchmark import check
    from benchmark.initstate import lattice_state
    from benchmark.reference import Physics

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sim = dict(config["sim"], num_parts=n)
    phys = Physics.of(sim)
    out = {"n": n, "ndim": sim["ndim"], "law": phys.law, "seed": seed}
    stage = "stand_ins"
    try:
        pos0, vel0 = lattice_state(n, sim["ndim"], phys.size, seed, dev)
        frames, final_pos, final_vel = stand_ins(phys, pos0, vel0)
        pos0, vel0 = pos0.cpu(), vel0.cpu()
        stage = "compare"
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        numbers = check.compare(phys, pos0, vel0, frames, STEPS, final_pos, final_vel,
                                NSTEPS, dev)
        if cuda:
            torch.cuda.synchronize(dev)
        out["seconds"] = time.perf_counter() - t0
        out["numbers"] = numbers
    except torch.cuda.OutOfMemoryError as err:
        out["oom"] = stage
        out["error"] = str(err).splitlines()[0]
    if cuda:
        peak = torch.cuda.max_memory_allocated(dev)
        out.update(peak_bytes=peak, peak_gib=peak / 2 ** 30)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True, help="a configuration file")
    p.add_argument("--n", type=int, required=True, help="particles")
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    import torch

    from benchmark import core

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    with open(args.config) as f:
        config = json.load(f)
    out = measure(config, args.n, args.seed, "cuda:0")
    out["card"] = core.card_line()
    print(json.dumps(out), flush=True)
    return 1 if "oom" in out else 0


if __name__ == "__main__":
    sys.exit(main())
