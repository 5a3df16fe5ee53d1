"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``: each number
compared with its limit); the last lines of standard error are the same
numbers. Without a CUDA card, or with fewer cards than the cell asks for,
it exits 2 and prints no result; it exits 3 if a module of the JAX stack
or of the JAX package was loaded. A cell on several cards runs one worker
process a card (``ranks.py``); if one fails, it exits 1 and prints no
result.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True,
                   help="the window: it ends at the first simulation end past this")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from benchmark import core, ranks, spec

    cell = spec.find_cell(spec.load_benchmark(ROOT), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"no result: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    if cell["chips"] > 1:
        return ranks.launch(ranks.Job(args.workload, args.seed, args.seconds,
                                      bool(args.trace), T_START, root=ROOT), cell["chips"])
    result, lines = core.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), T_START, root=ROOT)
    return ranks.emit([(result, lines)])


if __name__ == "__main__":
    sys.exit(main())
