"""Find a cell, its configuration, its traffic mix and its metrics by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix; each of those is a file of its own under
this folder (``configs/<name>.json``, ``traffic/<name>.json``), and so is
each metric's reader (``metrics/<name>.py``, a module with ``read(run)``
returning a number or None). A new cell, configuration, mix or metric is a
new file and a new entry: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List

__all__ = ["BENCH_DIR", "ROOT", "load_benchmark", "find_cell", "load_config",
           "load_mix", "load_reader", "metrics_for", "forbidden_modules"]

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)

#: Top-level module names that no benchmark process may hold: the JAX
#: stack and the JAX package the port was made from.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "ppsim_tpu"})


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[c['name'] for c in bench['workloads']]}")


def load_config(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _load_json(os.path.join(bench_dir, "configs", name + ".json"))


def load_mix(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _load_json(os.path.join(bench_dir, "traffic", name + ".json"))


def load_reader(metric: str, bench_dir: str = BENCH_DIR) -> Callable:
    """``read(run)`` of ``metrics/<metric>.py``."""
    path = os.path.join(bench_dir, "metrics", metric + ".py")
    modname = "benchmark_metric_" + "".join(
        c if c.isalnum() else "_" for c in metric)
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _applies(metric: dict, cell: str, default: Callable[[], bool]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return default()


def metrics_for(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced. A metric without ``workloads``
    belongs to every cell (a per-layer one to every cell that reports the
    end-to-end metric it ``moves``)."""
    e2e = [m for m in bench["end_to_end"]
           if _applies(m, cell, lambda: True)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if _applies(m, cell, lambda m=m: m["moves"] in names)]


def forbidden_modules(modules: Dict[str, object]) -> List[str]:
    """Loaded modules whose top-level name (the part before the first dot,
    compared whole) is in :data:`FORBIDDEN`."""
    return sorted(name for name in modules
                  if name.split(".", 1)[0] in FORBIDDEN)
