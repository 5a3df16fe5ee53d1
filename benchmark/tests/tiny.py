"""A benchmark tree of tiny cells that exists only inside the tests: its
own BENCHMARK.json, configuration and mixes, and the real metric readers."""

import json
import os
import shutil

from benchmark import spec

#: The 2D and 3D configurations at a size the CPU runs in seconds; the
#: physics of hw2_2d_16m and lj3d_20m. ``tiny2d_sharded`` is tiny2d's physics
#: on the row-strip engine, at an n whose 29 bin rows put particles in each
#: of 4 strips (``ranks.py`` runs it on one rank a strip).
TINY = {
    "tiny2d": {"engine": "cuda", "sim": {
        "num_parts": 300, "ndim": 2, "force_law": "repulsive", "density": 0.0005,
        "mass": 0.01, "cutoff": 0.01, "dt": 0.0005, "dtype": "float32"}},
    "tiny2d_sharded": {"engine": "sharded_grid", "sim": {
        "num_parts": 4000, "ndim": 2, "force_law": "repulsive", "density": 0.0005,
        "mass": 0.01, "cutoff": 0.01, "dt": 0.0005, "dtype": "float32"}},
    "tiny3d": {"engine": "cuda3d", "sim": {
        "num_parts": 400, "ndim": 3, "force_law": "lj", "lj_epsilon": 0.0001,
        "lj_sigma": 0.007, "density": 7e-06, "mass": 0.01, "cutoff": 0.01,
        "dt": 0.0001, "dtype": "float32"}},
}
MIXES = {
    "short": {"nsteps": 30, "savefreq": 0, "check_savefreq": 20},
    "short10": {"nsteps": 30, "savefreq": 10, "check_savefreq": 10},
}
#: Gaps a few times what sound tiny runs read (~1e-7), far under what the
#: faults leave (1e-5 and up).
LIMITS = {"bad_rows": 0, "start_gap": 2e-6, "end_gap": 2e-6, "end_bulk_gap": 2e-6}


def make_tree(tmp, limits=LIMITS) -> str:
    """Write the tree under ``tmp``; returns its root."""
    root = str(tmp)
    for sub in ("configs", "traffic"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    shutil.copytree(os.path.join(spec.BENCH_DIR, "metrics"),
                    os.path.join(root, "metrics"), dirs_exist_ok=True)
    for name, cfg in TINY.items():
        with open(os.path.join(root, "configs", name + ".json"), "w") as f:
            json.dump(dict(cfg, name=name, reduced=[], limits=limits), f)
    for name, mix in MIXES.items():
        with open(os.path.join(root, "traffic", name + ".json"), "w") as f:
            json.dump(mix, f)
    bench = spec.load_benchmark()
    cells = [f"{c}.{m}" for c in TINY for m in MIXES]
    bench["workloads"] = [{"name": c, "config": c.split(".")[0],
                           "traffic": c.split(".")[1], "chips": 1, "why": "test"}
                          for c in cells]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            saved = any(w.endswith("saved10") for w in m["workloads"])
            m["workloads"] = [c for c in cells if c.endswith("short10") == saved]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
