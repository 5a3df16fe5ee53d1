"""``tools/compare_cost.py`` on the CPU at a tiny size: the stand-ins and
one comparison of them (its seconds and peak memory mean something only on
the card)."""

from benchmark.tests import tiny
from benchmark.tools import compare_cost


def test_compare_cost_runs_one_comparison():
    out = compare_cost.measure(tiny.TINY["tiny3d"], 400, 2 ** 31 + 5, "cpu")
    assert "oom" not in out and "peak_bytes" not in out and out["seconds"] > 0
    numbers = out["numbers"]
    assert set(numbers) == {"bad_rows", "start_gap", "end_gap", "end_bulk_gap"}
    # the float32 reference's frames against the float64 one's: round-off
    assert numbers["bad_rows"] == 0
    gaps = [numbers[k] for k in ("start_gap", "end_gap", "end_bulk_gap")]
    assert max(gaps) < tiny.LIMITS["start_gap"]
