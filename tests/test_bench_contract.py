"""bench.py contract: exactly one JSON line on stdout.

The benchmark's stdout is its record, so the contract (one JSON line with
metric/value/unit/device, health gates enforced) is pinned here
hermetically via the CPU smoke mode.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "bench.py")

SMOKE_ENV = {
    "BENCH_PLATFORM": "cpu",
    "BENCH_RES": "8",
    "BENCH_SUBSTEPS_PER_CALL": "40",
    "BENCH_SECONDS": "0.3",
}


@pytest.mark.parametrize("res", ["8", "6"])
def test_bench_prints_exactly_one_json_line(res):
    env = {**os.environ, **SMOKE_ENV, "BENCH_RES": res}
    out = subprocess.run([sys.executable, BENCH], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, out.stdout
    row = json.loads(lines[0])
    assert set(row) == {"metric", "value", "unit", "device"}
    assert row["value"] > 0 and row["unit"] == "particle-substeps/s"
    assert row["device"]["platform"] == "cpu"
    assert str(int(res) ** 3) in row["metric"]


def test_bench_refuses_without_gpu():
    # without the explicit smoke mode a CPU-only host gets no number
    env = {k: v for k, v in os.environ.items() if k != "BENCH_PLATFORM"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, BENCH], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()
    assert "needs a GPU" in out.stderr
