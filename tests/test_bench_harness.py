"""bench.py child-process harness (no device needed)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


def test_run_isolated_roundtrip():
    assert bench._run_isolated("_selftest_bench", 120) == {"ok": True}


def test_run_isolated_child_error():
    res = bench._run_isolated("_objective_missing", 120)
    assert "error" in res and "rc=1" in res["error"]


def test_run_isolated_timeout():
    # a hung block is killed and reported; the parent carries on
    res = bench._run_isolated("_sleep_bench", 3)
    assert res == {"error": "_sleep_bench timed out after 3s"}
