"""Smoke-test the benchmark (bench.py) on CPU.

A regression in its build/measure path would otherwise only surface on
the GPU. Tiny shapes, flagship architecture, one step.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


@pytest.mark.slow
def test_bench_build_and_measure_smoke(monkeypatch):
    monkeypatch.setattr(bench, "SECONDS", 1.0)
    monkeypatch.setattr(bench, "MAX_LABELS", 12)
    state, step, batch = bench.build(dp=False, batch_size=2)
    readings = bench.measure(state, step, batch, warmup=1, steps=1,
                             repeats=2)
    assert len(readings) == 2
    for ups in readings:
        assert np.isfinite(ups) and ups > 0


def test_bench_baseline_table_keys():
    # Every entry is ((batch, att), utt/s) with a positive measurement,
    # and the bench defaults have an exact entry (the ratio the driver
    # records must never fall back to a mismatched attention type).
    for (b, att), v in bench.CPU_BASELINE_UTT_PER_SEC.items():
        assert isinstance(b, int) and att in ("loc", "add", "dot") and v > 0
    assert (bench.BATCH, "dot") in bench.CPU_BASELINE_UTT_PER_SEC
