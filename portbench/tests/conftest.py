"""Shared set-up of the benchmark's own tests (run on the CPU with
``python -m pytest portbench/tests``; the tests marked ``cuda`` need a
card and skip without one)."""
import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench_entries import bench_with_stage1  # noqa: E402

SMALL = {"frames": 16, "height": 96, "width": 80, "grid_points": 2000}


@pytest.fixture
def small_cell():
    """A cell (of ``bench_with_stage1()``) with its configuration cut to a
    size the CPU runs in a second."""
    from portbench import harness
    bench = bench_with_stage1()

    def make(name, **traffic):
        """``traffic`` replaces entries of the cell's mix (``loop`` too)."""
        cell = harness.find_cell(name, bench)
        config = {**cell.config, **{k: v for k, v in SMALL.items()
                                    if k in cell.config}}
        return dataclasses.replace(cell, config=config,
                                   traffic={**cell.traffic, **traffic})
    return make
