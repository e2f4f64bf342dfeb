"""On the card only (skipped elsewhere): the control fails the cell's
limits where the program passes them.  Each cell runs one wave at its own
size; the TF32 reference stands in for the program on the same sample.

    PYTHONPATH=src python -m pytest -q hibench/tests/test_hibench_card.py
"""
import json
from pathlib import Path

import pytest
import torch

from hibench import check, run

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    run._env()


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103])
def test_control_fails_where_the_program_passes(card, name, seed):
    cell = run.load_cell(name, ROOT)
    extra = {"control": True}
    res = run.execute(cell, seed, 0.0, False, "cuda", extra=extra)
    limits = cell.settings["check"]["limits"]
    assert res["correct"], res["checks"]
    assert not check.judge(extra["control"], limits), extra["control"]
