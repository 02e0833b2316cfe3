"""On the card: each cell at its own size, a short window, on three seeds,
with the control. The program must come out correct and the control (the
reference in bfloat16 in the program's place) not. Skips without a card.

    python -m pytest benchmark/tests/test_bench_card.py -q -m cuda
"""

from __future__ import annotations

import json

import pytest
import torch

import tiny
from benchmark import harness

SPEC = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
SEEDS = (3000000001, 3000000002, 3000000003)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_correct_and_control_not(card, cell):
    entry, cfg, traffic = harness.cell_files(SPEC, cell,
                                             tiny.REPO / "benchmark")
    drv = harness.driver(traffic["driver"])
    for seed in SEEDS:
        ctx = drv.run(cfg, traffic, seed, 2.0, False, card, entry["chips"],
                      0.0, control=True)
        assert ctx["checks"].correct(), ctx["checks"].record()
        assert not ctx["control"].correct(), ctx["control"].record()
