"""A run with the timed path broken underneath has to come out not
correct: the harness's look for a card skipped (the CPU path), the rest
of a run driven as it is, one planted fault (``portbench/faults.py``) at a
time, in each cell."""

import pytest

from conftest import CELLS
from portbench.faults import FAULTS, planted


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_makes_the_run_not_correct(cell, fault, tiny_cells):
    import run as bench
    import racon_tpu_torch.cli  # noqa: F401  (the port, to patch)
    with planted(fault) as number:
        res = bench.run(cell, 2 ** 31 + 21, 0.05, False, device="cpu")
    assert res["correct"] is False
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_unbroken_run_is_correct(cell, tiny_cells):
    import run as bench
    res = bench.run(cell, 2 ** 31 + 21, 0.05, False, device="cpu")
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
