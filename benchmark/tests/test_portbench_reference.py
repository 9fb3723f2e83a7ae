"""The plain reference against the port, and its control.

Each cell at a size a test run holds: the port polishes one job (on the
CPU, or on the card for the ``cuda`` case), and the reference, worked out
again from the job's files alone, has to give every window's layers and
consensus exactly. The control, the reference with its DP scores
saturated to int8 put in the program's place, has to come out not correct
by the same ``check.compare`` and ``check.verdict``; with int16 it may
not (every score of these cells fits in int16, PERF.md)."""

import pytest

from conftest import CELLS
from portbench import spec


def _device(request):
    dev = request.param
    if dev == "cuda":
        import torch
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU")
    return dev


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    return _device(request)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_matches_the_port_and_the_control_does_not(
        cell, device, tiny_cells, tmp_path):
    import control
    recs = list(control.readings(cell, [2 ** 31 + 5], ["int16", "int8"],
                                 device=device))
    prog, c16, c8 = recs
    assert prog["who"] == "program" and prog["windows"] > 0
    for key in ("failed_jobs", "targets_mismatch", "fasta_mismatch",
                "layers_mismatch", "consensus_mismatch_pct"):
        assert prog[key] == 0, (key, prog)
    assert prog["correct"] is True
    assert c16["correct"] is True and c16["layers_mismatch"] == 0
    assert c16["consensus_mismatch_pct"] == 0
    assert c8["correct"] is False and c8["consensus_mismatch_pct"] > 0


def test_sampled_windows_are_drawn_from_the_seed(tiny_cells, tmp_path):
    from portbench.inputs import prepare_inputs
    cell = spec.load_cell("ecoli_ont.polish")
    _, a = prepare_inputs(cell.config, cell.traffic, 77, str(tmp_path / "a"))
    _, b = prepare_inputs(cell.config, cell.traffic, 77, str(tmp_path / "b"))
    _, c = prepare_inputs(cell.config, cell.traffic, 78, str(tmp_path / "c"))
    assert a == b and a != c and all(len(v) for v in a.values())
