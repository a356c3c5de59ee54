"""The control of every cell, at toy size on the CPU: the step below the
configuration's precision, put in the program's place, fails at least one
limit that a sound run of the same seed meets (``toy.py``)."""

import pytest
import torch

from portbench import control
from portbench.tests.toy import cells, toy_cell, toy_limits

CELLS = cells("serve_closed")


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [3, 2 ** 32 + 9])
def test_control_fails_a_limit(name, seed):
    cell = toy_cell(name)
    cpu = torch.device("cpu")
    prog = control.readings(cell.cfg, cell.mix, seed, cpu, control=False)
    ctrl = control.readings(cell.cfg, cell.mix, seed, cpu, control=True)
    limits = toy_limits(cell, {"checks": prog})
    assert any(ctrl[k] > lim for k, lim in limits.items()), (ctrl, limits)
