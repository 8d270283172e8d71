"""The control: the reference in float8 in the program's place must come
out not correct. On the card (marker ``cuda``) at the offline cell's own
size on three seeds, as benchmark/calibrate.py reads it; on the CPU at
tiny widths, that it reads no lower than the program and above it on
one number at least."""

import time

import pytest
import torch

from benchmark import check, spec
from benchmark.run import T_START, execute
from benchmark.tests.tiny import make_root


def test_control_reads_above_the_program_tiny(tmp_path):
    cell = spec.load_cell("tiny-offline", make_root(tmp_path))
    _, result, numbers = execute(cell, 31, 1.0, False, torch.device("cpu"),
                                 time.monotonic(), control=True)
    assert result["correct"]
    ctrl = [numbers[f"control_{n}"] - numbers[n] for n in check.NAMES]
    assert min(ctrl) >= 0 and max(ctrl) > 0, numbers


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
def test_control_fails_on_the_card(card, seed):
    cell = spec.load_cell("offline-0.6b-b192")
    _, result, numbers = execute(cell, seed, 1.0, False, card, T_START,
                                 control=True)
    assert result["correct"], numbers
    control = {n: numbers[f"control_{n}"] for n in check.NAMES}
    assert not check.judge(control, cell.limits), control
