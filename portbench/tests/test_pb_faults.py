"""The check sees a broken timed path: each fault the receiver can have
(portbench/faults.py), planted under a run that skips the look for a
card, turns `correct` false (the control, fp8 DFT operands, is held in
test_pb_harness).  One card: there is no exchange between chips to
leave out."""

import pytest
import torch

from portbench import faults, run

torch.set_num_threads(2)


@pytest.mark.parametrize("name", sorted(faults.FAULTS))
def test_fault_fails_the_check(tiny, name):
    cfg, mix = tiny
    out, checks = run.measure(cfg, mix, 21, 0.5, False, torch.device("cpu"),
                              [], hook=faults.FAULTS[name])
    assert out["correct"] is False
    assert any(v > lim for v, lim in checks.values())
