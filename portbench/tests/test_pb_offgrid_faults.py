"""The check sees a broken pre-resampler, planted under a run off the
grid that skips the look for a card: its output one sample late, a slip
the frames do not show; or the raw tail it carries from block to block
lost, which spoils only each block's first outputs.  Each turns
`correct` false through `pre_err`."""

import json
import os

import torch

from portbench import faults, run

HERE = os.path.dirname(os.path.abspath(__file__))
torch.set_num_threads(2)


def _measure(fault):
    with open(os.path.join(HERE, "tiny_offgrid.json")) as f:
        cfg = json.load(f)
    mix = dict(recording_s=3.2, recordings=1, noise_sigma=0.01,
               lead_s=[0.04, 0.08], calls=False, speech_s=[0.4, 0.8],
               warmup_s=1.6)
    return run.measure(cfg, mix, 21, 0.5, False, torch.device("cpu"), [],
                       hook=fault)


def test_pre_slip_fails_the_check():
    out, checks = _measure(faults.pre_slip)
    assert out["correct"] is False
    assert checks["pre_err"][0] > checks["pre_err"][1]
    assert (checks["wrong"][0], checks["missed"][0]) == (0, 0)
    assert set(checks) == set(run.LIMITS)


def test_pre_tail_lost_fails_the_check():
    out, checks = _measure(faults.pre_tail_lost)
    assert out["correct"] is False
    assert checks["pre_err"][0] > 3 * checks["pre_err"][1]
    assert set(checks) == set(run.LIMITS)
