"""CPU tests of the benchmark itself (run: python -m pytest portbench/tests).

Tests that need a CUDA card carry the `card` marker and skip without
one; they decide inside the test, never at import."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: the benchmark measures only on one")
    return torch.device("cuda", 0)


TINY_MIX = dict(recording_s=3.2, recordings=2, noise_sigma=0.01,
                lead_s=[0.04, 0.08], calls=True, speech_s=[0.4, 0.8],
                warmup_s=1.6)


@pytest.fixture
def tiny():
    """A 2 MS/s grid of 8 live carriers (M = 64) and a short call mix."""
    import json
    with open(os.path.join(ROOT, "portbench", "tests", "tiny.json")) as f:
        return json.load(f), dict(TINY_MIX)
