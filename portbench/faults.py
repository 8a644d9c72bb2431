"""Faults planted under a run, to show that the check catches them
(portbench/tests/test_pb_faults.py and test_pb_offgrid_faults.py on the
CPU; `sweep.py --fault` on the card, for the upper readings of the
numbers compared).  Each takes the fresh WidebandReceiver and breaks its
timed path in place.  FAULTS break every configuration; OFF_GRID_FAULTS
break the pre-resampler, which only a rate off the grid runs."""

from __future__ import annotations

import numpy as np
import torch


def state_unchanged(rx) -> None:
    """The ingest step returns the carried state unchanged: every block
    after the first decodes the first block's streams again."""
    orig, first = rx._step, []

    def step(x, *state):
        out = orig(x, *state)
        if not first:
            first.append(out)
        return first[0][0], out[1], state
    rx._step = step


def half_batch(rx) -> None:
    """Half of the carriers left out of every block."""
    orig = rx._process_block
    rx._process_block = lambda active, prefetch: orig(active[::2], prefetch)


def _every_tenth(rx, alter) -> None:
    orig, n = rx._emit, [0]

    def emit(car, chan_type, fn, tn, l2):
        n[0] += 1
        if n[0] % 10 == 0:
            fn, l2 = alter(fn, l2)
        return orig(car, chan_type, fn, tn, l2)
    rx._emit = emit


def answer_altered(rx) -> None:
    """A byte of every tenth frame altered where it is emitted."""
    def alter(fn, l2):
        l2 = np.asarray(l2).view(np.uint8).copy()
        l2[0] ^= 1
        return fn, l2
    _every_tenth(rx, alter)


def fn_altered(rx) -> None:
    """Every tenth frame emitted one frame number late."""
    _every_tenth(rx, lambda fn, l2: (fn + 1, l2))


def pre_slip(rx) -> None:
    """Every pre-resampled sample one sample late: the capture delayed
    by one sample at the wideband rate, far less than a symbol, which
    the frames do not show."""
    orig, last = rx._pre.produce_block, [None]

    def produce_block():
        out, n_valid = orig()
        prev = out[:1] * 0 if last[0] is None else last[0]
        last[0] = out[-1:].clone()
        return torch.cat([prev, out[:-1]]), n_valid
    rx._pre.produce_block = produce_block


def pre_tail_lost(rx) -> None:
    """The raw tail the pre-resampler carries on the host from one block
    to the next is lost (zeros): only each block's first outputs, whose
    taps reach back into it, go wrong."""
    pre = rx._pre
    orig = pre.produce_block

    def produce_block():
        pre._raw = np.zeros_like(pre._raw)
        return orig()
    pre.produce_block = produce_block


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch,
                                  answer_altered, fn_altered)}
OFF_GRID_FAULTS = {f.__name__: f for f in (pre_slip, pre_tail_lost)}
