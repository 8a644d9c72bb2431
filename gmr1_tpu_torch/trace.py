"""Spans of the receiver's sections, on the host clock and, while a
torch.profiler runs, in its trace.

    with span("phase", rx.prof):
        ...

A span adds the section's host seconds into the `prof` dict it is given
(WidebandReceiver.prof, block_profs) and, while a profiler is running,
opens `record_function("rx." + name)`: the range lands in the profiler's
trace on the profiler's own clock, beside the device activity.  With no
profiler running a span costs a `perf_counter` pair and one flag test.

Spans nest.  A section's `prof` time holds its children's (`ingest`
holds `ingest_wait`); its self time is its time less its children's.
PARENT names, for each section that runs inside others, the sections it
runs inside.
"""

from __future__ import annotations

import functools
import time

import torch

PREFIX = "rx."

# section -> the sections it runs inside.  `ingest` runs inside `block`
# (the next block's read and step, queued behind this block's phase) or,
# in a block-loop iteration without a block, alone; `step` runs inside
# `ingest` and, over the acquisition's blocks, inside `acquire`, and so
# does `pre` (the off-grid pre-resampler's block, ahead of the step).
PARENT: dict[str, tuple[str, ...]] = {
    "phase": ("block",), "fetch": ("block",), "walk": ("block",),
    "walk_tch3": ("block",), "facch": ("block",), "tch9": ("block",),
    "ingest": ("block",),
    "meta": ("phase",), "dispatch": ("phase",),
    "supp": ("walk_tch3", "tch9"),
    "ingest_wait": ("ingest",), "step": ("ingest", "acquire"),
    "pre": ("ingest", "acquire"),
    "resample": ("step",),
}


def top_level(sections: dict) -> dict:
    """The entries of `sections` (a prof or block_profs dict) that none of
    its other entries holds: no section it runs inside is there."""
    return {k: v for k, v in sections.items()
            if not any(p in sections for p in PARENT.get(k, ()))}


class span:
    """Context manager: `name`'s host seconds into prof[name] (when a
    dict is given), and the profiler range "rx.<name>" while a profiler
    runs."""

    __slots__ = ("name", "prof", "t0", "rf")

    def __init__(self, name: str, prof: dict | None = None):
        self.name, self.prof = name, prof

    def __enter__(self):
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.prof is not None:
            self.prof[self.name] = self.prof.get(self.name, 0.0) \
                + (t1 - self.t0)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def section(name: str):
    """Method decorator: the call runs inside span(name, self.prof)."""
    def deco(fn):
        @functools.wraps(fn)
        def call(self, *a, **k):
            with span(name, self.prof):
                return fn(self, *a, **k)
        return call
    return deco
