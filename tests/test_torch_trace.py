"""gmr1_tpu_torch.trace in the wideband receiver: the spans of
WidebandReceiver's sections and its counts of burst windows, on
tests/test_wideband.py's e2e capture (FS 500 kHz, M = 16; TCH3 speech,
FACCH3, FACCH9 and CSD on one of three carriers), on the CPU.

  * a running torch.profiler changes no frame, speech or CSD; with none
    running no record_function is entered;
  * under the profiler every rx.block range holds rx.meta, rx.dispatch,
    rx.fetch and rx.walk in that order, rx.step lies inside rx.ingest,
    and every section of `prof` has its ranges;
  * in every block-loop iteration a section takes at most the sections
    it runs inside (trace.PARENT), and the outermost ones at most the
    iteration's wall;
  * dec.<kind> counts every window the phases decode (by hand from the
    schedules the block built), read.<kind> the windows the walks read,
    at most as many, and with traffic some TCH3 and NT9 windows;
    phase.slots and phase.traffic_slots the carrier slots the block
    phases' control and traffic halves ran on.
"""

import json
from unittest import mock

import pytest
import torch

from gmr1_tpu_torch import trace
from gmr1_tpu_torch.rx.wideband import WINDOW_KINDS
from gmr1_tpu_torch.rx.wideband import WidebandReceiver as TRx

from tests.test_torch_wideband_traffic import e2e_capture
from tests.test_wideband import CENTER, FS

torch.set_num_threads(2)

SPS = 4
BLOCK_ORDER = ("meta", "dispatch", "fetch", "walk")


def _record(rx, name, log):
    """Wrap rx.name so that each call's (args, result) goes to `log`."""
    orig = getattr(rx, name)

    def call(*a):
        out = orig(*a)
        log.append((a, out))
        return out
    setattr(rx, name, call)


def _no_range(*_a, **_k):
    raise AssertionError("record_function entered without a profiler")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    wb, _truth = e2e_capture()
    plain = TRx(wb, FS, CENTER, sps=SPS, device="cpu")
    log = {k: [] for k in ("_build_meta", "_build_sub_meta",
                           "_decode_facch")}
    for name, calls in log.items():
        _record(plain, name, calls)
    with mock.patch.object(torch.profiler, "record_function", _no_range):
        plain.run()
    traced = TRx(wb, FS, CENTER, sps=SPS, device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced.run()
    path = tmp_path_factory.mktemp("trace") / "rx.json"
    prof.export_chrome_trace(str(path))
    ev = json.loads(path.read_text())["traceEvents"]
    rx = [e for e in ev if e.get("cat") == "user_annotation"
          and str(e.get("name", "")).startswith(trace.PREFIX)]
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"][3:])
                    for e in rx)
    return dict(plain=plain, traced=traced, log=log, ranges=ranges)


def _outputs(rx):
    return rx.frames, [(c.arfcn, c.speech, c.csd) for c in rx.carriers]


def test_same_output_under_profiler(runs):
    assert _outputs(runs["traced"]) == _outputs(runs["plain"])
    assert any(c.csd for c in runs["plain"].carriers)
    assert any(c.speech for c in runs["plain"].carriers)


def test_no_range_without_profiler(runs):
    # the plain run finished with record_function raising, and timed
    # every section all the same
    assert set(runs["plain"].prof) == set(runs["traced"].prof)


def _of(ranges, name):
    return [(a, b) for a, b, n in ranges if n == name]


def test_block_holds_its_sections_in_order(runs):
    ranges = runs["ranges"]
    blocks = _of(ranges, "block")
    assert len(blocks) == sum("block" in p for p in runs["traced"]
                              .block_profs) > 0
    for a, b in blocks:
        first = [min((s for s, e in _of(ranges, n) if a <= s and e <= b),
                     default=None) for n in BLOCK_ORDER]
        assert None not in first, dict(zip(BLOCK_ORDER, first))
        assert first == sorted(first)


def test_step_inside_ingest(runs):
    ranges = runs["ranges"]
    ingest = _of(ranges, "ingest")
    acquire = _of(ranges, "acquire")
    steps = _of(ranges, "step")
    assert steps
    for s, e in steps:
        # the acquisition's passes step its blocks too
        assert any(a <= s and e <= b for a, b in ingest + acquire)
    assert any(a <= s and e <= b for s, e in steps for a, b in ingest)


@pytest.mark.parametrize("name", ["block", "phase", "meta", "dispatch",
                                  "fetch", "walk", "walk_tch3", "supp",
                                  "facch", "tch9", "ingest", "ingest_wait",
                                  "step", "resample", "acquire"])
def test_every_section_has_ranges(runs, name):
    assert name in runs["traced"].prof
    assert _of(runs["ranges"], name)


def test_dft_range_without_section(runs):
    assert _of(runs["ranges"], "dft")
    assert "dft" not in runs["traced"].prof


@pytest.mark.parametrize("child", sorted(trace.PARENT))
def test_child_at_most_its_parents(runs, child):
    rx = runs["plain"]
    seen = 0
    for p in rx.block_profs:
        parents = [p[k] for k in trace.PARENT[child] if k in p]
        if child in p and parents:
            seen += 1
            assert p[child] <= sum(parents) + 1e-9
    assert seen


def test_top_level_within_wall(runs):
    rx = runs["plain"]
    assert len(rx.block_profs) == len(rx.block_walls) > 0
    for p, wall in zip(rx.block_profs, rx.block_walls):
        assert sum(trace.top_level(p).values()) <= wall


def _by_hand(log, f_cnt: int) -> dict:
    """Windows decoded a kind: every carrier slot's BCCH and CCCH columns
    (as many as the most any slot has in the block, at least one) and
    the TCH3 and NT9 windows (one a frame) of the slots with a traffic
    channel at the block's start (`t`) in the block phase; the
    correction phases' slots, one window a frame; 4 bursts in each of
    two variants a FACCH3 flush."""
    n = dict.fromkeys(WINDOW_KINDS, 0)
    for (_ids, _f), m in log["_build_meta"]:
        slots = m["is_b"].shape[0]
        n["bcch"] += slots * max(1, int(m["is_b"].sum(1).max()))
        n["ccch"] += slots * max(1, int(m["is_c"].sum(1).max()))
        n["tch3"] += len(m["t"]) * f_cnt
        n["nt9"] += len(m["t"]) * f_cnt
    for (cars, kind, _f), _m in log["_build_sub_meta"]:
        n["tch3" if kind == "tch3" else "nt9"] += len(cars) * f_cnt
    for (jobs,), _out in log["_decode_facch"]:
        n["tch3"] += 2 * 4 * len(jobs)
    return n


@pytest.mark.parametrize("kind", WINDOW_KINDS)
def test_decoded_windows_by_hand(runs, kind):
    rx = runs["plain"]
    assert rx.counts[f"dec.{kind}"] == \
        _by_hand(runs["log"], rx.block_frames)[kind] > 0
    assert runs["traced"].counts == rx.counts


@pytest.mark.parametrize("key", ["slots", "traffic_slots"])
def test_phase_slots_by_hand(runs, key):
    """The slots of every block phase, and of its traffic half: the
    active slots with TCH3 or TCH9 up at the block's start, some but
    not all of them on the e2e capture."""
    metas = [m for _a, m in runs["log"]["_build_meta"]]
    want = dict(slots=sum(m["is_b"].shape[0] for m in metas),
                traffic_slots=sum(len(m["t"]) for m in metas))
    rx = runs["plain"]
    assert rx.counts[f"phase.{key}"] == want[key]
    assert 0 < rx.counts["phase.traffic_slots"] < rx.counts["phase.slots"]
    assert runs["traced"].counts == rx.counts


@pytest.mark.parametrize("kind", ["bcch", "ccch"])
def test_control_reads_by_hand(runs, kind):
    key = "is_b" if kind == "bcch" else "is_c"
    want = sum(int(m[key][m["act"]].sum())
               for _a, m in runs["log"]["_build_meta"])
    assert runs["plain"].counts[f"read.{kind}"] == want > 0


@pytest.mark.parametrize("kind", WINDOW_KINDS)
def test_read_at_most_decoded(runs, kind):
    c = runs["plain"].counts
    assert 0 <= c[f"read.{kind}"] <= c[f"dec.{kind}"]


@pytest.mark.parametrize("kind", ["tch3", "nt9"])
def test_traffic_windows_read(runs, kind):
    assert runs["plain"].counts[f"read.{kind}"] > 0


def test_span_times_nested_sections():
    prof: dict = {}
    with trace.span("outer", prof):
        with trace.span("inner", prof):
            sum(range(1000))
        with trace.span("inner", prof):
            pass
    assert 0.0 < prof["inner"] <= prof["outer"]
    with trace.span("range_only"):
        pass
    assert set(prof) == {"outer", "inner"}


def test_span_range_only_under_profiler():
    with mock.patch.object(torch.profiler, "record_function", _no_range):
        with trace.span("quiet", {}):
            pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("loud"):
            torch.ones(2).sum()
    assert any(e.name == "rx.loud" for e in prof.events())


def test_top_level_keeps_what_nothing_holds():
    sections = dict(block=3.0, phase=2.0, meta=1.0, ingest=0.5, wide=0.2)
    assert trace.top_level(sections) == dict(block=3.0, wide=0.2)
    # an iteration without a block: its ingest stands alone
    assert trace.top_level(dict(ingest=0.5, step=0.4)) == dict(ingest=0.5)
