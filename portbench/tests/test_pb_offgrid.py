"""The harness off the grid on the CPU: a 1.92 MS/s capture (M = 62)
with two beams on every fourth ARFCN and a width-3 wide carrier, every
grid column of its span seeded.  The receiver gets the configuration's
settings (and a configuration without them today's call); every due
frame of both beams and of the wide carrier decodes bit-exact, each on
its own timing; the plain pre-resampler and the bank of its output under
the perfect-reconstruction prototype against the program's, with their
controls; and the on-grid configurations' plans and recordings as they
were, pinned by digest."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from gmr1_tpu_torch.channelizer.arfcn import Channel
from gmr1_tpu_torch.channelizer.pfb import Channelizer
from portbench import bank, check, harness, pre, run, scene

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "portbench")
CPU = torch.device("cpu")
torch.set_num_threads(2)

OFF_MIX = dict(recording_s=3.2, recordings=1, noise_sigma=0.01,
               lead_s=[0.04, 0.08], calls=False, speech_s=[0.4, 0.8],
               warmup_s=1.6)


def _json(*path):
    with open(os.path.join(HERE, *path)) as f:
        return json.load(f)


@pytest.fixture
def offgrid():
    return _json("tests", "tiny_offgrid.json"), dict(OFF_MIX)


class _Called(Exception):
    pass


@pytest.mark.parametrize("name", ["tiny", "tiny_offgrid"])
def test_receiver_takes_the_configuration(monkeypatch, name):
    """Without `beams` and `wide_channels` the receiver is built exactly
    as before; with them it gets both, as the CLI passes them."""
    cfg = _json("tests", name + ".json")
    seen = {}

    def fake(*a, **k):
        seen.update(args=a, kw=k)
        raise _Called
    monkeypatch.setattr(harness, "WidebandReceiver", fake)
    h = harness.Harness.__new__(harness.Harness)
    h.cfg, h.dev, h.hook = cfg, CPU, None
    h.plans = [scene.plan(cfg, OFF_MIX, 1, 0)]
    sink = harness.TimedSink()
    with pytest.raises(_Called):
        h.receiver(np.zeros((8, 2), np.float32), sink)
    p = h.plans[0]
    assert seen["args"][1:] == (p.fs, p.center)
    want = dict(sps=4, sink=sink, h2d_dtype="float32", device=CPU)
    if name == "tiny_offgrid":
        want.update(beams=2, wide_channels=[Channel(552, width=3)])
    assert seen["kw"] == want


def _plan_digest(p) -> str:
    h = hashlib.sha256()
    h.update(repr((float(p.fs), float(p.center), int(p.n), float(p.lead_s),
                   int(p.fn_base), int(p.due_from), int(p.due_to),
                   [int(c.arfcn) for c in p.carriers])).encode())
    for k in sorted(p.frames):
        pay, due = p.frames[k]
        h.update(repr((tuple(int(x) for x in k), bytes(pay),
                       bool(due))).encode())
    for a in sorted(p.speech):
        h.update(repr((int(a), [bytes(x) for x in p.speech[a]])).encode())
    return h.hexdigest()[:16]


def _rec_digest(p) -> str:
    x = scene.synthesize(p, 0.01, CPU)
    return hashlib.sha256(x.tobytes()).hexdigest()[:16]


# (plan, recording) digests of the harness before configurations could
# state beams, wide carriers and rates off the grid, on the CPU with two
# threads: tiny.json under the tests' call mix, and lband34.json's plan
# under the control mix and a 0.48 s recording of it
PINNED = {("tiny", 808816518, 0): ("5e8da65bcf11680e", "3677dfe188de7d6b"),
          ("tiny", 808816518, 1): ("45a2ed471c07b0c7", "9b552a9c9f7919d0"),
          ("tiny", 4000000001, 0): ("dff3941cfe741771", "8a1e72cc8e716ee7"),
          ("tiny", 4000000001, 1): ("a808700bd1d4a1c4", "74f21fcef458dc4f")}
LBAND34_PLAN = "027e4b3a3c3352a4"
LBAND34_SHORT = ("2de45a185e85cb5d", "e5e8b4bd1370e44e")


def test_on_grid_scenes_as_before(tiny):
    cfg, mix = tiny
    for (_n, seed, i), want in PINNED.items():
        p = scene.plan(cfg, mix, seed, i)
        assert (_plan_digest(p), _rec_digest(p)) == want
    lb, ctl = _json("configs", "lband34.json"), _json("traffic",
                                                      "control.json")
    assert _plan_digest(scene.plan(lb, ctl, 2147483659, 0)) == LBAND34_PLAN
    p = scene.plan(lb, dict(ctl, recording_s=0.48), 2147483659, 1)
    assert (_plan_digest(p), _rec_digest(p)) == LBAND34_SHORT


def test_scene_spans_the_capture(offgrid):
    """Every column of the span carries a carrier but the wide carrier's
    and its guards; every fourth ARFCN a second beam; each its timing."""
    cfg, mix = offgrid
    assert scene.off_grid(cfg)
    chz = Channelizer(cfg["fs"], 1525e6 + 31250 * 544, need_nx=True)
    assert chz.n_chans == cfg["n_chans"] and chz.analyzer.p == \
        cfg["taps_per_branch"]
    half = int(cfg["fs"] / 2 // scene.GRID)
    assert cfg["arfcns"] == [544 - half, 544 + half]
    p = scene.plan(cfg, mix, 7, 0)
    first = [c.arfcn for c in p.carriers if c.width == 1 and not c.beam]
    assert first == [a for a in range(514, 575) if not 550 <= a <= 554]
    two = [c.arfcn for c in p.carriers if c.beam]
    assert two == [a for a in first if a % 4 == 0]
    wide = [(c.arfcn, c.width) for c in p.carriers if c.width > 1]
    assert wide == [(552, 3)]
    for c in p.carriers:
        assert mix["lead_s"][0] - 1e-6 <= c.lead_s <= mix["lead_s"][1] \
            + 4 * 39 / scene.SYM_RATE
        assert (c.lead_s != p.lead_s) == bool(c.beam or c.width > 1)
    # no two carriers' frames share a key; a frame's end is its sender's
    keys = {}
    for kind in ("bcch", "ccch"):
        for ci, k, tn, _pay in p.bursts[kind]:
            c = p.carriers[ci]
            t = scene.BCCH if kind == "bcch" else scene.CCCH
            key = (c.arfcn, t, p.fn_base + k)
            assert key not in keys and p.sender[key] == ci
            keys[key] = ci
            syms = (k * 936 + (tn + 6) * 39) / (scene.SYM_RATE * c.width)
            assert p.frame_end_s(*key, tn) == pytest.approx(c.lead_s + syms)


def test_beams_judged_apart(offgrid):
    """A second beam's frame emitted at its first beam's SI1 key is
    wrong; at a key where nothing was sent, leaked, not unsent."""
    cfg, mix = offgrid
    p = scene.plan(cfg, mix, 7, 0)
    sent = [(a, t, fn, 0, pay) for (a, t, fn), (pay, due) in
            p.frames.items() if due]
    assert check.judge(p, sent, {})["missed"] == 0
    c2 = next(ci for ci, c in enumerate(p.carriers) if c.beam)
    a = p.carriers[c2].arfcn
    b2 = [s for s in sent if s[0] == a and p.sender[s[:3]] == c2]
    b1 = [s for s in sent if s[0] == a and p.sender[s[:3]] != c2]
    assert b1 and b2
    _a, t, fn, tn, pay = b2[0]
    at_b1 = [(a, t, b1[0][2], tn, pay)]
    r = check.judge(p, [s for s in sent if s not in b1[:1]] + at_b1, {})
    assert (r["wrong"], r["leaked"]) == (1, 0)
    r = check.judge(p, sent + [(a, t, fn + 1, tn, pay)], {})
    assert (r["wrong"], r["leaked"], r["unsent"]) == (0, 1, 0)
    assert r["by_arfcn"] == {"leaked": {a: 1}}


@pytest.mark.parametrize("seed", [808816518])
def test_offgrid_truth_against_decode(offgrid, seed):
    cfg, mix = offgrid
    h = harness.Harness(cfg, mix, seed, CPU)
    rec = h.run(0)
    r = harness.judge(h, rec)
    assert (r["wrong"], r["missed"], r["unlocked"], r["leaked"]) == \
        (0, 0, 0, 0), r["findings"][:10]
    p = rec.plan
    got = {s[:3]: s[4] for s in rec.sent}
    due = {"first": 0, "second": 0, "wide": 0}
    for key, (pay, ok) in p.frames.items():
        c = p.carriers[p.sender[key]]
        if ok:
            kind = "wide" if c.width > 1 else ("second" if c.beam
                                               else "first")
            due[kind] += 1
            assert got.get(key) == pay, (kind, key)
    assert due["first"] > 700 and due["second"] > 80 and due["wide"] > 50
    assert rec.counts["dec.bcch"] > 0 and set(rec.counts) >= {
        "dec.ccch", "read.bcch", "read.ccch", "phase.slots"}
    assert (harness.latencies(rec) >= 0).all()
    assert harness.bank_check(h, rec) < 1e-5        # the CPU bank is f32
    assert harness.pre_check(h, rec) < 1e-6
    assert harness.stream_check(h, rec) < 1e-6
    # the controls read far above their limits
    assert harness.bank_check(h, rec, fp8=True) > 3 * run.LIMITS["bank_err"]
    assert harness.pre_check(h, rec, tf32=True) > 3 * run.LIMITS["pre_err"]
    assert harness.stream_check(h, rec, tf32=True) > 3 * run.LIMITS[
        "stream_err"]


def test_pre_reference():
    """The plain pre-resampler against the program's on random input:
    the same taps and the same outputs (float32), its TF32 control far
    off; and the perfect-reconstruction prototype against the bank's."""
    from gmr1_tpu_torch.channelizer import filters
    fs, m = 1.92e6, 62
    chz = Channelizer(fs, 1525e6 + 31250 * 544, need_nx=True)
    r = pre.ratio(fs, m)
    rs = chz.pre_resamp
    assert rs.ratio_frac == (r.numerator, r.denominator)
    t = pre.taps(r)
    assert np.abs(t - np.asarray(rs.branches).T.ravel()[:len(t)]).max() \
        < 1e-6 * np.abs(t).max()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((30000, 2)).astype(np.float32)
    got = rs(torch.as_tensor(x)).double().numpy()
    n = np.arange(0, got.shape[0] - 100, 7)
    ref = pre.resample(x, n, r)
    assert bank.rel_err(got[n, 0] + 1j * got[n, 1], ref) < 1e-6
    assert bank.rel_err(pre.resample(x, n, r, tf32=True), ref) > \
        3 * run.LIMITS["pre_err"]
    h = bank.prototype_nx(m)
    f = filters.low_pass_2(1.0, m, 0.5, 0.2, 80, "blackmanharris")
    assert len(h) == chz.analyzer.p * m
    assert np.abs(h[:len(f)] - f).max() < 1e-6 * np.abs(f).max()


def test_wide_due_after_its_latest_start(offgrid):
    """A wide carrier's receiver may start at the strongest FCCH of its
    multi-beam scan, two SI cycles after its first: made to start there,
    it still emits every frame the truth marks due, and the frames the
    truth leaves out are those of the cycles it skipped."""
    cfg, mix = offgrid

    def late(rx):
        for rxw in rx._wide_rx:
            orig = rxw.fcch_multi_scan
            rxw.fcch_multi_scan = lambda cd, orig=orig: [
                t + 16 * scene.FRAME4 for t in orig(cd)]
    h = harness.Harness(cfg, mix, 808816518, CPU, hook=late)
    rec = h.run(0)
    p = rec.plan
    wi = next(ci for ci, c in enumerate(p.carriers) if c.width > 1)
    a = p.carriers[wi].arfcn
    got = {s[:3] for s in rec.sent if s[0] == a}
    due = {k for k, (_pay, ok) in p.frames.items() if ok and k[0] == a}
    assert due and due <= got
    ks = sorted(k[2] - p.fn_base for k in got)
    assert ks[0] == 18 and min(k[2] - p.fn_base for k in due) == 18
    assert harness.judge(h, rec)["missed"] == 0


def test_rare_findings_first():
    lines = ["missed ARFCN 53 seeded BCCH fn 1", "missed ARFCN 53 seeded "
             "BCCH fn 9", "missed ARFCN 694 seeded CCCH fn 3",
             "speech ARFCN 7: 3 frames decoded, 4 sent, 1 differ"]
    by = {"missed": {53: 2, 694: 1}, "speech": {7: 1}}
    assert check.rare_first(lines, by) == lines[2:] + lines[:2]
