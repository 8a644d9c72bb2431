"""The usable band of the port's off-grid front end, on the CPU.

Behind the pre-resampler a column is usable when its own carrier stands
20 dB above the image its inward neighbour throws onto it, as the
column's own filters pass that image
(gmr1_tpu_torch.channelizer.pfb.usable_band); the receiver acquires no
column beyond the band, and refuses a candidate inside it that is the
image of its inward neighbour's carrier.

  * the band and the image levels equal a plain computation from
    portbench/pre.py's own design of the prototype (firdes.low_pass_2,
    float64) and from bank.py's and rrc.py's column filters, at 30.72
    MS/s (M = 984: out to 453 columns, ARFCN 91-997), 1.92 MS/s (M =
    62: every column but the Nyquist one, whose neighbours' images land
    13.75 kHz off centre, about 10 dB down the column's filters) and
    1.9075 MS/s (M = 62, out to 28), with either bank prototype;
  * on the grid there is no band and no refusal: every column is a
    candidate, as before;
  * a 1.92 MS/s capture with every column seeded (portbench's scene, two
    beams on every fourth ARFCN, a wide carrier): every due frame comes
    out bit-exact, nothing comes out or locks on the Nyquist column, and
    acq.out_of_band counts the candidates refused there;
  * a 1.9075 MS/s capture whose outermost usable columns are silent
    beside live ones: their images, 32 dB down and 1.25 kHz off their
    centre as at 30.72 MS/s, decode as the neighbour's frames unless the
    acquisition refuses them; with the refusal nothing comes out or
    locks there and every due frame of the live columns is bit-exact.
"""

import json
import os

import numpy as np
import pytest
import torch

from gmr1_tpu_torch.channelizer.pfb import BAND_MARGIN_DB, Channelizer
from gmr1_tpu_torch.rx import wideband
from gmr1_tpu_torch.rx.wideband import WidebandReceiver as TRx
from portbench import bank, harness, pre, rrc, scene

from tests.test_torch_wideband_paths import multibeam_capture
from tests.test_wideband import CENTER, FS

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = 31250.0
BAND_3072 = 453                 # 544 -/+ 453: ARFCN 91-997
SKY = dict(recording_s=3.2, recordings=1, noise_sigma=0.01,
           lead_s=[0.04, 0.08], calls=False, speech_s=[0.4, 0.8],
           warmup_s=1.6)


def _gain(h: np.ndarray, rate: float):
    """f -> |H(f)| of the taps h at the sample rate `rate`."""
    n = np.arange(len(h))
    return lambda f: abs(np.sum(h * np.exp(-2j * np.pi * f * n / rate)))


def _pre(fs: float, m: int):
    """|H(f)| of pre.py's float64 taps (gain L, rate L fs)."""
    return _gain(pre.taps(pre.ratio(fs, m)), 32 * fs)


def _chan(fs: float, m: int, nx: bool) -> float:
    """What the column's own filters, bank.py's prototype and rrc.py's
    RRC, pass of the image against the carrier: the image lands m grid -
    fs - grid off its column's centre."""
    off = m * GRID - fs - GRID
    proto = _gain(bank.prototype_nx(m) if nx else bank.prototype(m),
                  m * GRID)
    rrc_ = _gain(rrc.taps(2 * GRID, scene.SYM_RATE), rrc.L * 2 * GRID)
    return proto(off) / proto(0.0) * rrc_(off) / rrc_(0.0)


def plain_band(fs: float, m: int, nx: bool = False) -> int:
    """The last column out from the centre, of an unbroken run, whose
    carrier H(c grid) stands BAND_MARGIN_DB over its inward neighbour's
    image H(fs - (c - 1) grid) as the column's own filters pass it."""
    gain, chan = _pre(fs, m), _chan(fs, m, nx)
    assert round((m * GRID - fs) / GRID) == 1       # the inward neighbour
    c = 0
    while c + 1 < m // 2 and 20 * np.log10(
            gain((c + 1) * GRID) / (chan * gain(fs - c * GRID))) \
            >= BAND_MARGIN_DB:
        c += 1
    return c


@pytest.mark.parametrize("fs,m,want", [(30.72e6, 984, BAND_3072),
                                       (1.92e6, 62, 30),
                                       (1907500.0, 62, 28)])
@pytest.mark.parametrize("nx", [False, True])
def test_band_matches_plain(fs, m, want, nx):
    chz = Channelizer(fs, 1525e6 + GRID * 544, need_nx=nx)
    assert chz.n_chans == m and chz.pre_resamp is not None
    assert chz.band == plain_band(fs, m, nx) == want
    # the image the inward neighbour throws, against its own carrier
    gain, chan = _pre(fs, m), _chan(fs, m, nx)
    assert chz.image_step == 1
    for c in range(want - 2, m // 2):
        assert chz.image_db[c] == pytest.approx(20 * np.log10(
            chan * gain(fs - (c - 1) * GRID) / gain((c - 1) * GRID)),
            abs=1e-3)


@pytest.mark.parametrize("fs", [FS, 34e6, 2e6])
def test_no_band_on_the_grid(fs):
    chz = Channelizer(fs, 1525e6 + GRID * 544)
    assert chz.pre_resamp is None and chz.band is None


def test_on_grid_acquires_every_column():
    """On the grid the gate refuses nothing: every column of the bank is
    in band, the count stays 0, and the carriers and frames are those of
    a receiver without the gate (the multi-beam capture, two beams, no
    ARFCN filter)."""
    wb, _si1s = multibeam_capture()
    runs = []
    for gate in (True, False):
        rx = TRx(wb, FS, CENTER, sps=4, beams=2, device="cpu")
        assert all(rx._in_band(c) for c in range(rx.chz.n_chans))
        if not gate:
            rx._in_band = lambda _col: True
        rx.run()
        assert rx.counts["acq.out_of_band"] == rx.counts["acq.image"] == 0
        runs.append(([(c.col, c.cd.align, c.snr) for c in rx.carriers],
                     rx.frames))
    assert runs[0] == runs[1]
    assert len(runs[0][0]) > 2 and runs[0][1]


def _run(cfg, seed=808816518, rough=None):
    """One recording of cfg through portbench's harness on the CPU, and
    the rough scan's candidates (valid) of its acquisition."""
    seen = []
    orig = wideband.fcch.rough_multi_batch_pwr

    def spy(*a, **k):
        toa, valid = orig(*a, **k)
        seen.append(np.array(valid))
        return toa, valid
    mp = pytest.MonkeyPatch()
    mp.setattr(wideband.fcch, "rough_multi_batch_pwr", spy)
    try:
        h = harness.Harness(cfg, dict(SKY), seed, torch.device("cpu"))
        rec = h.run(0)
    finally:
        mp.undo()
    return h, rec, seen


def _tiny(**kw):
    with open(os.path.join(ROOT, "portbench", "tests",
                           "tiny_offgrid.json")) as f:
        cfg = json.load(f)
    return dict(cfg, **kw)


def _bit_exact(rec, inside):
    """Every due frame of an ARFCN in `inside` came out as sent, and
    nothing came out or locked elsewhere.  Returns the due count."""
    p = rec.plan
    got = {s[:3]: s[4] for s in rec.sent}
    assert {a for a, _t, _fn in got} <= inside
    assert set(rec.locked) <= inside
    due = 0
    for key, (pay, ok) in p.frames.items():
        if ok and key[0] in inside:
            due += 1
            assert got.get(key) == pay, key
    return due


@pytest.fixture(scope="module")
def sky():
    """tiny_offgrid with every column of the capture seeded."""
    cfg = _tiny()
    assert cfg["arfcns"] == [514, 574]          # 544 -/+ 30: every column
    return _run(cfg)


def test_whole_sky_inside_the_band(sky):
    h, rec, seen = sky
    m, band = h.cfg["n_chans"], 30
    assert h.cfg["fs"] == 1.92e6 and Channelizer(
        h.cfg["fs"], 1525e6 + GRID * 544).band == band
    inside = set(range(544 - band, 544 + band + 1))
    # every column but the wide carrier's (552 x 3) and its guards
    assert {c.arfcn for c in rec.plan.carriers} == \
        inside - {550, 551, 553, 554}
    assert _bit_exact(rec, inside) > 700
    r = harness.judge(h, rec)
    assert (r["wrong"], r["leaked"], r["unsent"], r["missed"],
            r["unlocked"]) == (0, 0, 0, 0, 0)
    # every rough candidate of the Nyquist column, which the band leaves
    # out, and no live carrier taken for an image
    (valid,) = seen
    signed = np.arange(m) - m * (np.arange(m) >= m // 2)
    out = np.abs(signed) > band
    assert out.sum() == 1
    assert rec.counts["acq.out_of_band"] == int(valid[out].sum()) >= 1
    assert rec.counts["acq.image"] == 0


SILENT = (516, 572)                 # the outermost usable columns, 544 -/+ 28


@pytest.mark.parametrize("refuse", [True, False])
def test_silent_column_beside_a_live_one(refuse, monkeypatch):
    """Columns 544 -/+ 28 lie inside the band at 1.9075 MS/s and are
    left silent; 544 -/+ 27 throw their images onto them, 32 dB down.
    The acquisition refuses those images and emits nothing there; a
    receiver that does not refuse them decodes the neighbours' frames
    there (fault 3.2's `leaked`)."""
    cfg = _tiny(fs=1907500.0, arfcns=[517, 571])
    assert Channelizer(cfg["fs"], 1525e6 + GRID * 544).band == 28
    if not refuse:
        monkeypatch.setattr(TRx, "_images",
                            lambda _s, toa, _e: np.zeros(toa.shape, bool))
    h, rec, _seen = _run(cfg)
    r = harness.judge(h, rec)
    if not refuse:
        assert set(r["by_arfcn"]["leaked"]) == set(SILENT)
        return
    inside = set(range(517, 572))
    assert _bit_exact(rec, inside) > 700
    assert (r["wrong"], r["leaked"], r["unsent"], r["missed"],
            r["unlocked"]) == (0, 0, 0, 0, 0)
    assert rec.counts["acq.image"] >= len(SILENT)
