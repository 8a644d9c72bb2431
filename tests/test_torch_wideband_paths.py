"""The wideband receiver's newer paths in the port against gmr1_tpu:
the off-grid pre-resampler, the wide-carrier synthesizer, and
WidebandReceiver (on the CPU) with multi-beam acquisition, a wide
carrier and an off-grid sample rate, on tests/test_wideband.py's
captures for each (built here with its helpers).

  * StreamPreResampler blocks and Channelizer.extract / WideStreamer
    chunks: within 1e-5 of the block's peak magnitude (float32 sums in
    another order; measured about 5e-7) and the same valid counts;
  * WidebandReceiver: identical (arfcn, type, fn, tn, bytes) frame
    lists, the same carriers at the same aligns, and the decoded SI1s
    match the synthesis truth.
"""

import numpy as np
import pytest
import torch

from gmr1_tpu.channelizer import pfb as j_pfb
from gmr1_tpu.channelizer.arfcn import Channel
from gmr1_tpu.l1 import bcch
from gmr1_tpu.ops import cplx
from gmr1_tpu.rx import gsmtap as gt
from gmr1_tpu.rx.wideband import WidebandReceiver as JRx
from gmr1_tpu.sdr import bursts as BU
from gmr1_tpu.sdr import fcch, modem
from gmr1_tpu_torch.channelizer import pfb as t_pfb
from gmr1_tpu_torch.channelizer.arfcn import Channel as TChannel
from gmr1_tpu_torch.rx.wideband import WidebandReceiver as TRx

from tests.test_receiver import F0, Capture, si1_l2
from tests.test_wideband import (A_FULL, CARRIER_RATE, CENTER, CENTER_ARFCN,
                                 FS, fill_bcch, mix_wideband)

torch.set_num_threads(2)

SPS = 4
FS_OFF = 530e3                       # 16.96 channels -> pre-resampled


def near(got, want, rel=1e-5):
    want = np.asarray(want)
    assert got.shape == want.shape
    peak = float(np.abs(want).max())
    assert np.abs(got - want).max() <= rel * peak, \
        (np.abs(got - want).max(), peak)


def puller(raw):
    pos = [0]

    def pull(n):
        out = raw[pos[0]:pos[0] + n]
        pos[0] += out.shape[0]
        return out
    return pull


@pytest.mark.parametrize("fs", [FS_OFF, 900e3, 30.72e6])
def test_pre_resampler_blocks_match(rng, fs):
    jz = j_pfb.Channelizer(fs, CENTER, sps=SPS)
    tz = t_pfb.Channelizer(fs, CENTER, sps=SPS)
    assert tz.pre_resamp.ratio_frac == jz.pre_resamp.ratio_frac
    np.testing.assert_array_equal(tz.pre_resamp.branches,
                                  jz.pre_resamp.branches)
    np.testing.assert_array_equal(tz.analyzer.h_poly,
                                  np.asarray(jz.analyzer.h_poly))
    raw = rng.normal(size=(47000, 2)).astype(np.float32)
    js = j_pfb.StreamPreResampler(jz.pre_resamp, 12000, puller(raw))
    ts = t_pfb.StreamPreResampler(tz.pre_resamp, 12000, puller(raw),
                                  device="cpu")
    for _ in range(5):
        (a, na), (b, nb) = js.produce_block(), ts.produce_block()
        assert nb == na
        if na:
            near(b.numpy(), a)
    assert ts.n_total == js.n_total
    # the one-shot front end: pre-resample (ArbResampler call) + analysis
    near(tz.process(torch.from_numpy(raw[:9000])).numpy(),
         jz.process(raw[:9000]))


def test_arb_resampler_call_matches(rng):
    jr, tr = j_pfb.ArbResampler(1.37), t_pfb.ArbResampler(1.37)
    np.testing.assert_array_equal(tr.branches, jr.branches)
    x = rng.normal(size=(3, 500, 2)).astype(np.float32)
    near(tr(torch.from_numpy(x)).numpy(), jr(x))


@pytest.mark.parametrize("width", [3, 5])
def test_wide_streamer_and_extract_match(rng, width):
    jz = j_pfb.Channelizer(1e6, CENTER, sps=SPS, need_nx=True)
    tz = t_pfb.Channelizer(1e6, CENTER, sps=SPS, need_nx=True)
    np.testing.assert_array_equal(tz.analyzer.h_poly,
                                  np.asarray(jz.analyzer.h_poly))
    jch, tch = Channel(512, width=width), TChannel(512, width=width)
    rows = 2500
    wb = rng.normal(size=(3 * rows * jz.analyzer.hop, 2)).astype(np.float32)
    bank = np.asarray(jz.process(wb))
    tbank = torch.from_numpy(np.array(bank))
    jw, tw = jz.wide_streamer(jch, rows), tz.wide_streamer(tch, rows)
    for b in range(3):
        blk = np.ascontiguousarray(bank[b * rows:(b + 1) * rows]
                                   .transpose(1, 0, 2))
        near(tw.feed(torch.from_numpy(blk)), jw.feed(blk))
    near(tz.extract(tbank, tch).numpy(), jz.extract(bank, jch))
    near(tz.extract(tbank, TChannel(512 + 2)).numpy(),
         jz.extract(bank, Channel(512 + 2)))


def multibeam_capture():
    """tests/test_wideband.py::test_multibeam_two_beams_one_arfcn: two
    FCCH trains 3 frames apart on one ARFCN, beam B's SI1s with
    sa_sirfn_delay 3."""
    rng = np.random.default_rng(0xBEA2)
    cap = Capture(rng, n_frames=44, noise=0.005)
    chirp = cplx.to_complex(
        fcch._chirp_np(fcch.FCCH, SPS, "dual")) / np.sqrt(2)
    si1s = {}
    for k in (0, 8, 16, 24, 32):
        cap.place_raw(k, 0, chirp)
    for k in (3, 11, 19, 27, 35):
        cap.place_raw(k, 0, chirp)
    for k in (2, 10, 18, 26, 34):
        si1s[F0 + k] = l2 = si1_l2(rng, F0 + k)
        cap.place_syms(k, 0, np.asarray(modem.mod(BU.BCCH, bcch.encode(l2))))
    for k in (5, 13, 21, 29, 37):
        si1s[F0 + k] = l2 = si1_l2(rng, F0 + k, delay=3)
        cap.place_syms(k, 0, np.asarray(modem.mod(BU.BCCH, bcch.encode(l2))))
    return mix_wideband({A_FULL: cap.buf}, rng), si1s


def wide_capture():
    """tests/test_wideband.py::test_wide_channel_receive: a width-3
    carrier with FCCH + SI1 at the band center."""
    rng = np.random.default_rng(0x3D3)
    ch = Channel(CENTER_ARFCN, width=3)
    cap = Capture(rng, n_frames=28, noise=0.004)
    si1s = fill_bcch(cap, rng)
    rate = ch.symbol_rate * SPS
    n_wb = int(np.floor((len(cap.buf) - 1) * FS / rate))
    pos = np.arange(n_wb) * rate / FS
    grid = np.arange(len(cap.buf), dtype=np.float64)
    bb = np.interp(pos, grid, cap.buf.real) \
        + 1j * np.interp(pos, grid, cap.buf.imag)
    t = np.arange(n_wb) / FS
    return (bb * np.exp(2j * np.pi * (ch.frequency - CENTER) * t)
            ).astype(np.complex64), si1s


def off_grid_capture():
    """tests/test_wideband.py::test_off_grid_fs_wideband_receive: one
    carrier at 530 kHz, off the 31.25 kHz grid."""
    rng = np.random.default_rng(0x0FF6)
    cap = Capture(rng, n_frames=28, noise=0.004)
    si1s = fill_bcch(cap, rng)
    n_in = len(cap.buf)
    n_wb = int(np.floor((n_in - 1) * FS_OFF / CARRIER_RATE))
    pos = np.arange(n_wb) * CARRIER_RATE / FS_OFF
    grid = np.arange(n_in, dtype=np.float64)
    bb = np.interp(pos, grid, cap.buf.real) \
        + 1j * np.interp(pos, grid, cap.buf.imag)
    t = np.arange(n_wb) / FS_OFF
    df = Channel(A_FULL).frequency - CENTER
    return (bb * np.exp(2j * np.pi * df * t)).astype(np.complex64), si1s


CASES = {
    "multibeam": (multibeam_capture, FS, dict(beams=2, arfcns=[A_FULL])),
    "wide": (wide_capture, FS, dict(arfcns=[], wide=(CENTER_ARFCN, 3))),
    "off_grid": (off_grid_capture, FS_OFF, dict(arfcns=[A_FULL])),
}


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    make, fs, kw = CASES[request.param]
    wb, si1s = make()
    jkw, tkw = dict(kw), dict(kw)
    if "wide" in kw:
        arfcn, width = jkw.pop("wide")
        tkw.pop("wide")
        jkw["wide_channels"] = [Channel(arfcn, width=width)]
        tkw["wide_channels"] = [TChannel(arfcn, width=width)]
    jrx = JRx(wb, fs, CENTER, sps=SPS, **jkw)
    jrx.run()
    trx = TRx(wb, fs, CENTER, sps=SPS, device="cpu", **tkw)
    trx.run()
    return request.param, jrx, trx, si1s


def test_same_frames(runs):
    _name, jrx, trx, _si1s = runs
    assert trx.frames == jrx.frames
    assert len(trx.frames) >= 3


def test_same_carriers(runs):
    _name, jrx, trx, _si1s = runs

    def acq(rx):
        return [(c.col, c.arfcn, c.cd.align, c.cd.fn, c.done)
                for c in rx.carriers]
    assert acq(trx) == acq(jrx)
    assert [(c.arfcn, c.frames) for c in trx.wide_carriers] == \
        [(c.arfcn, c.frames) for c in jrx.wide_carriers]


def test_si1_bit_exact(runs):
    name, _jrx, trx, si1s = runs
    cars = trx.wide_carriers if name == "wide" else trx.carriers
    assert len(cars) == (2 if name == "multibeam" else 1)
    for car in cars:
        got = {fn: l2 for t, fn, _tn, l2 in car.frames if t == gt.GMR1_BCCH}
        assert len(got) >= (3 if name == "multibeam" else 2), sorted(got)
        for fn, l2 in got.items():
            assert l2 == bytes(bytearray(si1s[fn]))
    if name == "off_grid":
        assert trx.chz.pre_resamp is not None and trx._pre is not None
