"""The ported slice as a whole: gmr1_tpu_torch's WidebandReceiver (on the
CPU) against gmr1_tpu's WidebandReceiver(mesh=None) on the same capture.

A 500 kHz capture like tests/test_wideband.py's: three seeded carriers,
28 TDMA frames, FCCH every 8 frames, SI1 BCCH at k%8==2 and one CCCH
IMM.ASS.  Both receivers must acquire the same carriers at the same
aligns and emit identical (arfcn, type, fn, tn, bytes) BCCH and CCCH
frame lists; a second port run seeded with the JAX acquisition checks
the block loop on its own.
"""

import numpy as np
import pytest
import torch

from gmr1_tpu.l1 import ccch
from gmr1_tpu.rx import gsmtap as gt
from gmr1_tpu.rx.wideband import WidebandReceiver as JRx
from gmr1_tpu.sdr import bursts as BU
from gmr1_tpu.sdr import modem
from gmr1_tpu_torch.rx.wideband import WidebandReceiver as TRx

from tests.test_receiver import Capture, imm_ass_l2
from tests.test_wideband import (A_AUX, A_BCCH, A_FULL, CENTER, FS,
                                 fill_bcch, mix_wideband)

torch.set_num_threads(2)

SPS = 4
CTRL = (gt.GMR1_BCCH, gt.GMR1_CCCH)
TN, P = 10, 9


def ctrl_frames(rx):
    return [f for f in rx.frames if f[1] in CTRL]


def acq_tuples(rx):
    return [(c.col, c.arfcn, c.cd.align, c.cd.freq_err, c.snr)
            for c in rx.carriers]


@pytest.fixture(scope="module")
def slice_runs():
    rng = np.random.default_rng(0xBEEF)
    caps = {a: Capture(rng, n_frames=28, noise=0.005)
            for a in (A_BCCH, A_FULL, A_AUX)}
    si1 = {a: fill_bcch(caps[a], rng) for a in caps}
    ia = imm_ass_l2(rng, TN, P)
    caps[A_FULL].place_syms(3, 0, np.asarray(modem.mod(BU.DC6,
                                                       ccch.encode(ia))))
    wb = mix_wideband({a: c.buf for a, c in caps.items()}, rng)

    jrx = JRx(wb, FS, CENTER, sps=SPS)
    jacq = acq_tuples(jrx) if jrx.acquire() else []
    jrx.run()
    trx = TRx(wb, FS, CENTER, sps=SPS, device="cpu")
    tacq = acq_tuples(trx) if trx.acquire() else []
    trx.run()
    srx = TRx(wb, FS, CENTER, sps=SPS, device="cpu")
    srx.seed_carriers(jacq)
    srx.run()
    return dict(si1=si1, ia=bytes(ia), jrx=jrx, jacq=jacq, trx=trx,
                tacq=tacq, srx=srx)


def test_same_carriers_and_aligns(slice_runs):
    jacq, tacq = slice_runs["jacq"], slice_runs["tacq"]
    assert [a[:3] for a in tacq] == [a[:3] for a in jacq]
    np.testing.assert_allclose([a[3] for a in tacq], [a[3] for a in jacq],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose([a[4] for a in tacq], [a[4] for a in jacq],
                               rtol=1e-4)
    assert {A_BCCH, A_FULL, A_AUX} <= {a[1] for a in tacq}


def test_same_ctrl_frames(slice_runs):
    got, want = ctrl_frames(slice_runs["trx"]), ctrl_frames(slice_runs["jrx"])
    assert got == want
    assert len(got) >= 10


def test_seeded_acquisition_same_frames(slice_runs):
    assert ctrl_frames(slice_runs["srx"]) == ctrl_frames(slice_runs["jrx"])


def test_si1_bit_exact(slice_runs):
    trx, si1 = slice_runs["trx"], slice_runs["si1"]
    for arfcn in (A_BCCH, A_FULL, A_AUX):
        car = next(c for c in trx.carriers if c.arfcn == arfcn)
        got = {fn: l2 for t, fn, _tn, l2 in car.frames if t == gt.GMR1_BCCH}
        decoded = [fn for fn in si1[arfcn] if fn in got]
        assert len(decoded) >= 3, (arfcn, sorted(got))
        for fn in decoded:
            assert got[fn] == bytes(bytearray(si1[arfcn][fn]))


def test_imm_ass_sets_tch3_state(slice_runs):
    trx, jrx = slice_runs["trx"], slice_runs["jrx"]
    car = next(c for c in trx.carriers if c.arfcn == A_FULL)
    assert slice_runs["ia"] in [l2 for t, _fn, _tn, l2 in car.frames
                                if t == gt.GMR1_CCCH]
    st = car.cd.tch3
    assert (st.tn, st.p) == (TN, P)
    jst = next(c for c in jrx.carriers if c.arfcn == A_FULL).cd.tch3
    # no traffic follows the IMM.ASS, so both receivers' TCH3 walks
    # count the silent slot as weak and tear the channel down again
    assert (st.tn, st.p, st.active, st.weak_cnt) == \
        (jst.tn, jst.p, jst.active, jst.weak_cnt)
    assert not st.active


def test_block_loop_state_matches(slice_runs):
    """After the run every carrier sits at the same fn, slot and align."""
    def state(rx):
        return [(c.arfcn, c.cd.fn, c.cd.sa_bcch_stn, c.cd.align, c.done)
                for c in rx.carriers]
    assert state(slice_runs["trx"]) == state(slice_runs["jrx"])
    assert state(slice_runs["srx"]) == state(slice_runs["jrx"])
