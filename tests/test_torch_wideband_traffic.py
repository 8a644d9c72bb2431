"""The traffic channels of the ported receiver: gmr1_tpu_torch's
WidebandReceiver (on the CPU) against gmr1_tpu's WidebandReceiver
(mesh=None) on two 500 kHz captures.

  * `e2e`: tests/test_wideband.py's wb_e2e story on one of three seeded
    carriers: IMM.ASS (TN 10, P 9), three TCH3 speech bursts, a FACCH3
    ASS.CMD.1 to TN 13 over four bursts, two DKABs, a FACCH9 burst, five
    ciphered TCH9 9k6 bursts, then silence that tears TCH3 down;
  * `reassign`: tests/test_wideband.py's re-assignment story: two
    ASS.CMD.1s and two CSD trains, on TN 13 and then TN 14.

Both receivers must emit identical (arfcn, type, fn, tn, bytes) frame
lists (so BCCH, CCCH, FACCH3, FACCH9 and CSD bits are exact, and DKAB
soft bits too on these captures) and identical speech and CSD per
carrier; the decoded content must also match the synthesis truth.
"""

import numpy as np
import pytest
import torch

from gmr1_tpu import native
from gmr1_tpu.l1 import ccch, facch3, facch9, tch3, tch9
from gmr1_tpu.rx import gsmtap as gt
from gmr1_tpu.rx.wideband import WidebandReceiver as JRx
from gmr1_tpu.sdr import bursts as BU
from gmr1_tpu.sdr import modem
from gmr1_tpu_torch.rx.wideband import WidebandReceiver as TRx

from tests.test_receiver import F0, Capture, dkab_signal, imm_ass_l2
from tests.test_wideband import (A_AUX, A_BCCH, A_FULL, CENTER, FS,
                                 fill_bcch, mix_wideband)

torch.set_num_threads(2)

SPS = 4
KC = np.zeros(8, np.uint8)
DKAB_BITS = [0, 1, 1, 0, 1, 0, 0, 1]


def a5(fn, n):
    return native.a5_keystream(KC, fn, n)[0]


def ass_cmd_1_l2(rng, tn9):
    """FACCH3 L2 of an ASS.CMD.1 to TCH9 slot tn9."""
    fl2 = rng.integers(0, 256, 10, dtype=np.uint8)
    fl2[3], fl2[4] = 0x06, 0x2E
    fl2[5] = (fl2[5] & 0xFC) | ((tn9 >> 3) & 0x03)
    fl2[6] = (fl2[6] & 0x1F) | ((tn9 & 0x07) << 5)
    fl2[9] &= 0xF0
    return fl2


def place_facch3(cap, tn, fl2, ks):
    fe = np.asarray(facch3.encode(fl2, np.zeros(32, np.uint8))).reshape(4, 104)
    for bi, k in enumerate(ks):
        cap.place_syms(k, tn, np.asarray(modem.mod(BU.NT3_FACCH, fe[bi],
                                                   sync_id=0)))


def place_csd(cap, rng, tn9, ks):
    """A ciphered 9k6 CSD train on tn9 at frames ks; returns payloads."""
    il = tch9.interleaver_init(dtype=np.uint8)
    pay = [rng.integers(0, 256, 60, dtype=np.uint8) for _ in ks]
    for i, k in enumerate(ks):
        il, eb = tch9.encode(pay[i], tch9.MODE_9K6, np.zeros(10, np.uint8),
                             np.zeros(4, np.uint8), il, a5(F0 + k, 658))
        cap.place_syms(k, tn9, np.asarray(modem.mod(BU.NT9, np.asarray(eb),
                                                    sync_id=1)))
    return [bytes(bytearray(p)) for p in pay]


def run_both(wb, **kw):
    jrx = JRx(wb, FS, CENTER, sps=SPS, **kw)
    jrx.run()
    trx = TRx(wb, FS, CENTER, sps=SPS, device="cpu", **kw)
    trx.run()
    return jrx, trx


def e2e_capture():
    """tests/test_wideband.py::wb_e2e's scenario, built inline.  Returns
    (wideband capture, truth dict)."""
    rng = np.random.default_rng(0xBEEF)
    caps = {a: Capture(rng, n_frames=28, noise=0.005)
            for a in (A_BCCH, A_FULL, A_AUX)}
    for a in caps:
        fill_bcch(caps[a], rng)
    cap = caps[A_FULL]
    tn, p, tn9 = 10, 9, 13
    cap.place_syms(3, 0, np.asarray(modem.mod(
        BU.DC6, ccch.encode(imm_ass_l2(rng, tn, p)))))
    speech = []
    for k in (4, 5, 6):
        f0 = rng.integers(0, 256, 10, dtype=np.uint8)
        f1 = rng.integers(0, 256, 10, dtype=np.uint8)
        speech += [bytes(f0), bytes(f1)]
        e = tch3.encode(f0, f1, np.zeros(4, np.uint8))
        cap.place_syms(k, tn, np.asarray(modem.mod(BU.NT3_SPEECH, e)))
    fl2 = ass_cmd_1_l2(rng, tn9)
    place_facch3(cap, tn, fl2, (8, 9, 10, 11))
    for k in (12, 13):
        cap.place_raw(k, tn, dkab_signal(rng, p, DKAB_BITS))
    f9l2 = rng.integers(0, 256, 38, dtype=np.uint8)
    f9l2[37] &= 0xF0
    e9 = np.asarray(facch9.encode(f9l2, np.zeros(10, np.uint8),
                                  np.zeros(4, np.uint8), a5(F0 + 12, 658)))
    cap.place_syms(12, tn9, np.asarray(modem.mod(BU.NT9, e9, sync_id=0)))
    csd = place_csd(cap, rng, tn9, range(13, 18))
    wb = mix_wideband({a: c.buf for a, c in caps.items()}, rng)
    return wb, dict(speech=speech, fl2=bytes(fl2), f9l2=bytes(f9l2), csd=csd)


@pytest.fixture(scope="module")
def e2e():
    wb, truth = e2e_capture()
    jrx, trx = run_both(wb)
    return dict(truth, jrx=jrx, trx=trx, wb=wb)


@pytest.fixture(scope="module")
def reassign():
    """tests/test_wideband.py::test_tch9_reassignment_resets_ring's
    scenario, built inline."""
    rng = np.random.default_rng(0x9A55)
    cap = Capture(rng, n_frames=28, noise=0.005)
    fill_bcch(cap, rng)
    tn, tn9a, tn9b = 10, 13, 14
    cap.place_syms(3, 0, np.asarray(modem.mod(
        BU.DC6, ccch.encode(imm_ass_l2(rng, tn, 9)))))
    place_facch3(cap, tn, ass_cmd_1_l2(rng, tn9a), (4, 5, 6, 7))
    place_facch3(cap, tn, ass_cmd_1_l2(rng, tn9b), (12, 13, 14, 15))
    pay_a = place_csd(cap, rng, tn9a, range(8, 13))
    pay_b = place_csd(cap, rng, tn9b, range(16, 21))
    wb = mix_wideband({A_FULL: cap.buf}, rng)
    jrx, trx = run_both(wb, arfcns=[A_FULL])
    return dict(jrx=jrx, trx=trx, pay_a=pay_a, pay_b=pay_b)


def _car(rx, arfcn):
    return next(c for c in rx.carriers if c.arfcn == arfcn)


def _of_type(car, t):
    return [l2 for typ, _fn, _tn, l2 in car.frames if typ == t]


SCENARIOS = ["e2e", "reassign"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_same_frames(request, name):
    run = request.getfixturevalue(name)
    got, want = run["trx"].frames, run["jrx"].frames
    assert got == want
    types = {f[1] for f in want}
    assert {gt.GMR1_TCH3 | gt.GMR1_FACCH, gt.GMR1_TCH9} <= types


@pytest.mark.parametrize("name", SCENARIOS)
def test_same_speech_and_csd(request, name):
    run = request.getfixturevalue(name)
    jrx, trx = run["jrx"], run["trx"]
    assert [c.arfcn for c in trx.carriers] == [c.arfcn for c in jrx.carriers]
    for jc, tc in zip(jrx.carriers, trx.carriers):
        assert tc.speech == jc.speech and tc.csd == jc.csd, tc.arfcn
    assert any(c.csd for c in trx.carriers)


@pytest.mark.parametrize("name", SCENARIOS)
def test_same_channel_state(request, name):
    """After the run every carrier's TCH3/TCH9 state is the same."""
    def state(rx):
        return [(c.arfcn, c.cd.fn, c.cd.align, c.cd.tch3.active,
                 c.cd.tch3.tn, c.cd.tch3.ciph, c.cd.tch3.weak_cnt,
                 c.cd.tch9.active, c.cd.tch9.tn, c.cd.tch9.from_fn)
                for c in rx.carriers]
    run = request.getfixturevalue(name)
    assert state(run["trx"]) == state(run["jrx"])


def test_e2e_speech_facch3_dkab(e2e):
    car = _car(e2e["trx"], A_FULL)
    assert car.speech[:6] == e2e["speech"]
    assert e2e["fl2"] in _of_type(car, gt.GMR1_TCH3 | gt.GMR1_FACCH)
    dk = _of_type(car, gt.GMR1_TCH3 | gt.GMR1_DKAB)
    assert len(dk) == 2
    for d in dk:
        assert (np.frombuffer(d, np.int8) < 0).astype(int).tolist() \
            == DKAB_BITS
    assert not car.cd.tch3.active          # silence -> weak count -> end


def test_e2e_facch9_and_csd(e2e):
    car = _car(e2e["trx"], A_FULL)
    assert e2e["f9l2"] in _of_type(car, gt.GMR1_TCH9 | gt.GMR1_FACCH)
    # depth-3 interleave: payload i decodes 2 bursts later
    idx = [car.csd.index(p) for p in e2e["csd"][:3] if p in car.csd]
    assert len(idx) == 3 and idx == sorted(idx)
    for other in (A_BCCH, A_AUX):
        c = _car(e2e["trx"], other)
        assert not c.speech and not c.csd


def test_reassign_both_trains_in_order(reassign):
    car = _car(reassign["trx"], A_FULL)
    ia = [car.csd.index(p) for p in reassign["pay_a"][:3] if p in car.csd]
    ib = [car.csd.index(p) for p in reassign["pay_b"][:3] if p in car.csd]
    assert len(ia) == 3 and ia == sorted(ia), (ia, len(car.csd))
    assert len(ib) == 3 and ib == sorted(ib), (ib, len(car.csd))
    assert max(ia) < min(ib)
    assert car.cd.tch9.tn == 14


def test_e2e_socket_source_same_frames(e2e):
    """tests/test_wideband.py::test_socket_source_identical_frames on
    the port: the e2e capture served as raw cf32 over TCP (SocketSource,
    consumed strictly forward, EOF at the peer's close) decodes the same
    frames, speech and CSD as the JAX receiver on the array."""
    import socket
    import threading

    from gmr1_tpu_torch.rx.cfile import SocketSource

    raw = np.ascontiguousarray(e2e["wb"], np.complex64).tobytes()
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def serve():
        conn, _ = srv.accept()
        for i in range(0, len(raw), 1 << 18):
            conn.sendall(raw[i:i + (1 << 18)])
        conn.close()

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    src = SocketSource("127.0.0.1", srv.getsockname()[1])
    try:
        rx = TRx(src, FS, CENTER, sps=SPS, device="cpu")
        rx.run()
    finally:
        src.close()
        th.join(timeout=30)
        srv.close()
    assert not th.is_alive()
    assert rx.frames == e2e["jrx"].frames
    for jc, tc in zip(e2e["jrx"].carriers, rx.carriers):
        assert (tc.arfcn, tc.speech, tc.csd) == (jc.arfcn, jc.speech, jc.csd)
