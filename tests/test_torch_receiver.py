"""The port's per-carrier receiver (gmr1_tpu_torch.rx.Receiver, on the
CPU) and its CLI against gmr1_tpu's, on tests/test_receiver.py's e2e
capture: FCCH, SI1, IMM.ASS, three speech bursts, a FACCH3 ASS.CMD.1,
two DKABs, a FACCH9 and five ciphered 9k6 CSD bursts, then silence.

  * burst_energy: against gmr1_tpu.native.burst_energy to rtol 1e-6
    (both sum in float64 and round to float32; the energy sets the CCCH
    and TCH3 gates);
  * Receiver.run: identical (type, fn, tn, bytes) frames, speech and CSD
    lists, and the content matches the synthesis truth;
  * stream_run fed in chunks through a BoundedStream: the same frame,
    speech and CSD multisets as run();
  * `python -m gmr1_tpu_torch.rx SPS BCCH TCH KEY TCH_CSD --device cpu`
    against `python -m gmr1_tpu.rx` with --no-udp --pcap --csd-out
    --speech-out: identical GSMTap packets (pcap record timestamps
    aside) and identical CSD and speech bytes.
"""

import struct

import numpy as np
import pytest
import torch

from gmr1_tpu import native
from gmr1_tpu.rx import gsmtap as gt
from gmr1_tpu.rx.__main__ import main as j_main
from gmr1_tpu_torch.rx import CFile, Receiver
from gmr1_tpu_torch.rx.__main__ import main as t_main
from gmr1_tpu_torch.rx.cfile import BoundedStream
from gmr1_tpu_torch.rx.receiver import burst_energy

from tests.test_receiver import FRAME_LEN, SPS, e2e  # noqa: F401

torch.set_num_threads(2)


@pytest.mark.parametrize("n", [117 * 4 + 6, 1002, 64, 5])
def test_burst_energy_matches_native(rng, n):
    for scale in (1e-3, 1.0, 37.0):
        w = (rng.normal(size=(n, 2)) * scale).astype(np.float32)
        np.testing.assert_allclose(burst_energy(w), native.burst_energy(w),
                                   rtol=1e-6)


@pytest.fixture(scope="module")
def port_run(e2e):  # noqa: F811
    jrx = e2e[0]
    cf = CFile(jrx.bcch.path)
    trx = Receiver(cf, SPS, tch_file=cf, tch_csd_file=cf, device="cpu")
    trx.run()
    return jrx, trx


def test_same_frames_speech_csd(port_run):
    jrx, trx = port_run
    assert trx.frames == jrx.frames
    assert trx.speech == jrx.speech
    assert trx.csd == jrx.csd
    types = {t for t, *_ in trx.frames}
    assert {gt.GMR1_BCCH, gt.GMR1_CCCH, gt.GMR1_TCH3 | gt.GMR1_FACCH,
            gt.GMR1_TCH3 | gt.GMR1_DKAB, gt.GMR1_TCH9 | gt.GMR1_FACCH,
            gt.GMR1_TCH9} <= types


def test_content_matches_truth(e2e, port_run):  # noqa: F811
    _jrx, si1s, fl2, speech_frames, _tn, f9l2, csd = e2e
    trx = port_run[1]
    got = {fn: l2 for t, fn, _tn, l2 in trx.frames if t == gt.GMR1_BCCH}
    decoded = [fn for fn in si1s if fn in got]
    assert len(decoded) >= 3
    for fn in decoded:
        assert got[fn] == bytes(bytearray(si1s[fn]))
    assert trx.speech[:6] == speech_frames
    assert fl2 in [l2 for t, *_, l2 in trx.frames
                   if t == gt.GMR1_TCH3 | gt.GMR1_FACCH]
    assert f9l2 in [l2 for t, *_, l2 in trx.frames
                    if t == gt.GMR1_TCH9 | gt.GMR1_FACCH]
    idx = trx.csd.index(csd[0])
    assert trx.csd[idx:idx + 3] == csd[:3]


def test_stream_run_same_frames(port_run):
    jrx, trx = port_run
    data = np.asarray(trx.bcch.data)
    bs = BoundedStream()
    srx = Receiver(bs, SPS, tch_file=bs, tch_csd_file=bs, device="cpu")
    chunk = 2 * FRAME_LEN
    for i in range(0, data.shape[0], chunk):
        bs.feed(data[i:i + chunk])
        srx.stream_run()
        bs.trim(srx.stream_keep_from())
    assert srx.stream_run(eof=True)
    assert sorted(srx.frames) == sorted(trx.frames) == sorted(jrx.frames)
    assert sorted(srx.speech) == sorted(trx.speech)
    assert sorted(srx.csd) == sorted(trx.csd)
    assert bs.high_water <= srx._acq_need() + 2 * chunk


def pcap_packets(path) -> list[bytes]:
    """The packets of a GsmtapSink pcap, record timestamps dropped."""
    with open(path, "rb") as f:
        raw = f.read()
    out, o = [], 24
    while o < len(raw):
        n = struct.unpack_from("<IIII", raw, o)[2]
        out.append(raw[o + 16:o + 16 + n])
        o += 16 + n
    return out


def run_cli(main, tmp, tag, argv):
    files = {k: str(tmp / f"{tag}.{k}") for k in ("pcap", "csd", "speech")}
    rc = main(argv + ["--no-udp", "--pcap", files["pcap"], "--csd-out",
                      files["csd"], "--speech-out", files["speech"]])
    assert rc == 0

    def read(path):        # the CLI writes no file for no payloads
        try:
            with open(path, "rb") as f:
                return f.read()
        except FileNotFoundError:
            return b""
    return (pcap_packets(files["pcap"]),
            *(read(files[k]) for k in ("csd", "speech")))


def test_cli_per_carrier_same_output(e2e, tmp_path):  # noqa: F811
    jrx = e2e[0]
    cap = jrx.bcch.path
    argv = ["4", cap, cap, "00" * 8, cap]
    want = run_cli(j_main, tmp_path, "jax", argv)
    got = run_cli(t_main, tmp_path, "port", argv + ["--device", "cpu"])
    assert got == want
    pkts, csd, speech = got
    assert len(pkts) == len(jrx.frames)
    assert csd == b"".join(jrx.csd) and speech == b"".join(jrx.speech)
