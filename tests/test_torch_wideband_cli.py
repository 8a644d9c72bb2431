"""`python -m gmr1_tpu_torch.rx --wideband` (on the CPU) against
`python -m gmr1_tpu.rx --wideband`, every wideband option together on
one capture at an off-grid rate (530 kHz, 16.96 channels): multi-beam
acquisition (--beams 2: two FCCH trains 3 frames apart on ARFCN 500,
beam B's SI1s with sa_sirfn_delay 3) and a width-3 wide carrier
(--wide 504x3, FCCH + SI1) on the columns next to it.  The JAX CLI reads
the capture forward from the file (--stream, CFileSource); the port's
reads it from a TCP IQ server (tcp://, SocketSource).  Both must write
identical GSMTap packets (pcap record timestamps aside), and every SI1
of both beams and of the wide carrier must decode bit-exact.
"""

import socket
import struct
import threading

import numpy as np
import torch

from gmr1_tpu.channelizer.arfcn import Channel
from gmr1_tpu.l1 import bcch
from gmr1_tpu.ops import cplx
from gmr1_tpu.rx import gsmtap as gt
from gmr1_tpu.rx.__main__ import main as j_main
from gmr1_tpu.sdr import bursts as BU
from gmr1_tpu.sdr import fcch, modem
from gmr1_tpu_torch.rx.__main__ import main as t_main

from tests.test_receiver import F0, Capture, si1_l2
from tests.test_torch_receiver import run_cli
from tests.test_wideband import A_FULL, CENTER, fill_bcch

torch.set_num_threads(2)

SPS = 4
FS = 530e3
WIDE = Channel(504, width=3)


def to_band(buf, rate, df, n):
    """Baseband at `rate` -> n samples at FS, mixed up by df Hz."""
    pos = np.arange(n) * rate / FS
    grid = np.arange(len(buf), dtype=np.float64)
    bb = np.interp(pos, grid, buf.real, right=0.0) \
        + 1j * np.interp(pos, grid, buf.imag, right=0.0)
    return bb * np.exp(2j * np.pi * df * np.arange(n) / FS)


def capture():
    rng = np.random.default_rng(0xC11)
    beams = Capture(rng, n_frames=44, noise=0.005)
    chirp = cplx.to_complex(
        fcch._chirp_np(fcch.FCCH, SPS, "dual")) / np.sqrt(2)
    si1 = {}                       # (arfcn, fn) -> l2
    for k in range(0, 40, 8):
        beams.place_raw(k, 0, chirp)
        beams.place_raw(k + 3, 0, chirp)
        for kk, delay in ((k + 2, 0), (k + 5, 3)):
            si1[A_FULL, F0 + kk] = l2 = si1_l2(rng, F0 + kk, delay=delay)
            beams.place_syms(kk, 0, np.asarray(modem.mod(
                BU.BCCH, bcch.encode(l2))))
    wide = Capture(rng, n_frames=28, noise=0.004)
    for fn, l2 in fill_bcch(wide, rng).items():
        si1[WIDE.arfcn, fn] = l2
    rate = 23400.0 * SPS
    n = int(np.floor((len(beams.buf) - 1) * FS / rate))
    wb = to_band(beams.buf, rate, Channel(A_FULL).frequency - CENTER, n) \
        + to_band(wide.buf, WIDE.symbol_rate * SPS,
                  WIDE.frequency - CENTER, n)
    return wb.astype(np.complex64), si1


def serve(raw: bytes):
    """A one-shot TCP IQ server of `raw`; returns (port, thread)."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def run():
        conn, _ = srv.accept()
        for i in range(0, len(raw), 1 << 18):
            conn.sendall(raw[i:i + (1 << 18)])
        conn.close()
        srv.close()
    th = threading.Thread(target=run, daemon=True)
    th.start()
    return srv.getsockname()[1], th


def test_cli_wideband_all_options_same_output(tmp_path):
    wb, si1 = capture()
    path = tmp_path / "cap.cfile"
    wb.tofile(path)
    opts = ["--fs", str(FS), "--center", str(CENTER), "--arfcns",
            str(A_FULL), "--beams", "2", "--wide", str(WIDE)]
    want = run_cli(j_main, tmp_path, "jax",
                   ["--wideband", str(path), "--stream"] + opts)
    port, th = serve(wb.tobytes())
    got = run_cli(t_main, tmp_path, "port",
                  ["--wideband", f"tcp://127.0.0.1:{port}", "--device",
                   "cpu"] + opts)
    th.join(timeout=30)
    assert not th.is_alive()
    assert got == want

    # both beams of ARFCN 500 and the wide carrier: every SI1 bit-exact
    found = {}
    for pkt in got[0]:
        hdr = pkt[28:44]                 # after the IPv4 + UDP headers
        _v, _l, _t, tn, arfcn, _s, _n, fn, sub, *_ = struct.unpack(
            "!BBBBHbbIBBBB", hdr)
        if sub == gt.GMR1_BCCH:
            l2 = pkt[44:]
            assert l2 == bytes(bytearray(si1[arfcn, fn])), (arfcn, fn)
            found.setdefault(arfcn, set()).add(fn)
    beam_b = {fn for fn in found[A_FULL] if fn % 8 == 5}
    assert len(beam_b) >= 3 and len(found[A_FULL] - beam_b) >= 3
    assert len(found[WIDE.arfcn]) >= 2
