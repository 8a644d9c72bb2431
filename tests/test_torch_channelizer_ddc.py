"""The direct per-carrier DDC front end and the splitter CLI, ported:
gmr1_tpu_torch.channelizer.ddc and `python -m gmr1_tpu_torch.channelizer`
against gmr1_tpu's on the same seeded inputs.

  * DirectParams: decimation plan and all three tap arrays, exactly;
  * _fir_decimate (one strided conv1d) against conv_general_dilated at
    rtol 1e-4;
  * DirectDDC: the stream at rtol 1e-4 and the decoded BCCH bits exactly
    (tests/test_channelizer.py:145), and the same L2 as the PFB front end
    on the same carrier (:285);
  * the CLI in both modes, run in-process with a --block that cuts the
    capture into two blocks: every per-carrier cfile (a narrow and a
    width-3 carrier) against the JAX CLI's at rtol 1e-4; in pfb mode the
    wide carrier against gmr1_tpu's synthesis with its subchannels'
    delays matched, as the port's is.
"""

import numpy as np
import pytest
import torch

from gmr1_tpu.channelizer import ddc as j_ddc
from gmr1_tpu.channelizer import pfb as j_pfb
from gmr1_tpu.channelizer.__main__ import main as j_main
from gmr1_tpu.channelizer.arfcn import Channel as j_Channel
from gmr1_tpu.l1 import bcch as j_bcch
from gmr1_tpu.sdr import bursts as BU
from gmr1_tpu.sdr import modem as j_modem
from gmr1_tpu_torch.channelizer import ddc as t_ddc
from gmr1_tpu_torch.channelizer.__main__ import main as t_main
from gmr1_tpu_torch.channelizer.arfcn import BASE_SYMRATE, Channel
from gmr1_tpu_torch.channelizer.pfb import Channelizer
from gmr1_tpu_torch.l1 import bcch
from gmr1_tpu_torch.ops import cplx
from gmr1_tpu_torch.sdr import modem

from tests.test_torch_wideband_paths import delay_matched_extract

torch.set_num_threads(2)

CENTER = 1525e6 + 31250 * 512
SPS = 4
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fs", [500e3, 1e6, 2e6, 30.72e6, 34e6])
@pytest.mark.parametrize("width", [1, 3])
def test_direct_params(fs, width):
    sym = BASE_SYMRATE * width
    t, j = t_ddc.DirectParams(fs, sym, SPS), j_ddc.DirectParams(fs, sym, SPS)
    assert (t.decim1, t.decim2, t.resamp) == (j.decim1, j.decim2, j.resamp)
    for name in ("taps1", "taps2", "taps_resamp"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))


@pytest.mark.parametrize("decim,n_taps,shape", [(5, 33, (700,)),
                                                (3, 8, (2, 3, 301)),
                                                (7, 91, (1000,))])
def test_fir_decimate(rng, decim, n_taps, shape):
    x = rng.normal(size=(*shape, 2)).astype(np.float32)
    taps = rng.normal(size=n_taps).astype(np.float32)
    got = t_ddc._fir_decimate(torch.as_tensor(x), taps, decim, n_taps)
    want = np.asarray(j_ddc._fir_decimate(x, taps, decim, n_taps))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def _bcch_capture(rng, fs, f_off, n_extra=4096):
    """One BCCH burst sinc-interpolated to fs at f_off Hz, in noise;
    returns (planar capture, l2)."""
    l2 = rng.integers(0, 256, size=(1, 24), dtype=np.uint8)
    x1 = np.asarray(j_modem.mod(BU.BCCH, np.asarray(j_bcch.encode(l2))))[0]
    xc = x1[:, 0] + 1j * x1[:, 1]
    ratio = fs / BASE_SYMRATE
    n = int((len(xc) + 30) * ratio)
    tt = np.arange(n) / ratio - 10.0
    s = np.sinc(tt[:, None] - np.arange(len(xc))[None, :]) @ xc
    t = np.arange(n + n_extra) / fs
    wb = (rng.standard_normal(n + n_extra)
          + 1j * rng.standard_normal(n + n_extra)) * 1e-3
    wb[:n] += s * np.exp(2j * np.pi * f_off * t[:n])
    return cplx.planar_np(wb.astype(np.complex64)), l2[0]


def _decode(stream):
    stream = torch.as_tensor(np.asarray(stream))
    blen = BU.BCCH.len_syms * SPS
    r = modem.demod(BU.BCCH, stream, sps=SPS, win=stream.shape[0] - blen)
    l2, bad, _ = bcch.decode(r.ebits)
    assert not int(bad)
    return l2.numpy()


def test_direct_ddc_stream_and_decode(rng):
    fs, f_off = 1e6, 93.75e3                  # 3 channels up
    wb, l2 = _bcch_capture(rng, fs, f_off)
    p = t_ddc.DirectParams(fs, BASE_SYMRATE, SPS)
    assert p.decim1 > 1 and p.resamp != 1
    got = t_ddc.DirectDDC(p, f_off)(torch.as_tensor(wb))
    want = np.asarray(j_ddc.DirectDDC(
        j_ddc.DirectParams(fs, BASE_SYMRATE, SPS), f_off)(wb))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(_decode(got), l2)


def test_ddc_vs_pfb_same_carrier(rng):
    fs = 1e6
    ch = Channel(512 + 3)
    wb, l2 = _bcch_capture(rng, fs, ch.frequency - CENTER, 8192)
    chz = Channelizer(fs, CENTER, sps=SPS)
    got_pfb = _decode(chz.extract(chz.process(torch.as_tensor(wb)), ch))
    got_ddc = _decode(t_ddc.DirectDDC(t_ddc.DirectParams(fs, BASE_SYMRATE,
                                                         SPS),
                                      ch.frequency - CENTER)(wb))
    np.testing.assert_array_equal(got_pfb, got_ddc)
    np.testing.assert_array_equal(got_pfb, l2)


@pytest.mark.parametrize("mode", ["pfb", "direct"])
def test_cli_matches_jax(rng, tmp_path, mode):
    fs = 1e6
    wb, _l2 = _bcch_capture(rng, fs, Channel(512 + 3).frequency - CENTER)
    cap = tmp_path / "cap.cfile"
    wb.tofile(cap)
    block = wb.shape[0] // 2 + 1001            # two blocks, the last short
    args = [str(cap), "-s", str(fs), "-f", str(CENTER), "-a", "515",
            "-a", "507x3", "--mode", mode, "--block", str(block)]
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    assert j_main(args + ["-o", str(tmp_path / "j")]) == 0
    assert t_main(args + ["-o", str(tmp_path / "t"), "--device", "cpu"]) == 0
    for a in (515, 507):
        name = f"arfcn_{a}.cfile"
        want = np.fromfile(tmp_path / "j" / name, np.float32)
        if mode == "pfb" and a == 507:
            # the port matches its wide carrier's subchannel delays, which
            # gmr1_tpu's CLI does not: its synthesis with them, block by
            # block as the CLI channelizes
            jz = j_pfb.Channelizer(fs, CENTER, sps=4, need_nx=True)
            wide = j_Channel(507, width=3)
            want = np.concatenate([delay_matched_extract(
                jz, np.asarray(jz.process(wb[b:b + block])), wide)
                for b in range(0, wb.shape[0], block)]).ravel()
        got = np.fromfile(tmp_path / "t" / name, np.float32)
        assert got.shape == want.shape and got.size > 0, (a, got.shape)
        np.testing.assert_allclose(got, want, **TOL)
