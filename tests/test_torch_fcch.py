"""Parity of the port's FCCH acquisition (gmr1_tpu_torch.sdr.fcch) with
gmr1_tpu.sdr.fcch on seeded dual-chirp captures.

Integer TOAs must match exactly; correlation power, frequency error and
SNR agree to rtol 1e-4 (float32 DFTs and convolutions summed in another
order; freq_err with atol 1e-6 rad/symbol near zero).
"""

import numpy as np
import pytest
import torch

from gmr1_tpu.sdr import fcch as j_fcch
from gmr1_tpu.sdr.defs import SYM_RATE
from gmr1_tpu_torch.sdr import fcch as t_fcch

from tests.test_fcch import make_capture

torch.set_num_threads(2)

SPS = 4
BURSTS = [("FCCH", 117), ("FCCH3_LBAND", 468)]


@pytest.mark.parametrize("name,n", BURSTS)
def test_chirps(name, n):
    jb, tb = getattr(j_fcch, name), getattr(t_fcch, name)
    assert (tb.freq, tb.len_syms) == (jb.freq, jb.len_syms) == (tb.freq, n)
    for kind in ("up", "down", "dual"):
        np.testing.assert_array_equal(t_fcch._chirp_np(tb, SPS, kind),
                                      j_fcch._chirp_np(jb, SPS, kind))


def test_scan_pwr_and_rough(rng):
    """The incremental scan: power of a symbol-rate segment, then the
    coarse TOA from it."""
    n = (330 * SYM_RATE * SPS) // 1000
    caps = np.stack([np.asarray(make_capture(rng, j_fcch.FCCH, SPS, [p], n))
                     for p in (5000, 20001, 30000)])
    seg = caps[:, ::SPS]
    pwr_j = np.array(j_fcch.scan_pwr(j_fcch.FCCH, seg))
    pwr_t = t_fcch.scan_pwr(t_fcch.FCCH, torch.from_numpy(seg)).numpy()
    np.testing.assert_allclose(pwr_t, pwr_j, rtol=1e-4,
                               atol=1e-4 * pwr_j.max())
    toa_j = np.asarray(j_fcch.rough_from_pwr(j_fcch.FCCH, pwr_j, SPS))
    toa_t = t_fcch.rough_from_pwr(t_fcch.FCCH,
                                  torch.from_numpy(pwr_j), SPS).numpy()
    np.testing.assert_array_equal(toa_t, toa_j)
    np.testing.assert_array_equal(
        t_fcch.rough_from_pwr(t_fcch.FCCH, torch.from_numpy(pwr_t),
                              SPS).numpy(), toa_j)
    assert np.all(np.abs(toa_j - [5000, 20001, 30000]) <= 2 * SPS)


@pytest.mark.parametrize("f_hz", [-800.0, 0.0, 1300.0])
def test_fine_and_snr(rng, f_hz):
    burst = j_fcch.FCCH
    blen = burst.len_syms * SPS
    full = np.asarray(make_capture(rng, burst, SPS, [8], blen + 16,
                                   f_hz=f_hz, noise=0.05))
    caps = np.stack([full[off:off + blen] for off in (8, 5, 13)])
    shift = np.float32(0.01)
    toa_j, ferr_j = j_fcch.fine(burst, caps, SPS, shift)
    toa_t, ferr_t = t_fcch.fine(t_fcch.FCCH, torch.from_numpy(caps), SPS,
                                shift)
    np.testing.assert_array_equal(toa_t.numpy(), np.asarray(toa_j))
    np.testing.assert_allclose(ferr_t.numpy(), np.asarray(ferr_j),
                               rtol=1e-4, atol=1e-6)
    fs = -np.array(ferr_j)
    snr_j = np.asarray(j_fcch.snr(burst, caps, SPS, fs))
    snr_t = t_fcch.snr(t_fcch.FCCH, torch.from_numpy(caps), SPS,
                       torch.from_numpy(fs)).numpy()
    np.testing.assert_allclose(snr_t, snr_j, rtol=1e-4)


def test_snr_on_noise(rng):
    """Noise windows (the acquisition's empty channels) score alike."""
    x = rng.normal(size=(8, 117 * SPS, 2)).astype(np.float32)
    np.testing.assert_allclose(
        t_fcch.snr(t_fcch.FCCH, torch.from_numpy(x), SPS).numpy(),
        np.asarray(j_fcch.snr(j_fcch.FCCH, x, SPS)), rtol=1e-4)
