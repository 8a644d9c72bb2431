"""Parity of the port's modem (gmr1_tpu_torch.sdr.modem) and BCCH/CCCH
coders (gmr1_tpu_torch.l1) with gmr1_tpu.

  * the encoders are exact; mod is exact up to 2 ulp of unit-magnitude
    symbols (2.4e-7): XLA and PyTorch round float32 sin/cos of the
    continuous rotation in their own last bit;
  * demod on the same seeded windows: sync_id exact; toa and freq_err
    to rtol 1e-4 (freq_err with atol 1e-6 rad/symbol, since it sits near
    zero); soft bits within 1 sbit, and only where the port's soft
    symbol lies within 1e-3 of a quantizer edge (the frameworks compute
    atan2 and the normalizations in their own rounding);
  * decode is exact (bits, CRC flag, metric) on the same soft bits.
"""

import numpy as np
import pytest
import torch

from gmr1_tpu.l1 import bcch as j_bcch
from gmr1_tpu.l1 import ccch as j_ccch
from gmr1_tpu.sdr import bursts as BU
from gmr1_tpu.sdr import modem as j_modem
from gmr1_tpu_torch.l1 import bcch as t_bcch
from gmr1_tpu_torch.l1 import ccch as t_ccch
from gmr1_tpu_torch.sdr import bursts as TBU
from gmr1_tpu_torch.sdr import modem as t_modem

from tests.test_modem import channel

torch.set_num_threads(2)

CODERS = [(j_bcch, t_bcch, BU.BCCH), (j_ccch, t_ccch, BU.DC6)]
CODER_IDS = ["bcch", "ccch"]


def tburst(burst):
    return getattr(TBU, burst.name.upper())


def test_burst_catalog_copied():
    for b in BU.ALL_BURSTS:
        assert repr(tburst(b)) == repr(b)


@pytest.mark.parametrize("burst", [BU.BCCH, BU.DC6, BU.NT3_FACCH, BU.NT9],
                         ids=lambda b: b.name)
def test_mod_exact(rng, burst):
    ebits = rng.integers(0, 2, size=(3, burst.ebits)).astype(np.uint8)
    for sid in range(burst.n_sync):
        np.testing.assert_allclose(
            t_modem.mod(tburst(burst), ebits, sync_id=sid).numpy(),
            np.asarray(j_modem.mod(burst, ebits, sync_id=sid)),
            rtol=0, atol=2.4e-7)


@pytest.mark.parametrize("jl1,tl1,burst", CODERS, ids=CODER_IDS)
def test_encode_exact(rng, jl1, tl1, burst):
    l2 = rng.integers(0, 256, size=(4, 24), dtype=np.uint8)
    got = tl1.encode(l2).numpy()
    assert got.shape == (4, burst.ebits)
    np.testing.assert_array_equal(got, np.asarray(jl1.encode(l2)))


def seeded_windows(rng, jl1, burst, sps=4, win=20):
    """Encoded, modulated bursts through a band-limited channel with a
    fractional delay, carrier offset and noise."""
    l2 = rng.integers(0, 256, size=(6, 24), dtype=np.uint8)
    x1 = np.asarray(j_modem.mod(burst, jl1.encode(l2)))
    caps = [channel(x1[i:i + 1], sps, delay=3.0 + 2.3 * i,
                    freq_err_per_sym=0.004 * (i - 2), sigma=0.08, win=win,
                    rng=rng)[0] for i in range(len(x1))]
    fs = np.linspace(-0.002, 0.003, len(caps)).astype(np.float32)
    return l2, np.stack(caps), fs


@pytest.mark.parametrize("jl1,tl1,burst", CODERS, ids=CODER_IDS)
def test_demod_and_decode(rng, jl1, tl1, burst):
    sps, win = 4, 20
    l2, x, fs = seeded_windows(rng, jl1, burst, sps, win)
    want = j_modem.demod(burst, x, sps=sps, win=win, freq_shift=fs)
    tb = tburst(burst)
    got = t_modem.demod(tb, torch.from_numpy(x), sps, win,
                        torch.from_numpy(fs))
    np.testing.assert_array_equal(got.sync_id.numpy(),
                                  np.asarray(want.sync_id))
    np.testing.assert_allclose(got.toa.numpy(), np.asarray(want.toa),
                               rtol=1e-4)
    np.testing.assert_allclose(got.freq_err.numpy(),
                               np.asarray(want.freq_err),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.pwr.numpy(), np.asarray(want.pwr),
                               rtol=1e-4)

    # soft bits: equal except by one sbit at quantizer edges
    sv = t_modem.soft_symbols(tb, torch.from_numpy(x), sps, win,
                              torch.from_numpy(fs))[0].numpy()
    d = 128.0 * np.abs(np.round(sv) - sv)   # rounded to the sbit distance
    edge = np.repeat(np.abs(d % 1.0 - 0.5) < 1e-3, burst.mod.nbits, axis=-1)
    diff = got.ebits.numpy().astype(int) - np.asarray(want.ebits).astype(int)
    assert np.all(np.abs(diff) <= 1)
    assert np.all(edge[diff != 0])

    # decode: the port on the JAX soft bits == the JAX decode, and both
    # recover the payload
    ej = np.array(want.ebits)
    l2_t, bad_t, m_t = tl1.decode(torch.from_numpy(ej))
    l2_j, bad_j, m_j = jl1.decode(ej)
    np.testing.assert_array_equal(l2_t.numpy(), np.asarray(l2_j))
    np.testing.assert_array_equal(bad_t.numpy(), np.asarray(bad_j))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(l2_t.numpy(), l2)
    assert not bad_t.any()
    l2_o, bad_o, _ = tl1.decode(got.ebits)
    np.testing.assert_array_equal(l2_o.numpy(), l2)
    assert not bad_o.any()


@pytest.mark.parametrize("jl1,tl1,burst", CODERS, ids=CODER_IDS)
def test_decode_exact_on_noise(rng, jl1, tl1, burst):
    """Decode of random soft bits (CRC failures, tied metrics) is exact."""
    eb = rng.integers(-127, 128, size=(16, burst.ebits)).astype(np.int8)
    for a, b in zip(tl1.decode(torch.from_numpy(eb)), jl1.decode(eb)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
