"""Parity of the port's burst-type detection and one-shot / multi-beam
FCCH acquisition with gmr1_tpu, on the same seeded numpy inputs.

  * modem.detect: bt_id and sync_id exact, toa to 1e-4 (the same rule as
    demod's, tests/test_torch_modem_l1.py), pwr to rtol 1e-4;
  * modem.mod_order: exact;
  * fcch.rough, rough_multi, rough_multi_batch and rough_multi_batch_pwr
    on all three chirp variants (GMR-1 FCCH and the FCCH3 L- and S-band
    bursts), on captures built as tests/test_fcch.py builds them: the
    same TOA lists, the same valid masks.
"""

import numpy as np
import pytest
import torch

from gmr1_tpu.sdr import bursts as BU
from gmr1_tpu.sdr import fcch as j_fcch
from gmr1_tpu.sdr import modem as j_modem
from gmr1_tpu.sdr.defs import SYM_RATE
from gmr1_tpu_torch.sdr import bursts as TBU
from gmr1_tpu_torch.sdr import fcch as t_fcch
from gmr1_tpu_torch.sdr import modem as t_modem

from tests.test_fcch import make_capture
from tests.test_modem import channel

torch.set_num_threads(2)

SPS = 4
BURSTS = ["FCCH", "FCCH3_LBAND", "FCCH3_SBAND"]
N660 = (660 * SYM_RATE * SPS) // 1000
LP = (320 * SYM_RATE) // 1000 * SPS


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("e_toa", [-1.0, 6.0])
def test_detect_same_classification(rng, e_toa):
    sps, win = 4, 12
    types = (BU.NT3_FACCH, BU.NT3_SPEECH)
    caps = []
    for burst in types:
        ebits = rng.integers(0, 2, size=(3, burst.ebits)).astype(np.uint8)
        for sid in range(burst.n_sync):
            x1 = np.array(j_modem.mod(burst, ebits, sync_id=sid))
            caps.append(channel(x1, sps, delay=4.3 + sid, sigma=0.1,
                                win=win, rng=rng,
                                freq_err_per_sym=0.003))
    x = np.concatenate(caps)
    fs = np.linspace(-0.002, 0.002, len(x)).astype(np.float32)
    want = j_modem.detect(types, x, sps, win, freq_shift=fs, e_toa=e_toa)
    got = t_modem.detect((TBU.NT3_FACCH, TBU.NT3_SPEECH), _t(x), sps, win,
                         freq_shift=_t(fs), e_toa=e_toa)
    for name, g, w in zip(("bt_id", "sync_id"), got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=1e-4)
    # both burst types occur and are told apart
    assert set(got[0].tolist()) == {0, 1}


def test_mod_order_exact(rng):
    xs = []
    for burst in (BU.NT3_SPEECH, BU.NT3_FACCH, BU.BCCH, BU.DC6):
        e = rng.integers(0, 2, size=(2, burst.ebits)).astype(np.uint8)
        xs.append(channel(np.array(j_modem.mod(burst, e)), SPS, 0, win=0))
    for x in xs:
        got = t_modem.mod_order(_t(x), SPS).numpy()
        np.testing.assert_array_equal(got, np.asarray(j_modem.mod_order(x,
                                                                        SPS)))
    assert t_modem.mod_order(_t(xs[0]), SPS).tolist() == [4, 4]
    assert t_modem.mod_order(_t(xs[1]), SPS).tolist() == [2, 2]


def _multi_caps(rng, burst, spots):
    return np.stack([np.asarray(make_capture(
        rng, burst, SPS, [a, a + LP, b, b + LP], N660, noise=0.05))
        for a, b in spots])


@pytest.mark.parametrize("name", BURSTS)
def test_rough_same_toa(rng, name):
    jb, tb = getattr(j_fcch, name), getattr(t_fcch, name)
    n = (330 * SYM_RATE * SPS) // 1000 + jb.len_syms * SPS
    caps = np.stack([np.asarray(make_capture(rng, jb, SPS, [p], n,
                                             f_hz=f))
                     for p, f in ((5000, 0.0), (20000, 300.0),
                                  (12345, -700.0))])
    # the carrier offsets pre-corrected per row (radians per symbol)
    fs = (-2 * np.pi / SYM_RATE * np.asarray([0.0, 300.0, -700.0])
          ).astype(np.float32)
    want = np.asarray(j_fcch.rough(jb, caps, SPS, fs))
    got = t_fcch.rough(tb, _t(caps), SPS, _t(fs)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.all(np.abs(got - [5000, 20000, 12345]) <= 2 * SPS)
    np.testing.assert_array_equal(t_fcch.rough(tb, _t(caps), SPS).numpy(),
                                  np.asarray(j_fcch.rough(jb, caps, SPS)))


@pytest.mark.parametrize("name", BURSTS)
def test_rough_multi_same_toas(rng, name):
    jb, tb = getattr(j_fcch, name), getattr(t_fcch, name)
    caps = _multi_caps(rng, jb, [(4000, 26000), (9000, 17000)])
    for x in caps:
        for fs in (0.0, 0.01):
            want = j_fcch.rough_multi(jb, x, SPS, fs)
            assert t_fcch.rough_multi(tb, _t(x), SPS, fs) == want
    assert len(want) >= 2


@pytest.mark.parametrize("name", BURSTS)
def test_rough_multi_batch_same_beams(rng, name):
    jb, tb = getattr(j_fcch, name), getattr(t_fcch, name)
    caps = _multi_caps(rng, jb, [(4000, 26000), (9000, 17000),
                                 (3000, 21000)])
    noise = np.asarray(make_capture(rng, jb, SPS, [], N660, noise=0.05))
    caps = np.concatenate([caps, noise[None]])
    fs = np.asarray([0.0, 0.01, -0.01, 0.0], np.float32)
    want = j_fcch.rough_multi_batch(jb, caps, SPS, k=3, freq_shift=fs)
    got = t_fcch.rough_multi_batch(tb, _t(caps), SPS, k=3,
                                   freq_shift=_t(fs))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert want[1][:3, :2].all()

    # the incremental form: accumulated (unnormalized) correlation power
    pwr = np.asarray(j_fcch.scan_pwr(jb, caps[:, ::SPS]))
    want = j_fcch.rough_multi_batch_pwr(jb, pwr, SPS, k=3)
    got = t_fcch.rough_multi_batch_pwr(tb, _t(pwr), SPS, k=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_rough_multi_refuses_short_window():
    with pytest.raises(ValueError):
        t_fcch.rough_multi(t_fcch.FCCH, torch.zeros((1000, 2)), SPS)
