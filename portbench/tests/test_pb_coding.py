"""The benchmark's frozen coders against the program's (same bits)."""

import numpy as np
import pytest
import torch

from gmr1_tpu_torch.l1 import bcch, ccch, facch3, facch9, tch3, tch9
from gmr1_tpu_torch.ops import a5
from gmr1_tpu_torch.sdr import bursts as BU
from gmr1_tpu_torch.sdr import dkab as port_dkab
from gmr1_tpu_torch.sdr import fcch as port_fcch
from gmr1_tpu_torch.sdr import modem as port_modem
from portbench import coding, modem

torch.set_num_threads(2)
RNG = np.random.default_rng(5)


def _bytes(shape):
    return torch.as_tensor(RNG.integers(0, 256, shape, dtype=np.uint8))


@pytest.mark.parametrize("coder", ["bcch", "ccch"])
def test_control_coders(coder):
    l2 = _bytes((7, 24))
    port = {"bcch": bcch, "ccch": ccch}[coder].encode(l2)
    assert torch.equal(getattr(coding, coder)(l2), port)


def test_tch3():
    f0, f1 = _bytes((9, 10)), _bytes((9, 10))
    port = tch3.encode(f0, f1, torch.zeros(4, dtype=torch.uint8))
    assert torch.equal(coding.tch3(f0, f1), port)


def test_facch3():
    l2 = _bytes((5, 10))
    port = facch3.encode(l2, torch.zeros((5, 32), dtype=torch.uint8))
    assert torch.equal(coding.facch3(l2).reshape(5, 416), port)


def test_facch9_and_a5():
    fns = np.array([3, 77, 4096 + 5, 131071])
    ks = coding.a5_dl(bytes(8), fns, 658)
    for i, fn in enumerate(fns):
        assert np.array_equal(ks[i], a5.keystream_np(np.zeros(8, np.uint8),
                                                     int(fn), 658)[0])
    key = bytes(range(1, 9))
    assert np.array_equal(coding.a5_dl(key, fns[:1], 96)[0], a5.keystream_np(
        np.frombuffer(key, np.uint8), int(fns[0]), 96)[0])
    l2 = _bytes((4, 38))
    kst = torch.as_tensor(ks)
    port = facch9.encode(l2, torch.zeros((4, 10), dtype=torch.uint8),
                         torch.zeros((4, 4), dtype=torch.uint8), kst)
    assert torch.equal(coding.facch9(l2, kst), port)


@pytest.mark.parametrize("n", [1, 2, 5, 9])
def test_tch9_train(n):
    pay = _bytes((3, n, 60))
    ks = torch.as_tensor(RNG.integers(0, 2, (3, n, 658), dtype=np.uint8))
    got = coding.tch9_train(pay, ks)
    il = tch9.interleaver_init(dtype=torch.uint8)
    il = il._replace(buf=il.buf.expand(3, *il.buf.shape).clone(),
                     n=il.n.expand(3).clone())
    for j in range(n):
        il, e = tch9.encode(pay[:, j], tch9.MODE_9K6,
                            torch.zeros((3, 10), dtype=torch.uint8),
                            torch.zeros((3, 4), dtype=torch.uint8), il,
                            ks[:, j])
        assert torch.equal(got[:, j], e), j


@pytest.mark.parametrize("name,sid", [("BCCH", 0), ("DC6", 0),
                                      ("NT3_SPEECH", 0), ("NT3_FACCH", 0),
                                      ("NT3_FACCH", 1), ("NT9", 0),
                                      ("NT9", 1)])
def test_modulator(name, sid):
    ours, port = getattr(modem, name), getattr(BU, name)
    bits = torch.as_tensor(RNG.integers(0, 2, (3, ours.ebits),
                                        dtype=np.uint8))
    got = modem.mod(ours, bits, sid)
    ref = port_modem.mod(port, bits, sync_id=sid)
    ref = ref[..., 0] + 1j * ref[..., 1]
    # the program rotates in float32 (2e-5 at symbol 350), this in float64
    assert (got - ref).abs().max() < 1e-4


def test_fcch_chirp():
    ref = port_fcch._chirp_np(port_fcch.FCCH, 4, "dual") / np.sqrt(2.0)
    got = modem.fcch(4)
    assert np.abs(got.real - ref[:, 0]).max() < 1e-5
    assert np.abs(got.imag).max() == 0


def test_dkab_demodulates():
    bits = RNG.integers(0, 2, 8).astype(np.uint8)
    sig = np.zeros(117 * 4 + 64, np.complex64)
    sig[16:16 + 117 * 4] = modem.dkab(9, bits, 4)
    x = torch.as_tensor(np.stack([sig.real, sig.imag], -1))
    r = port_dkab.demod(x[None], 4, torch.tensor([9]))
    assert bool(r.found[0])
    assert [int(v < 0) for v in r.ebits[0]] == bits.tolist()
