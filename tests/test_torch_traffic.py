"""Parity of the port's traffic-channel modules with gmr1_tpu.

The same numpy inputs, made from a seed, go through both packages (JAX
on the CPU, torch on the CPU).  Tolerances:

  * encoders, the inter-burst interleaver, A5/1, puncturing tables:
    exact;
  * decoders (tch3, facch3, facch9, tch9 incl. decode_frames with a
    `valid` mask and a carried ring): bits, L2, CRC flags, status/SACCH
    bits and Viterbi metrics exact;
  * dkab.demod: `found` equal, toa within 1e-4 samples, soft bits within
    1 sbit and only where the value sits within 1e-3 of a rounding edge
    (the frameworks sum the float32 energy track and compute atan2 in
    their own order);
  * the receiver's TCH3 and NT9 cores on a small (C, F) window batch:
    decoded frames, CRC flags, sync ids, burst types and keystreams
    exact; energies to rtol 1e-5; soft bits within 1 sbit.
"""

import jax
import numpy as np
import pytest
import torch

from gmr1_tpu.l1 import facch3 as j_facch3
from gmr1_tpu.l1 import facch9 as j_facch9
from gmr1_tpu.l1 import tch3 as j_tch3
from gmr1_tpu.l1 import tch9 as j_tch9
from gmr1_tpu.ops import a5 as j_a5
from gmr1_tpu.ops import interleave as j_il
from gmr1_tpu.ops import puncture as j_punct
from gmr1_tpu.rx import wideband as j_wb
from gmr1_tpu.sdr import bursts as BU
from gmr1_tpu.sdr import dkab as j_dkab
from gmr1_tpu.sdr import modem as j_modem
from gmr1_tpu_torch.l1 import facch3 as t_facch3
from gmr1_tpu_torch.l1 import facch9 as t_facch9
from gmr1_tpu_torch.l1 import tch3 as t_tch3
from gmr1_tpu_torch.l1 import tch9 as t_tch9
from gmr1_tpu_torch.ops import a5 as t_a5
from gmr1_tpu_torch.ops import interleave as t_il
from gmr1_tpu_torch.ops import puncture as t_punct
from gmr1_tpu_torch.rx import wideband as t_wb
from gmr1_tpu_torch.sdr import dkab as t_dkab
from gmr1_tpu_torch.sdr import modem as t_modem
from gmr1_tpu_torch.sdr import bursts as TBU

from tests.test_dkab import make_dkab
from tests.test_modem import channel

torch.set_num_threads(2)

SPS = 4
W = SPS + SPS // 2          # the receiver's TCH3/NT9 TOA search window
MODES = ["2k4", "4k8", "9k6"]


def t(x):
    return torch.from_numpy(np.array(x))


def eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def assert_sbits_close(got, want):
    diff = np.asarray(got).astype(int) - np.asarray(want).astype(int)
    assert np.abs(diff).max(initial=0) <= 1


# --- puncturing, interleaving ----------------------------------------------

def test_puncture_copied():
    def fields(cat):
        return {k: (v.r, v.length, v.n, v.mask) for k, v in cat.items()}
    assert fields(t_punct.PUNCT) == fields(j_punct.PUNCT)
    for name in MODES:
        mode = j_tch9.MODES[name]
        eq(t_tch9._keep_idx(t_tch9.MODES[name]), j_tch9._keep_idx(mode))
    eq(t_tch3._keep_idx(), j_tch3._keep_idx())


@pytest.mark.parametrize("dtype", [np.int8, np.float32])
def test_interleave_inter_exact(rng, dtype):
    n, k, steps, c = 3, 24, 6, 4
    bursts = rng.integers(-127, 128, (steps, c, k)).astype(dtype)
    valid = rng.random((steps, c)) < 0.7
    jst = j_il.InterleaverState(buf=np.zeros((c, n, k), dtype),
                                n=np.zeros(c, np.int32))
    tst = t_il.InterleaverState(buf=t(np.zeros((c, n, k), dtype)),
                                n=torch.zeros(c, dtype=torch.int64))
    jd, td = jst, tst
    for s in range(steps):
        jst, jo = jax.vmap(j_il.interleave_inter)(jst, bursts[s])
        tst, to = t_il.interleave_inter(tst, t(bursts[s]))
        eq(to.numpy(), jo)
        jd, jdo = jax.vmap(j_il.deinterleave_inter)(jd, bursts[s], valid[s])
        td, tdo = t_il.deinterleave_inter(td, t(bursts[s]), t(valid[s]))
        eq(tdo.numpy(), jdo)
        eq(td.buf.numpy(), jd.buf)
        eq(td.n.numpy(), jd.n)
    eq(tst.buf.numpy(), jst.buf)
    eq(tst.n.numpy(), jst.n)


def test_interleave_inter_round_trip(rng):
    """Interleave then de-interleave: burst s comes back N-1 bursts later."""
    n, k = 3, 648
    il = t_il.interleaver_init(n, k, dtype=torch.uint8)
    dl = t_il.interleaver_init(n, k, dtype=torch.uint8)
    sent = [rng.integers(0, 2, k).astype(np.uint8) for _ in range(6)]
    got = []
    for b in sent:
        il, x = t_il.interleave_inter(il, t(b))
        dl, y = t_il.deinterleave_inter(dl, x)
        got.append(y.numpy())
    for s in range(len(sent) - (n - 1)):
        eq(got[s + n - 1], sent[s])


# --- A5/1 -------------------------------------------------------------------

def _fns(rng, count):
    fns = rng.integers(0, 1 << 19, count)
    fns[:4] = [0, 0x70000, 0x7FFFF, 0x12345 | 0x40000]   # bits 16-18 set
    return fns.astype(np.int64)


@pytest.mark.parametrize("nbits", [96, 208, 658])
def test_a5_keystream_plain_exact(rng, nbits):
    key = rng.integers(0, 256, 8, dtype=np.uint8)
    fns = _fns(rng, 12)
    dl, ul = t_a5.keystream_plain(key, t(fns), nbits)
    jdl, jul = j_a5.keystream(key, fns.astype(np.uint32), nbits)
    eq(dl.numpy(), jdl)
    eq(ul.numpy(), jul)
    for i in (0, 1, 3, 7):
        ndl, nul = j_a5.keystream_np(key, int(fns[i]), nbits)
        eq(dl[i].numpy(), ndl)
        eq(ul[i].numpy(), nul)
        tdl, tul = t_a5.keystream_np(key, int(fns[i]), nbits)
        eq(tdl, ndl)
        eq(tul, nul)
    dl2, ul2 = t_a5.keystream(key, t(fns.reshape(3, 4)), nbits,
                              with_ul=False)
    assert ul2 is None and dl2.shape == (3, 4, nbits)
    eq(dl2.reshape(-1, nbits).numpy(), dl.numpy())
    assert t_a5.keystream.launches == 0


def test_a5_ks208_is_prefix_of_ks658(rng):
    key = rng.integers(0, 256, 8, dtype=np.uint8)
    fns = t(_fns(rng, 8))
    eq(t_a5.keystream(key, fns, 208, with_ul=False)[0].numpy(),
       t_a5.keystream(key, fns, 658, with_ul=False)[0][..., :208].numpy())


def test_a5_cipher_stream(rng):
    key = rng.integers(0, 256, 8, dtype=np.uint8)
    fns = _fns(rng, 5)
    z, _ = t_a5.cipher_stream(0, key, t(fns), 40)
    assert z.shape == (5, 40) and not z.any()
    eq(t_a5.cipher_stream(1, key, t(fns), 40)[0].numpy(),
       j_a5.cipher_stream(1, key, fns.astype(np.uint32), 40)[0])
    with pytest.raises(ValueError):
        t_a5.cipher_stream(2, key, t(fns), 40)


def test_a5_kernel_entry_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        t_a5._keystream_cuda(np.zeros(8, np.uint8),
                             torch.zeros(3, dtype=torch.int64), 8)
    assert t_a5.keystream.launches == 0


# --- channel coders ---------------------------------------------------------

@pytest.mark.parametrize("m,ciphered", [(0, False), (0, True), (1, True)])
def test_tch3_encode_exact(rng, m, ciphered):
    f0 = rng.integers(0, 256, (3, 10), dtype=np.uint8)
    f1 = rng.integers(0, 256, (3, 10), dtype=np.uint8)
    st = rng.integers(0, 2, (3, 4), dtype=np.uint8)
    ks = rng.integers(0, 2, (3, 208), dtype=np.uint8) if ciphered else None
    got = t_tch3.encode(f0, f1, st, ks, m=m).numpy()
    assert got.shape == (3, 212)
    eq(got, j_tch3.encode(f0, f1, st, ks, m=m))


def test_facch3_encode_exact(rng):
    l2 = rng.integers(0, 256, (3, 10), dtype=np.uint8)
    st = rng.integers(0, 2, (3, 32), dtype=np.uint8)
    for ks in (None, rng.integers(0, 2, (3, 384), dtype=np.uint8)):
        eq(t_facch3.encode(l2, st, ks).numpy(), j_facch3.encode(l2, st, ks))


def test_facch9_encode_exact(rng):
    l2 = rng.integers(0, 256, (3, 38), dtype=np.uint8)
    sa = rng.integers(0, 2, (3, 10), dtype=np.uint8)
    st = rng.integers(0, 2, (3, 4), dtype=np.uint8)
    for ks in (None, rng.integers(0, 2, (3, 658), dtype=np.uint8)):
        eq(t_facch9.encode(l2, sa, st, ks).numpy(),
           j_facch9.encode(l2, sa, st, ks))


@pytest.mark.parametrize("mode", MODES)
def test_tch9_encode_exact(rng, mode):
    jm, tm = j_tch9.MODES[mode], t_tch9.MODES[mode]
    jil = j_tch9.interleaver_init(dtype=np.uint8)
    til = t_tch9.interleaver_init(dtype=torch.uint8)
    for _ in range(4):
        l2 = rng.integers(0, 256, jm.l2_bytes, dtype=np.uint8)
        sa = rng.integers(0, 2, 10, dtype=np.uint8)
        st = rng.integers(0, 2, 4, dtype=np.uint8)
        ks = rng.integers(0, 2, 658, dtype=np.uint8)
        jil, je = j_tch9.encode(l2, jm, sa, st, jil, ks)
        til, te = t_tch9.encode(l2, tm, sa, st, til, ks)
        eq(te.numpy(), je)
        eq(til.buf.numpy(), jil.buf)


def _noise_sbits(rng, shape):
    return rng.integers(-127, 128, size=shape).astype(np.int8)


@pytest.mark.parametrize("ciphered", [False, True])
def test_tch3_decode_exact_on_noise(rng, ciphered):
    eb = _noise_sbits(rng, (16, 212))
    ks = rng.integers(0, 2, (16, 208), dtype=np.uint8) if ciphered else None
    for a, b in zip(t_tch3.decode(t(eb), ks), j_tch3.decode(eb, ks)):
        eq(a.numpy(), b)


@pytest.mark.parametrize("jl1,tl1,nbits,nciph", [
    (j_facch3, t_facch3, 416, 384), (j_facch9, t_facch9, 662, 658)],
    ids=["facch3", "facch9"])
def test_facch_decode_exact_on_noise(rng, jl1, tl1, nbits, nciph):
    eb = _noise_sbits(rng, (12, nbits))
    for ks in (None, rng.integers(0, 2, (12, nciph), dtype=np.uint8)):
        for a, b in zip(tl1.decode(t(eb), ks), jl1.decode(eb, ks)):
            eq(a.numpy(), b)


def _soft(bits_u8, rng, sigma=20.0):
    s = np.where(np.asarray(bits_u8) > 0, -100.0, 100.0)
    s = s + rng.normal(0, sigma, s.shape)
    return np.clip(np.round(s), -127, 127).astype(np.int8)


def test_coders_round_trip(rng):
    """Noisy soft bits of encoded bursts decode to the payloads in both
    packages, with equal metrics and CRC flags."""
    f0 = rng.integers(0, 256, (4, 10), dtype=np.uint8)
    f1 = rng.integers(0, 256, (4, 10), dtype=np.uint8)
    ks = rng.integers(0, 2, (4, 208), dtype=np.uint8)
    e = _soft(j_tch3.encode(f0, f1, np.zeros((4, 4), np.uint8), ks), rng)
    got = t_tch3.decode(t(e), ks)
    eq(got[0].numpy(), f0)
    eq(got[1].numpy(), f1)
    eq(got[3].numpy(), j_tch3.decode(e, ks)[3])
    l2 = rng.integers(0, 256, (4, 10), dtype=np.uint8)
    l2[:, 9] &= 0xF0                                   # 76 message bits
    e = _soft(j_facch3.encode(l2, np.zeros((4, 32), np.uint8)), rng)
    l2_t, _s, bad, m = t_facch3.decode(t(e))
    eq(l2_t.numpy(), l2)
    assert not bad.any()
    eq(m.numpy(), j_facch3.decode(e)[3])


@pytest.mark.parametrize("mode", MODES)
def test_tch9_decode_frames_exact(rng, mode):
    """Chained decode of F bursts for C carriers with a validity mask
    and a ring carried in from an earlier call, against JAX."""
    jm, tm = j_tch9.MODES[mode], t_tch9.MODES[mode]
    f_cnt, c = 5, 3
    eb = _noise_sbits(rng, (f_cnt, c, 662))
    ks = rng.integers(0, 2, (f_cnt, c, 658), dtype=np.uint8)
    valid = rng.random((f_cnt, c)) < 0.7
    buf0 = rng.integers(-127, 128, (c, 3, 648)).astype(np.float32)
    n0 = np.asarray([0, 4, 7], np.int64)
    jil = j_il.InterleaverState(buf=buf0, n=n0.astype(np.int32))
    til = t_il.InterleaverState(buf=t(buf0), n=t(n0))
    jout = j_tch9.decode_frames(eb, jm, jil, ks, valid)
    tout = t_tch9.decode_frames(t(eb), tm, til, t(ks), t(valid))
    eq(tout[0].buf.numpy(), jout[0].buf)
    eq(tout[0].n.numpy(), jout[0].n)
    for a, b in zip(tout[1:], jout[1:]):
        eq(a.numpy(), b)
    # each carrier's valid bursts one at a time through decode() ==
    # the chained form
    for ci in range(c):
        st = t_il.InterleaverState(buf=t(buf0[ci]), n=torch.tensor(n0[ci]))
        for f in np.flatnonzero(valid[:, ci]):
            st, l2, *_ = t_tch9.decode(t(eb[f, ci]), tm, st, t(ks[f, ci]))
            eq(l2.numpy(), tout[1][f, ci].numpy())


def test_tch9_csd_round_trip(rng):
    """Encoded 9k6 bursts come back through decode_frames 2 bursts later."""
    m = t_tch9.MODE_9K6
    il = t_tch9.interleaver_init(dtype=torch.uint8)
    pays, ebs, kss = [], [], []
    for _ in range(5):
        pay = rng.integers(0, 256, 60, dtype=np.uint8)
        ks = rng.integers(0, 2, 658, dtype=np.uint8)
        il, e = t_tch9.encode(pay, m, np.zeros(10, np.uint8),
                              np.zeros(4, np.uint8), il, ks)
        pays.append(pay)
        ebs.append(_soft(e.numpy(), rng))
        kss.append(ks)
    _, l2, *_ = t_tch9.decode_frames(t(np.stack(ebs)), m,
                                     t_tch9.interleaver_init(), t(np.stack(kss)))
    for i in range(3):
        eq(l2[i + 2].numpy(), pays[i])


# --- DKAB -------------------------------------------------------------------

def _dkab_edges(x, sps, p, fs, toa):
    """float64 differential-phase values (..., 8) before rounding, at the
    port's rounded TOA."""
    xc = x[..., 0].astype(np.float64) + 1j * x[..., 1]
    i = np.arange(xc.shape[-1])
    y = xc * np.exp(1j * ((fs - np.pi / 4) / sps)[:, None] * i)
    idx = np.clip(np.round(toa).astype(int), 0, None)[:, None] + np.where(
        np.arange(8) < 4, sps * (2 + p)[:, None], sps * (61 + p)[:, None]) \
        + sps * (np.arange(8) & 3)
    a = np.take_along_axis(y, idx, -1)
    b = np.take_along_axis(y, idx + sps, -1)
    return (0.5 - np.abs(np.angle(a * np.conj(b))) / np.pi) * 254.0


def test_dkab_demod_parity(rng):
    sps, n_extra = 4, 16
    ps = np.asarray([5, 11, 0, 9, 3, 7], np.int64)
    rows = []
    for k, p in enumerate(ps):
        if k < 4:
            bits = rng.integers(0, 2, 8).tolist()
            rows.append(np.asarray(make_dkab(rng, sps, int(p), bits,
                                             off=2 + 3 * k, n_extra=n_extra,
                                             noise=0.05)))
        else:                                  # no DKAB: noise only
            n = j_dkab.DKAB_SYMS * sps + n_extra
            rows.append(rng.normal(0, 1, (n, 2)).astype(np.float32))
    x = np.stack(rows)
    fs = np.linspace(-0.01, 0.01, len(ps)).astype(np.float32)
    want = j_dkab.demod(x, sps, ps.astype(np.int32), fs)
    got = t_dkab.demod(t(x), sps, t(ps), t(fs))
    eq(got.found.numpy(), want.found)
    assert got.found.numpy().tolist() == [True] * 4 + [False] * 2
    np.testing.assert_allclose(got.toa.numpy(), np.asarray(want.toa),
                               rtol=0, atol=1e-4)
    v = _dkab_edges(x, sps, ps, fs.astype(np.float64), got.toa.numpy())
    edge = np.abs(np.abs(v % 1.0) - 0.5) < 1e-3
    diff = got.ebits.numpy().astype(int) - np.asarray(want.ebits).astype(int)
    assert np.abs(diff).max() <= 1
    assert np.all(edge[diff != 0])


def test_dkab_demod_scalar_p(rng):
    bits = [0, 1, 1, 0, 1, 0, 0, 1]
    x = np.asarray(make_dkab(rng, 4, 5, bits, off=7))
    got = t_dkab.demod(t(x), 4, 5)
    assert bool(got.found)
    assert (got.ebits.numpy() < 0).astype(int).tolist() == bits
    want = j_dkab.demod(x, 4, 5)
    np.testing.assert_allclose(float(got.toa), float(want.toa), atol=1e-4)


# --- the receiver's cores ---------------------------------------------------

def _streams_with(rng, windows, wlen):
    """(C, F) windows of length wlen laid out in (C, Ns, 2) streams at
    starts 40 + f*(wlen + 37); returns (streams, idx)."""
    c, f_cnt = len(windows), len(windows[0])
    step = wlen + 37
    ns = 40 + f_cnt * step + 64
    streams = rng.normal(0, 0.02, (c, ns, 2)).astype(np.float32)
    idx = 40 + np.arange(f_cnt)[None, :] * step + np.zeros((c, 1), np.int64)
    for ci, row in enumerate(windows):
        for f, win in enumerate(row):
            streams[ci, idx[ci, f]:idx[ci, f] + wlen] += win
    return streams, idx


def _burst_window(rng, burst, ebits, sync_id, wlen, k):
    x1 = np.asarray(j_modem.mod(burst, ebits, sync_id=sync_id))
    w = channel(x1, SPS, delay=2.0 + 0.3 * k, freq_err_per_sym=0.002,
                sigma=0.05, win=W, rng=rng)
    assert w.shape[0] == wlen
    return w


KEY = np.asarray([3, 1, 4, 1, 5, 9, 2, 6], np.uint8)


def _jit_core(fn, **static):
    return jax.jit(lambda *a: fn(*a, **static))


def test_tch3_core_parity(rng):
    """Speech (clear and ciphered), FACCH3 and DKAB windows on two
    carriers x four frames through both receivers' TCH3 cores."""
    wlen = BU.NT3_FACCH.len_syms * SPS + W
    fn0 = np.asarray([1000, 0x50013], np.int64)
    flags = np.asarray([0, 2], np.int64)           # row 1 ciphered
    p = np.asarray([9, 4], np.int64)
    speech, wins = {}, []
    for ci in range(2):
        row = []
        for f in range(4):
            fn = int(fn0[ci] + f)
            if f == 2:                                   # FACCH3 burst
                eb = rng.integers(0, 2, 104, dtype=np.uint8)
                row.append(_burst_window(rng, BU.NT3_FACCH, eb, 1, wlen, f))
            elif f == 3:                                 # DKAB
                win = np.zeros((wlen, 2), np.float32)
                win[3:3 + 117 * SPS] = np.asarray(make_dkab(
                    rng, SPS, int(p[ci]), [1, 0] * 4, n_extra=0, noise=0.0))
                row.append(win)
            else:
                fr = rng.integers(0, 256, (2, 10), dtype=np.uint8)
                speech[(ci, f)] = fr
                ks = j_a5.keystream_np(KEY, fn, 208)[0] if ci else None
                eb = np.asarray(j_tch3.encode(fr[0], fr[1],
                                              np.zeros(4, np.uint8), ks))
                row.append(_burst_window(rng, BU.NT3_SPEECH, eb, 0, wlen, f))
        wins.append(row)
    streams, idx = _streams_with(rng, wins, wlen)
    rows = np.arange(2, dtype=np.int64)
    fs = np.asarray([[0.001], [-0.002]], np.float32)
    jsmall, jfeb = _jit_core(j_wb._tch3_core, sps=SPS)(
        streams, rows.astype(np.int32), fs, fn0.astype(np.uint32),
        p.astype(np.int32), flags.astype(np.int32), idx.astype(np.int32),
        KEY)
    tsmall, tfeb = t_wb._tch3_core(t(streams), t(rows), t(fs), t(fn0), t(p),
                                   t(flags), t(idx), KEY, SPS)
    for k in ("bt", "f_sid", "dk_found"):
        eq(tsmall[k].numpy(), jsmall[k])
    for (ci, f), fr in speech.items():
        assert int(tsmall["bt"][ci, f]) == 1
        eq(tsmall["s_f0"][ci, f].numpy(), fr[0])
        eq(tsmall["s_f1"][ci, f].numpy(), fr[1])
        eq(tsmall["s_f0"][ci, f].numpy(), jsmall["s_f0"][ci, f])
        eq(tsmall["s_f1"][ci, f].numpy(), jsmall["s_f1"][ci, f])
    assert tsmall["dk_found"][:, 3].all()
    np.testing.assert_allclose(tsmall["et"].numpy(), jsmall["et"], rtol=1e-5)
    assert_sbits_close(tsmall["dk_bits"].numpy(), jsmall["dk_bits"])
    assert_sbits_close(tfeb.numpy(), jfeb)


def test_tch9_core_and_chain_parity(rng):
    """FACCH9 and ciphered 9k6 CSD windows on two carriers through both
    receivers' NT9 cores, then the chained CSD decode and its correction
    (_chain_core, _chain_fix) from the same soft bits."""
    wlen = BU.NT9.len_syms * SPS + W
    fn0 = np.asarray([77, 0x61234], np.int64)
    f_cnt = 5
    f9l2, wins, pays = {}, [], {0: [], 1: []}
    for ci in range(2):
        il = j_tch9.interleaver_init(dtype=np.uint8)
        row = []
        for f in range(f_cnt):
            ks = j_a5.keystream_np(KEY, int(fn0[ci] + f), 658)[0]
            if f == 0:
                l2 = rng.integers(0, 256, 38, dtype=np.uint8)
                l2[37] &= 0xF0
                f9l2[ci] = l2
                eb = np.asarray(j_facch9.encode(
                    l2, np.zeros(10, np.uint8), np.zeros(4, np.uint8), ks))
                row.append(_burst_window(rng, BU.NT9, eb, 0, wlen, f))
            else:
                pay = rng.integers(0, 256, 60, dtype=np.uint8)
                pays[ci].append(pay)
                il, eb = j_tch9.encode(pay, j_tch9.MODE_9K6,
                                       np.zeros(10, np.uint8),
                                       np.zeros(4, np.uint8), il, ks)
                row.append(_burst_window(rng, BU.NT9, np.asarray(eb), 1,
                                         wlen, f))
        wins.append(row)
    streams, idx = _streams_with(rng, wins, wlen)
    rows = np.arange(2, dtype=np.int64)
    fs = np.zeros((2, 1), np.float32)
    jsmall, je9, jks = _jit_core(j_wb._tch9_core, sps=SPS)(
        streams, rows.astype(np.int32), fs, fn0.astype(np.uint32),
        idx.astype(np.int32), KEY)
    tsmall, te9, tks = t_wb._tch9_core(t(streams), t(rows), t(fs), t(fn0),
                                       t(idx), KEY, SPS)
    eq(tks.numpy(), jks)
    eq(tsmall["sid9"].numpy(), jsmall["sid9"])
    eq(tsmall["sid9"].numpy(), [[0, 1, 1, 1, 1]] * 2)
    eq(tsmall["badf9"].numpy(), jsmall["badf9"])
    for ci in range(2):
        assert not int(tsmall["badf9"][ci, 0])
        eq(tsmall["l2f9"][ci, 0].numpy(), f9l2[ci])
    assert_sbits_close(te9.numpy(), je9)

    # the chain from the JAX soft bits, so both see the same input
    e9 = np.asarray(je9)
    flags = np.asarray([1 | (0b11110 << 16), 1 | (0b11100 << 16)], np.int64)
    jil = j_il.InterleaverState(buf=np.zeros((2, 3, 648), np.float32),
                                n=np.zeros(2, np.int32))
    til = t_il.InterleaverState(buf=torch.zeros((2, 3, 648)),
                                n=torch.zeros(2, dtype=torch.int64))
    jil2, jl2a = j_wb._chain_core(e9, jks, jil, jsmall["sid9"],
                                  flags.astype(np.int32))
    til2, tl2a = t_wb._chain_core(t(e9), tks, til, tsmall["sid9"], t(flags))
    eq(tl2a.numpy(), jl2a)
    eq(til2.buf.numpy(), jil2.buf)
    eq(til2.n.numpy(), jil2.n)
    for k in range(2):               # payloads 0, 1 of row 0 at f=3, 4
        eq(tl2a[3 + k, 0].numpy(), pays[0][k])

    # correction: row 1 re-run from a reset ring with frames 1-4 valid
    fix = np.asarray([[1, 1, 0b11110]], np.int64)
    jfix = np.concatenate([fix, [[0]]], axis=1).astype(np.int32)
    jil3, jl2b = j_wb._chain_fix(jil, jil2, jfix, e9[1:2], jks[1:2])
    til3, tl2b = t_wb._chain_fix(til, til2, t(fix), t(e9[1:2]), tks[1:2])
    eq(tl2b.numpy(), jl2b)
    eq(til3.buf.numpy(), jil3.buf)
    eq(til3.n.numpy(), jil3.n)
    for k in range(2):
        eq(tl2b[3 + k, 0].numpy(), pays[1][k])


def test_bt_from_demods_parity(rng):
    """Burst-type classification of speech and FACCH3 windows."""
    wlen = BU.NT3_FACCH.len_syms * SPS + W
    xs, kinds = [], []
    for k in range(6):
        burst = BU.NT3_SPEECH if k % 2 else BU.NT3_FACCH
        eb = rng.integers(0, 2, burst.ebits, dtype=np.uint8)
        xs.append(_burst_window(rng, burst, eb, 0, wlen, k))
        kinds.append(k % 2)
    x = np.stack(xs)
    jf = j_modem.demod(BU.NT3_FACCH, x, sps=SPS, win=W)
    js = j_modem.demod(BU.NT3_SPEECH, x, sps=SPS, win=W)
    tf = t_modem.demod(TBU.NT3_FACCH, t(x), SPS, W)
    ts = t_modem.demod(TBU.NT3_SPEECH, t(x), SPS, W)
    want = j_wb._bt_from_demods(jf, js, float(W >> 1))
    got = t_wb._bt_from_demods(tf, ts, float(W >> 1))
    eq(got.numpy(), want)
    assert got.numpy().tolist() == kinds
