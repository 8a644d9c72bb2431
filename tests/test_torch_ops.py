"""Parity of the port's primitives (gmr1_tpu_torch.ops) with gmr1_tpu.ops.

The same numpy inputs, made from a fixed seed, go through the JAX
function (on the CPU) and its PyTorch counterpart.  Bits and integers
must match exactly; float32 results agree to rtol 1e-5 (the two
frameworks round transcendental functions and sums in their own order).
"""

import numpy as np
import pytest
import torch

from gmr1_tpu.ops import bits as j_bits
from gmr1_tpu.ops import conv as j_conv
from gmr1_tpu.ops import cplx as j_cplx
from gmr1_tpu.ops import crc as j_crc
from gmr1_tpu.ops import dsp as j_dsp
from gmr1_tpu.ops import interleave as j_il
from gmr1_tpu.ops import scramble as j_scr
from gmr1_tpu_torch.ops import bits as t_bits
from gmr1_tpu_torch.ops import consts
from gmr1_tpu_torch.ops import conv as t_conv
from gmr1_tpu_torch.ops import cplx as t_cplx
from gmr1_tpu_torch.ops import crc as t_crc
from gmr1_tpu_torch.ops import dsp as t_dsp
from gmr1_tpu_torch.ops import interleave as t_il
from gmr1_tpu_torch.ops import scramble as t_scr
from gmr1_tpu_torch.ops import viterbi as t_vit

torch.set_num_threads(2)

RTOL = 1e-5
ATOL = 1e-6       # for values that cancel to ~0


def planar(rng, *shape):
    return rng.normal(size=(*shape, 2)).astype(np.float32)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------- cplx

BINARY = ["mul", "conj_mul", "dot", "conj_dot"]
UNARY = ["conj", "abs2", "absv", "angle", "normalize"]


@pytest.mark.parametrize("name", BINARY)
def test_cplx_binary(rng, name):
    a, b = planar(rng, 3, 17), planar(rng, 3, 17)
    close(getattr(t_cplx, name)(torch.from_numpy(a), torch.from_numpy(b)),
          getattr(j_cplx, name)(a, b))


@pytest.mark.parametrize("name", UNARY)
def test_cplx_unary(rng, name):
    a = planar(rng, 4, 9)
    close(getattr(t_cplx, name)(torch.from_numpy(a)),
          getattr(j_cplx, name)(a))


def test_cplx_expi_scale_roundtrip(rng):
    th = rng.uniform(-10, 10, size=(5, 7)).astype(np.float32)
    close(t_cplx.expi(torch.from_numpy(th)), j_cplx.expi(th))
    a = planar(rng, 5, 7)
    s = rng.normal(size=(5, 7)).astype(np.float32)
    close(t_cplx.scale(torch.from_numpy(a), s), j_cplx.scale(a, s))
    z = (a[..., 0] + 1j * a[..., 1]).astype(np.complex64)
    np.testing.assert_array_equal(t_cplx.from_complex(z).numpy(),
                                  np.asarray(j_cplx.from_complex(z)))
    np.testing.assert_array_equal(t_cplx.to_complex(torch.from_numpy(a)),
                                  j_cplx.to_complex(a))


def test_cplx_matmul(rng):
    a, b = planar(rng, 2, 6, 11), planar(rng, 11, 5)
    close(t_cplx.matmul(torch.from_numpy(a), torch.from_numpy(b)),
          j_cplx.matmul(a, b), atol=1e-5)


@pytest.mark.parametrize("n", [16, 117])
@pytest.mark.parametrize("inverse", [False, True])
def test_cplx_dft(rng, n, inverse):
    x = planar(rng, 3, n)
    close(t_cplx.dft(torch.from_numpy(x), inverse),
          j_cplx.dft(x, inverse), atol=2e-5)


# ----------------------------------------------------------------- dsp

@pytest.mark.parametrize("decim", [1, 4])
def test_sig_normalize(rng, decim):
    x = planar(rng, 3, 64)
    fs = rng.uniform(-0.3, 0.3, size=3).astype(np.float32)
    close(t_dsp.sig_normalize(torch.from_numpy(x), decim, torch.from_numpy(fs)),
          j_dsp.sig_normalize(x, decim, fs))
    close(t_dsp.sig_normalize(torch.from_numpy(x), decim, 0.1),
          j_dsp.sig_normalize(x, decim, 0.1))


@pytest.mark.parametrize("step", [1, 4])
def test_correlate(rng, step):
    ref, win = planar(rng, 7), planar(rng, 2, 3, 60)
    close(t_dsp.correlate(ref, torch.from_numpy(win), step),
          j_dsp.correlate(ref, win, step), atol=1e-5)


_MADE: list = []


def _ramp(n: int) -> np.ndarray:
    _MADE.append(n)
    return np.arange(n, dtype=np.int64)


def test_consts_table_made_once():
    """A constant table is made and uploaded once per (fn, args, device)
    and then handed out again; the tensor-ref and tensor-index paths of
    its users equal their host-array paths."""
    a = consts.table(_ramp, 5, device="cpu")
    assert consts.table(_ramp, 5, device=torch.device("cpu")) is a
    assert _MADE == [5] and torch.equal(a, torch.arange(5))
    assert consts.table(_ramp, 6, device="cpu").shape == (6,)
    assert _MADE == [5, 6]
    rng = np.random.default_rng(5)
    ref, win = planar(rng, 7), torch.from_numpy(planar(rng, 2, 3, 60))
    assert torch.equal(t_dsp.correlate(torch.from_numpy(ref), win, 4),
                       t_dsp.correlate(ref, win, 4))
    soft = torch.from_numpy(rng.normal(size=(3, 4)).astype(np.float32))
    keep = np.asarray([0, 2, 5, 6])
    assert torch.equal(t_vit.depuncture(soft, torch.from_numpy(keep), 8),
                       t_vit.depuncture(soft, keep, 8))


def test_correlate_conv(rng):
    ref, win = planar(rng, 23), planar(rng, 4, 200)
    close(t_dsp.correlate_conv(ref, torch.from_numpy(win)),
          j_dsp.correlate_conv(ref, win), atol=1e-5)


@pytest.mark.parametrize("mode,wl", [(j_dsp.PEAK_EARLY_LATE, 3),
                                     (j_dsp.PEAK_WEIGH_WIN, 5)])
def test_peak_energy_find(rng, mode, wl):
    v = planar(rng, 6, 80)
    toa_t, peak_t = t_dsp.peak_energy_find(torch.from_numpy(v), wl, mode)
    toa_j, peak_j = j_dsp.peak_energy_find(v, wl, mode)
    close(toa_t, toa_j)
    np.testing.assert_array_equal(peak_t.numpy(), np.asarray(peak_j))
    e = (v[..., 0] ** 2 + v[..., 1] ** 2).astype(np.float32)
    close(t_dsp.peak_find_energy(torch.from_numpy(e), wl, mode),
          j_dsp.peak_find_energy(e, wl, mode))


@pytest.mark.parametrize("wl", [3, 5, 8])
def test_moving_sum(rng, wl):
    e = rng.uniform(0, 1, size=(3, 50)).astype(np.float32)
    close(t_dsp._moving_sum(torch.from_numpy(e), wl),
          j_dsp._moving_sum(e, wl))


def test_fractional_delay(rng):
    x = planar(rng, 3, 40)
    frac = rng.uniform(-0.5, 0.5, size=3).astype(np.float32)
    close(t_dsp.fractional_delay(torch.from_numpy(x), torch.from_numpy(frac)),
          j_dsp.fractional_delay(x, frac), atol=1e-5)


# ------------------------------------------- bits, crc, scramble, interleave

def test_bits_pack_unpack(rng):
    data = rng.integers(0, 256, size=(4, 24), dtype=np.uint8)
    for nbits in (None, 189):
        np.testing.assert_array_equal(
            t_bits.unpack_bits(data, nbits).numpy(),
            np.asarray(j_bits.unpack_bits(data, nbits)))
    u = rng.integers(0, 2, size=(3, 76), dtype=np.uint8)
    for nbytes in (None, 12):
        np.testing.assert_array_equal(
            t_bits.pack_bits(u, nbytes).numpy(),
            np.asarray(j_bits.pack_bits(u, nbytes)))


@pytest.mark.parametrize("code", ["CRC8", "CRC12", "CRC16"])
def test_crc(rng, code):
    tc, jc = getattr(t_crc, code), getattr(j_crc, code)
    msg = rng.integers(0, 2, size=(5, 100), dtype=np.uint8)
    want = np.asarray(j_crc.crc_compute(jc, msg, 100))
    np.testing.assert_array_equal(t_crc.crc_compute(tc, msg, 100).numpy(),
                                  want)
    crc_in = want.copy()
    crc_in[1, 0] ^= 1                        # one corrupted CRC
    np.testing.assert_array_equal(
        t_crc.crc_check(tc, msg, 100, crc_in).numpy(),
        np.asarray(j_crc.crc_check(jc, msg, 100, crc_in)))


def test_scramble(rng):
    np.testing.assert_array_equal(t_scr.scramble_seq(658),
                                  j_scr.scramble_seq(658))
    u = rng.integers(0, 2, size=(3, 432), dtype=np.uint8)
    np.testing.assert_array_equal(t_scr.scramble_ubit(u).numpy(),
                                  np.asarray(j_scr.scramble_ubit(u)))
    s = rng.integers(-127, 128, size=(3, 424)).astype(np.float32)
    np.testing.assert_array_equal(
        t_scr.scramble_sbit(torch.from_numpy(s)).numpy(),
        np.asarray(j_scr.scramble_sbit(s)))


@pytest.mark.parametrize("n", [13, 53])
def test_interleave_intra(rng, n):
    fwd_t, inv_t = t_il.intra_tables(n)
    fwd_j, inv_j = j_il.intra_tables(n)
    np.testing.assert_array_equal(fwd_t, fwd_j)
    np.testing.assert_array_equal(inv_t, inv_j)
    x = rng.integers(-127, 128, size=(2, 8 * n)).astype(np.int8)
    np.testing.assert_array_equal(t_il.interleave_intra(x, n).numpy(),
                                  np.asarray(j_il.interleave_intra(x, n)))
    np.testing.assert_array_equal(t_il.deinterleave_intra(x, n).numpy(),
                                  np.asarray(j_il.deinterleave_intra(x, n)))


# ---------------------------------------------------------------- conv

@pytest.mark.parametrize("name", [c.name for c in j_conv.ALL_CODES])
def test_conv_tables_and_encode(rng, name):
    jc = next(c for c in j_conv.ALL_CODES if c.name == name)
    tc = next(c for c in t_conv.ALL_CODES if c.name == name)
    assert (tc.k, tc.polys, tc.term) == (jc.k, jc.polys, jc.term)
    for a, b in zip(tc.tables, jc.tables):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tc.output_bits, jc.output_bits)
    u = rng.integers(0, 2, size=(3, 40), dtype=np.uint8)
    np.testing.assert_array_equal(t_conv.encode(tc, u).numpy(),
                                  np.asarray(j_conv.encode(jc, u)))
    np.testing.assert_array_equal(t_conv.encode(tc, u[0]).numpy(),
                                  j_conv.encode_np(jc, u[0]))
