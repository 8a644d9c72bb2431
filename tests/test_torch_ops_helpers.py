"""The last public helpers of gmr1_tpu.ops, ported: bits
(unpack_bits_np, pack_bits_np, sbit_to_ubit, ubit_to_sbit),
conv.encode_np, viterbi.decode_punctured and dsp.peaks_scan.

The same seeded numpy inputs go through both packages.  Bits, the host
encoder, the de-punctured decode's bits and metrics, and the peak
indices (with deliberate ties: lower index first, as jax.lax.top_k)
must match exactly.
"""

import numpy as np
import pytest
import torch

from gmr1_tpu.ops import bits as j_bits
from gmr1_tpu.ops import conv as j_conv
from gmr1_tpu.ops import dsp as j_dsp
from gmr1_tpu.ops import puncture as j_punct
from gmr1_tpu.ops import viterbi as j_vit
from gmr1_tpu_torch.ops import bits as t_bits
from gmr1_tpu_torch.ops import conv as t_conv
from gmr1_tpu_torch.ops import dsp as t_dsp
from gmr1_tpu_torch.ops import viterbi as t_vit

torch.set_num_threads(2)


@pytest.mark.parametrize("shape,nbits", [((5, 7), None), ((3, 4, 9), 61),
                                         ((12,), 93)])
def test_unpack_pack_np(rng, shape, nbits):
    data = rng.integers(0, 256, shape, dtype=np.uint8)
    got = t_bits.unpack_bits_np(data, nbits)
    np.testing.assert_array_equal(got, j_bits.unpack_bits_np(data, nbits))
    nb = None if nbits is None else (nbits + 7) // 8 + 1     # padded bytes
    np.testing.assert_array_equal(t_bits.pack_bits_np(got, nb),
                                  j_bits.pack_bits_np(got, nb))
    np.testing.assert_array_equal(t_bits.pack_bits_np(got),
                                  j_bits.pack_bits_np(got))


def test_sbit_ubit(rng):
    sb = rng.integers(-127, 128, (4, 37), dtype=np.int8)
    sb[0, :3] = [0, -1, 1]
    got = t_bits.sbit_to_ubit(torch.as_tensor(sb))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_bits.sbit_to_ubit(sb)))
    ub = rng.integers(0, 2, (3, 29), dtype=np.uint8)
    got = t_bits.ubit_to_sbit(torch.as_tensor(ub))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_bits.ubit_to_sbit(ub)))


@pytest.mark.parametrize("code", ["K5_12", "K5_14", "K6_14", "K9_13",
                                  "TCH3_K7"])
def test_encode_np(rng, code):
    tc, jc = getattr(t_conv, code), getattr(j_conv, code)
    for n in (12, 64):
        u = rng.integers(0, 2, n, dtype=np.uint8)
        got = t_conv.encode_np(tc, u)
        np.testing.assert_array_equal(got, j_conv.encode_np(jc, u))
        # and the batched GF(2) encoder agrees with the bit-serial one
        np.testing.assert_array_equal(
            t_conv.encode(tc, torch.as_tensor(u)).numpy(), got)


@pytest.mark.parametrize("code,in_len,punct", [
    ("K5_12", 160, ("k5_12_P23", None, None, 0)),
    ("K5_12", 480, ("k5_12_P23", "k5_12_P25", "k5_12_Ps25", 158)),
    ("K5_13", 240, ("k5_13_P25", "k5_13_P15", "k5_13_Ps15", 41))])
def test_decode_punctured(rng, code, in_len, punct):
    tc, jc = getattr(t_conv, code), getattr(j_conv, code)
    keep = j_punct.keep_indices(jc.out_len(in_len), jc.n, *punct)
    u = rng.integers(0, 2, (6, in_len), dtype=np.uint8)
    enc = np.stack([j_conv.encode_np(jc, r) for r in u])[:, keep]
    soft = np.where(enc > 0, -100.0, 100.0) + rng.normal(0, 60.0, enc.shape)
    soft = np.clip(np.round(soft), -127, 127).astype(np.float32)
    tb, tm = t_vit.decode_punctured(tc, torch.as_tensor(soft), in_len, keep)
    jb, jm = j_vit.decode_punctured(jc, soft, in_len, keep)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_peaks_scan_ties(rng):
    v = rng.normal(size=(3, 40, 2)).astype(np.float32)
    v[0, [5, 9, 20]] = [3.0, 4.0]          # three equal peaks
    v[1, :] = [1.0, 0.0]                   # every bin tied
    v[2, [0, 39]] = [0.0, -7.0]            # tie at both ends
    for k in (1, 3, 8, 40):
        got = t_dsp.peaks_scan(torch.as_tensor(v), k)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(j_dsp.peaks_scan(v, k)))
    assert t_dsp.peaks_scan(torch.as_tensor(v), 3)[0].tolist() == [5, 9, 20]
