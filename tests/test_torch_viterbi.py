"""Parity of the port's Viterbi decoder with gmr1_tpu.

On the CPU the port runs `decode_trellis_plain`, the plain PyTorch form
of the hand-written CUDA kernel.  It must be bit-exact (bits and metric,
atol 0) with both JAX decoders: the XLA scan of `viterbi.decode` and
the Pallas trellis kernel run in interpret mode, over the trellis
classes the GMR-1 chains use (K=5 flush at n=2 and n=4, K=7 and K=9
tail-biting).  The kernel itself is compared with the plain form on the
card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from gmr1_tpu.ops import conv as j_conv
from gmr1_tpu.ops import viterbi as j_vit
from gmr1_tpu.ops.pallas_viterbi import decode_trellis as j_trellis
from gmr1_tpu_torch.ops import conv as t_conv
from gmr1_tpu_torch.ops import viterbi as t_vit

torch.set_num_threads(2)

CLASSES = [
    ("k5_12", 5, j_conv.K5_12.polys, j_conv.TERM_FLUSH),
    ("k5_14", 5, j_conv.K5_14.polys, j_conv.TERM_FLUSH),
    ("tch3_k7", 7, j_conv.TCH3_K7.polys, j_conv.TERM_TAIL_BITING),
    ("k9_13_tb", 9, j_conv.K9_13.polys, j_conv.TERM_TAIL_BITING),
]
IDS = [c[0] for c in CLASSES]


def codes(name, k, polys, term):
    return (j_conv.ConvCode(name, k, polys, term),
            t_conv.ConvCode(name, k, polys, term))


def noisy_sbits(rng, jc, b, in_len, sigma=40.0):
    """Integer sbits of a random codeword plus integer-valued noise."""
    bits = rng.integers(0, 2, (b, in_len), dtype=np.uint8)
    enc = np.asarray(j_conv.encode(jc, bits))
    soft = np.where(enc > 0, -127.0, 127.0) + rng.normal(0, sigma, enc.shape)
    return np.clip(np.round(soft), -127, 127).astype(np.float32)


def assert_same(got, want):
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               rtol=0, atol=0)


@pytest.mark.parametrize("cls", CLASSES, ids=IDS)
def test_decode_matches_xla_scan(rng, cls):
    jc, tc = codes(*cls)
    in_len = 40
    soft = noisy_sbits(rng, jc, 96, in_len)
    assert_same(t_vit.decode(tc, torch.from_numpy(soft), in_len),
                j_vit.decode(jc, soft, in_len))


@pytest.mark.parametrize("cls", CLASSES, ids=IDS)
def test_plain_trellis_matches_pallas_interpret(rng, cls):
    jc, tc = codes(*cls)
    in_len, b = 26, 64
    soft = noisy_sbits(rng, jc, b, in_len)
    _, _, sign = j_vit._acs_tables(jc)
    t_total = soft.shape[-1] // jc.n
    flush = jc.term == j_conv.TERM_FLUSH
    sym = soft.reshape(b, t_total, jc.n)
    sign2 = sign.reshape(-1, jc.n)
    want = j_trellis(sym, sign2, t_total, jc.num_states, flush,
                     interpret=True)
    got = t_vit.decode_trellis_plain(torch.from_numpy(sym),
                                     torch.from_numpy(sign2), flush)
    assert_same(got, want)


@pytest.mark.parametrize("cls", CLASSES, ids=IDS)
def test_acs_tables(cls):
    jc, tc = codes(*cls)
    for a, b in zip(t_vit._acs_tables(tc), j_vit._acs_tables(jc)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("term", [j_conv.TERM_FLUSH,
                                  j_conv.TERM_TAIL_BITING])
@pytest.mark.parametrize("in_len", [2, 6])
def test_sentinel_and_ties(rng, term, in_len):
    """Short bursts and all-zero (fully tied) soft input: in flush mode
    the -1e30 sentinel keeps unreachable states tied (they decide 0) for
    the first K-1 steps, and in tail-biting mode every state ties; both
    decoders must break every tie the same way."""
    jc, tc = codes("k5_12_s", 5, j_conv.K5_12.polys, term)
    n_out = jc.out_len(in_len)
    zero = np.zeros((3, n_out), np.float32)
    soft = np.concatenate([zero, noisy_sbits(rng, jc, 5, in_len, 90.0)])
    assert_same(t_vit.decode(tc, torch.from_numpy(soft), in_len),
                j_vit.decode(jc, soft, in_len))


def test_depuncture_decode_distance(rng):
    jc, tc = codes("k5_12", 5, j_conv.K5_12.polys, j_conv.TERM_FLUSH)
    in_len = 32
    full = noisy_sbits(rng, jc, 4, in_len, 20.0)
    keep = np.sort(rng.choice(full.shape[-1], full.shape[-1] - 9,
                              replace=False))
    punct = full[:, keep]
    np.testing.assert_array_equal(
        t_vit.depuncture(torch.from_numpy(punct), keep,
                         full.shape[-1]).numpy(),
        np.asarray(j_vit.depuncture(punct, keep, full.shape[-1])))
    got = t_vit.decode(tc, t_vit.depuncture(torch.from_numpy(punct), keep,
                                            full.shape[-1]), in_len)
    want = j_vit.decode_punctured(jc, punct, in_len, keep)
    assert_same(got, want)
    np.testing.assert_array_equal(
        t_vit.distance(tc, torch.from_numpy(punct), got[0], keep).numpy(),
        np.asarray(j_vit.distance(jc, punct, np.asarray(want[0]), keep)))


def test_cpu_decode_does_not_launch_kernel(rng):
    jc, tc = codes(*CLASSES[0])
    before = t_vit.decode_trellis.launches
    t_vit.decode(tc, torch.from_numpy(noisy_sbits(rng, jc, 2, 10)), 10)
    assert t_vit.decode_trellis.launches == before
