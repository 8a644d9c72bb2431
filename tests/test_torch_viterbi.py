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


def warp_model(sym, sign, flush):
    """numpy model of kernels/viterbi.cu's warp-synchronous decoder
    (S <= 64), lane for lane: a lane holds states lam and lam + S/2 of
    burst lane // (S/2); the four predecessor metrics come from lanes
    srcA and srcB (the shuffles); each step's decisions are two 32-bit
    ballot words; tail-biting takes the first maximum by the kernel's
    butterfly; the traceback reads the words.  Returns (bits, metric)."""
    b_cnt, t_steps, n = sym.shape
    s_cnt = sign.shape[0] // 2
    lps = s_cnt // 2                       # lanes a burst
    n_w = -(-b_cnt // (32 // lps))         # warps
    lane = np.arange(32)
    g, lam = lane // lps, lane % lps
    burst = np.arange(n_w)[:, None] * (32 // lps) + g[None, :]   # (W, 32)
    x = np.concatenate([sym, np.zeros((n_w * 32 // lps - b_cnt, t_steps, n),
                                      np.float32)])[burst]  # (W, 32, T, n)
    g_a0, g_a1 = sign[lam], sign[s_cnt + lam]
    g_b0, g_b1 = sign[lam + lps], sign[s_cnt + lam + lps]
    m_a = np.where(flush & (lam != 0), np.float32(-1e30),
                   np.float32(0)) * np.ones((n_w, 1), np.float32)
    m_b = np.full((n_w, 32), -1e30 if flush else 0, np.float32)
    src_a = g * lps + (lam >> 1)
    src_b = g * lps + lps // 2 + (lam >> 1)
    words = np.zeros((n_w, t_steps, 2), np.uint64)
    for t in range(t_steps):
        v = x[:, :, t]
        c0a = m_a[:, src_a] + (v * g_a0).sum(-1, dtype=np.float32)
        c1a = m_b[:, src_a] + (v * g_a1).sum(-1, dtype=np.float32)
        c0b = m_a[:, src_b] + (v * g_b0).sum(-1, dtype=np.float32)
        c1b = m_b[:, src_b] + (v * g_b1).sum(-1, dtype=np.float32)
        d_a, d_b = c1a > c0a, c1b > c0b
        m_a, m_b = np.where(d_a, c1a, c0a), np.where(d_b, c1b, c0b)
        for w, d in ((0, d_a), (1, d_b)):          # __ballot_sync
            words[:, t, w] = (d.astype(np.uint64) << lane.astype(np.uint64)
                              ).sum(-1)
    if flush:
        best = m_a[:, g * lps]
        st = np.zeros((n_w, 32), np.int64)
    else:
        best = np.maximum(m_a, m_b)
        st = np.where(m_b > m_a, lam + lps, lam) * np.ones((n_w, 1), np.int64)
        off = lps // 2
        while off:                                  # __shfl_xor_sync
            ob, os_ = best[:, lane ^ off], st[:, lane ^ off]
            take = (ob > best) | ((ob == best) & (os_ < st))
            best, st = np.where(take, ob, best), np.where(take, os_, st)
            off //= 2
    bits = np.zeros((n_w, 32, t_steps), np.uint8)
    for t in range(t_steps - 1, -1, -1):
        bits[:, :, t] = st & 1
        word = np.where(st < lps, words[:, t, 0][:, None],
                        words[:, t, 1][:, None])
        took = (word >> (g * lps + (st & (lps - 1))).astype(np.uint64)) & 1
        st = (st >> 1) | (took.astype(np.int64) * lps)
    keep = (lam == 0)
    return (bits[:, keep].reshape(-1, t_steps)[:b_cnt],
            best[:, keep].reshape(-1)[:b_cnt])


WARP_CASES = [   # (class, B, T): B odd and not a multiple of the bursts a
    (CLASSES[0], 1, 48), (CLASSES[0], 3, 37), (CLASSES[0], 33, 70),
    (CLASSES[1], 5, 33), (CLASSES[2], 3, 45), (CLASSES[2], 2, 96),
    (("k6_14", 6, j_conv.K6_14.polys, j_conv.TERM_FLUSH), 3, 70),
    (("k5_15", 5, j_conv.K5_15.polys, j_conv.TERM_FLUSH), 3, 50),  # n = 5
]                # warp, T not a multiple of 32


@pytest.mark.parametrize("cls,b,t_steps", WARP_CASES,
                         ids=[f"{c[0]}-B{b}-T{t}" for c, b, t in WARP_CASES])
@pytest.mark.parametrize("zero", [False, True], ids=["noisy", "tied"])
def test_warp_layout_matches_plain(rng, cls, b, t_steps, zero):
    """The warp kernel's lane layout, shuffles, ballot words, first-max
    butterfly and word traceback give decode_trellis_plain's bits and
    metrics exactly, flush and tail-biting, on noisy bursts and on
    all-zero ones (every metric tied)."""
    jc, tc = codes(*cls)
    for term in (j_conv.TERM_FLUSH, j_conv.TERM_TAIL_BITING):
        jc_t = j_conv.ConvCode(jc.name, jc.k, jc.polys, term)
        in_len = t_steps - (jc.k - 1 if term == j_conv.TERM_FLUSH else 0)
        soft = noisy_sbits(rng, jc_t, b, in_len)
        if zero:
            soft[:] = 0
        _, _, sign = j_vit._acs_tables(jc_t)
        sym = soft.reshape(b, t_steps, jc.n)
        sign2 = sign.reshape(-1, jc.n).astype(np.float32)
        flush = term == j_conv.TERM_FLUSH
        want = t_vit.decode_trellis_plain(torch.from_numpy(sym),
                                          torch.from_numpy(sign2), flush)
        assert_same(warp_model(sym, sign2, flush), want)


def test_cpu_decode_does_not_launch_kernel(rng):
    jc, tc = codes(*CLASSES[0])
    before = t_vit.decode_trellis.launches
    t_vit.decode(tc, torch.from_numpy(noisy_sbits(rng, jc, 2, 10)), 10)
    assert t_vit.decode_trellis.launches == before


def _pad(s):
    """kernels/viterbi.cu `pad_idx`: the metric exchange buffer's index."""
    return s + (s >> 5) * 4


def bfly_model(sym, sign, flush):
    """numpy model of kernels/viterbi.cu's S = 128/256 decoder, lane for
    lane: lane l of a burst's warp owns butterflies i0 .. i0+R-1,
    i0 = R l, holds m[i] and m[i + S/2] and makes states 2i and 2i+1;
    the new metrics go through the padded exchange buffer; the ballot of
    register j is word j; with an antipodal table one dot product serves
    a butterfly's four branches; the first maximum comes from a lane scan
    and the xor-shuffle butterfly; the traceback reads the words through
    its four-deep prefetch ring.  Returns (bits, metric)."""
    b_cnt, t_steps, n = sym.shape
    s_cnt = sign.shape[0] // 2
    half, nw = s_cnt // 2, s_cnt // 32
    r_cnt = half // 32
    lane = np.arange(32)
    i0 = r_cnt * lane
    i = i0[:, None] + np.arange(r_cnt)                 # (L, R)
    g00, g01 = sign[2 * i], sign[2 * i + 1]             # (L, R, n)
    g10, g11 = sign[s_cnt + 2 * i], sign[s_cnt + 2 * i + 1]
    anti = bool(np.all((g01 == -g00) & (g10 == -g00) & (g11 == g00)))
    neg = np.float32(-1e30)
    m0 = np.where(flush & (i != 0), neg, np.float32(0)) * np.ones(
        (b_cnt, 1, 1), np.float32)
    m1 = np.full((b_cnt, 32, r_cnt), neg if flush else 0, np.float32)
    words = np.zeros((b_cnt, t_steps, nw), np.uint64)
    buf = np.zeros((b_cnt, _pad(s_cnt)), np.float32)
    j2 = np.arange(2 * r_cnt)
    for t in range(t_steps):
        v = sym[:, t][:, None, None, :]                 # (B, 1, 1, n)

        def dot(g):
            return (v * g[None]).sum(-1, dtype=np.float32)
        b00 = dot(g00)
        b10 = -b00 if anti else dot(g10)
        b01 = -b00 if anti else dot(g01)
        b11 = b00 if anti else dot(g11)
        c0e, c1e = m0 + b00, m1 + b10
        c0o, c1o = m0 + b01, m1 + b11
        de, do = c1e > c0e, c1o > c0o
        nm = np.stack([np.where(de, c1e, c0e), np.where(do, c1o, c0o)],
                      -1).reshape(b_cnt, 32, 2 * r_cnt)
        d = np.stack([de, do], -1).reshape(b_cnt, 32, 2 * r_cnt)
        words[:, t] = (d.astype(np.uint64)               # __ballot_sync
                       << lane.astype(np.uint64)[None, :, None]).sum(1)
        buf[:, _pad(2 * i0[:, None] + j2)] = nm
        m0, m1 = buf[:, _pad(i)], buf[:, _pad(i + half)]
    rows = np.arange(b_cnt)
    if flush:
        best = m0[:, 0, 0]
        st = np.zeros(b_cnt, np.int64)
    else:
        best = m0[:, :, 0]
        st = i0[None, :] * np.ones((b_cnt, 1), np.int64)
        for mm, base in [(m0[:, :, r], i0 + r) for r in range(1, r_cnt)] + [
                (m1[:, :, r], i0 + half + r) for r in range(r_cnt)]:
            take = mm > best
            best, st = np.where(take, mm, best), np.where(take, base, st)
        off = 16
        while off:                                      # __shfl_xor_sync
            ob, os_ = best[:, lane ^ off], st[:, lane ^ off]
            take = (ob > best) | ((ob == best) & (os_ < st))
            best, st = np.where(take, ob, best), np.where(take, os_, st)
            off //= 2
        best, st = best[:, 0], st[:, 0]

    def word(t, s):
        return words[rows, t, s & (nw - 1)] if t >= 0 else np.zeros(
            b_cnt, np.uint64)
    ring = [word(t_steps - 1 - k, st >> k) for k in range(4)]
    bits = np.zeros((b_cnt, t_steps), np.uint8)
    lnw = nw.bit_length() - 1
    for t in range(t_steps - 1, -1, -1):
        bits[:, t] = st & 1
        took = (ring[0] >> (st >> lnw).astype(np.uint64)) & np.uint64(1)
        st = (st >> 1) | (took.astype(np.int64) * half)
        ring = ring[1:] + [word(t - 4, st >> 3)]
    return bits, best


K8_13 = ("k8_13", 8, (0b10101011, 0b11001101, 0b10110111),
         j_conv.TERM_TAIL_BITING)       # synthetic, S = 128, antipodal
K9_NX = ("k9_nx", 9, (0b100101110, 0b110011011, 0b010100111),
         j_conv.TERM_TAIL_BITING)       # taps miss an end: not antipodal
BFLY_CASES = [   # (class, B, T)
    (CLASSES[3], 1, 50), (CLASSES[3], 3, 45), (CLASSES[3], 33, 40),
    (CLASSES[3], 5, 37), (CLASSES[3], 2, 64),
    (K8_13, 33, 45), (K8_13, 3, 40),
    (K9_NX, 3, 45), (K9_NX, 2, 33),
]


@pytest.mark.parametrize("cls,b,t_steps", BFLY_CASES,
                         ids=[f"{c[0]}-B{b}-T{t}" for c, b, t in BFLY_CASES])
@pytest.mark.parametrize("zero", ["noisy", "tied", "tail"])
def test_bfly_layout_matches_plain(rng, cls, b, t_steps, zero):
    """The S = 128/256 kernel's butterfly layout, exchange buffer, ballot
    words, first-max reduction and prefetched word traceback give
    decode_trellis_plain's bits and metrics exactly, flush and
    tail-biting, on noisy bursts, on all-zero ones (every metric tied)
    and on bursts whose last two steps are zero (the final metrics tie
    in groups of four, so the first maximum is rarely state 0)."""
    jc, _ = codes(*cls)
    for term in (j_conv.TERM_FLUSH, j_conv.TERM_TAIL_BITING):
        jc_t = j_conv.ConvCode(jc.name, jc.k, jc.polys, term)
        in_len = t_steps - (jc.k - 1 if term == j_conv.TERM_FLUSH else 0)
        soft = noisy_sbits(rng, jc_t, b, in_len)
        if zero == "tied":
            soft[:] = 0
        elif zero == "tail":
            soft[:, -2 * jc.n:] = 0
        _, _, sign = j_vit._acs_tables(jc_t)
        sym = soft.reshape(b, t_steps, jc.n)
        sign2 = sign.reshape(-1, jc.n).astype(np.float32)
        flush = term == j_conv.TERM_FLUSH
        want = t_vit.decode_trellis_plain(torch.from_numpy(sym),
                                          torch.from_numpy(sign2), flush)
        assert_same(bfly_model(sym, sign2, flush), want)


@pytest.mark.parametrize("term", [j_conv.TERM_FLUSH,
                                  j_conv.TERM_TAIL_BITING])
@pytest.mark.parametrize("zero", [False, True], ids=["noisy", "tied"])
def test_bfly_layout_matches_pallas_interpret(rng, term, zero):
    """At S = 256 the butterfly model gives the TPU kernel's results (run
    in interpret mode), bit for bit."""
    jc = j_conv.ConvCode("k9_13", 9, j_conv.K9_13.polys, term)
    flush = term == j_conv.TERM_FLUSH
    t_steps, b = 34, 5
    soft = noisy_sbits(rng, jc, b, t_steps - (jc.k - 1 if flush else 0))
    if zero:
        soft[:] = 0
    _, _, sign = j_vit._acs_tables(jc)
    sym = soft.reshape(b, t_steps, jc.n)
    sign2 = sign.reshape(-1, jc.n).astype(np.float32)
    want = j_trellis(sym, sign2, t_steps, jc.num_states, flush,
                     interpret=True)
    assert_same(bfly_model(sym, sign2, flush), want)
