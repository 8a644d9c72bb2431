"""Parity of the port's last L1 coders (xch_dc12, rach) with gmr1_tpu,
and numpy models of kernel A5's arithmetic and output staging.

  * xch_dc12 / rach: encode bit-equal to JAX on random L2; decode on
    noisy soft bits (rach also with a wrong SB mask, so the CRC8 retry
    runs) gives equal bytes, CRC flags and Viterbi metrics;
  * kernel A5 (gmr1_tpu_torch/kernels/a5.cu) cannot run here, so its
    design is replayed in numpy against `keystream_np`, as
    tests/test_torch_viterbi.py::warp_model does for kernel V: the
    closed-form key schedule (base state XOR per-fn-bit deltas), R4 as a
    bit stream grown 32 steps a word, each of R1-R3 as an 8-step window
    of its bit stream with the filter bits of every clock count in one
    word, the XOR of the lanes' words, and the (row, word) tile expanded
    to a CTA's contiguous byte region in 16-byte vectors.
"""

import numpy as np
import pytest
import torch

from gmr1_tpu.l1 import rach as j_rach
from gmr1_tpu.l1 import xch_dc12 as j_dc12
from gmr1_tpu_torch.l1 import rach as t_rach
from gmr1_tpu_torch.l1 import xch_dc12 as t_dc12
from gmr1_tpu_torch.ops import a5 as t_a5

torch.set_num_threads(2)


def t(x):
    return torch.from_numpy(np.array(x))


def eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _soft(bits_u8, rng, sigma=40.0):
    s = np.where(np.asarray(bits_u8) > 0, -100.0, 100.0)
    s = s + rng.normal(0, sigma, s.shape)
    return np.clip(np.round(s), -127, 127).astype(np.int8)


# --- xch_dc12 ---------------------------------------------------------------

def test_xch_dc12_encode_exact(rng):
    l2 = rng.integers(0, 256, (5, 24), dtype=np.uint8)
    got = t_dc12.encode(t(l2)).numpy()
    assert got.shape == (5, t_dc12.EBITS)
    eq(got, j_dc12.encode(l2))
    eq(t_dc12._keep_idx(), j_dc12._keep_idx())


@pytest.mark.parametrize("sigma", [40.0, 90.0])
def test_xch_dc12_decode_exact(rng, sigma):
    """Noisy bursts (most decode, at sigma 90 some fail the CRC) and pure
    noise: equal bytes, CRC flags and metrics (the K=9 tail-biting
    trellis, 256 states)."""
    l2 = rng.integers(0, 256, (6, 24), dtype=np.uint8)
    e = _soft(j_dc12.encode(l2), rng, sigma)
    e = np.concatenate([e, rng.integers(-127, 128, (2, 432)).astype(np.int8)])
    got = t_dc12.decode(t(e))
    want = j_dc12.decode(e)
    for a, b in zip(got, want):
        eq(a.numpy(), b)
    if sigma == 40.0:
        eq(got[0].numpy()[:6], l2)
        assert not got[1].numpy()[:6].any()


# --- rach -------------------------------------------------------------------

def test_rach_encode_exact(rng):
    pk = rng.integers(0, 256, (5, 18), dtype=np.uint8)
    sb = rng.integers(0, 256, 5).astype(np.uint8)
    got = t_rach.encode(t(pk), t(sb)).numpy()
    assert got.shape == (5, t_rach.EBITS)
    eq(got, j_rach.encode(pk, sb))
    eq(t_rach._keep_idx(), j_rach._keep_idx())


def test_rach_decode_exact(rng):
    """Right SB mask, a wrong one (the CRC8 retry without the mask runs
    and fails) and mask 0, on noisy bursts and noise: equal packets, CRC
    flags and metrics; the soft combine of the two class-1 copies is the
    JAX package's (a + b) / 2."""
    pk = rng.integers(0, 256, (6, 18), dtype=np.uint8)
    pk[:, 17] &= 0xE0                                   # 139 message bits
    sb = rng.integers(1, 256, 6).astype(np.uint8)
    e = _soft(j_rach.encode(pk, sb), rng)
    e = np.concatenate([e, rng.integers(-127, 128, (2, 494)).astype(np.int8)])
    masks = np.concatenate([sb, [3, 5]]).astype(np.uint8)
    for m in (masks, masks ^ 0x5A, np.zeros_like(masks)):
        got = t_rach.decode(t(e), t(m))
        want = j_rach.decode(e, m)
        for a, b in zip(got, want):
            eq(a.numpy(), b)
    got = t_rach.decode(t(e), t(masks))
    eq(got[0].numpy()[:6], pk)
    assert not got[1].numpy()[:6].any()
    assert got[1].numpy()[:6, 0].sum() == 0
    wrong = t_rach.decode(t(e), t(masks ^ 0x5A))[1].numpy()
    assert wrong[:6, 0].all() and not wrong[:6, 1].any()


def test_l1_exports_every_coder():
    import gmr1_tpu.l1 as jl1
    import gmr1_tpu_torch.l1 as tl1
    names = ("bcch", "ccch", "facch3", "facch9", "rach", "tch3", "tch9",
             "xch_dc12")
    for n in names:
        assert hasattr(jl1, n) and hasattr(tl1, n), n


# --- kernel A5: the closed-form key schedule --------------------------------

LENS = (19, 22, 23, 17)
TAPS = (0x072000, 0x311000, 0x660000, 0x013100)
TAP_POS = ((13, 16, 17, 18), (12, 16, 20, 21), (17, 18, 21, 22))
FILTER = ((1, 6, 15, 11), (3, 8, 14, 1), (4, 15, 19, 0))
CTL = (1, 10, 15)       # R4 window bit of R1/R2/R3's clock control


def _parity(x):
    return bin(int(x)).count("1") & 1


def load_key(lkey):
    """The 4 registers after the 64 forced clocks of the mixed key bytes
    (the host's load_key in a5.cu)."""
    r = [0, 0, 0, 0]
    for i in range(64):
        b = (int(lkey[i >> 3]) >> (7 - (i & 7))) & 1
        for k in range(4):
            r[k] = (((r[k] << 1) & ((1 << LENS[k]) - 1))
                    | _parity(r[k] & TAPS[k])) ^ b
    return np.asarray(r, np.uint32)


def schedule(key):
    """(base (4,), delta (19, 4)): the start state of fn is base XOR the
    deltas of its set bits (a5.cu make_schedule)."""
    base = load_key(np.asarray(key, np.uint8)[t_a5._KEY_SWAP])
    delta = np.stack([load_key(t_a5._mix_key(np.zeros(8, np.uint8), 1 << j))
                      for j in range(19)])
    return base, delta


def start_state(key, fns):
    """(B, 4) registers after the key schedule, LSBs set."""
    base, delta = schedule(key)
    bits = (np.asarray(fns, np.int64)[:, None] >> np.arange(19)) & 1
    r = np.bitwise_xor.reduce(np.where(bits[..., None] == 1, delta, 0),
                              axis=1) ^ base
    return (r | 1).astype(np.uint32)


def _np_start(key, fn):
    """keystream_np's schedule, stopped after the LSBs are set."""
    lkey = t_a5._mix_key(key, fn)
    return load_key(lkey) | 1


def test_a5_closed_form_schedule(rng):
    key = rng.integers(0, 256, 8, dtype=np.uint8)
    fns = np.concatenate([1 << np.arange(19), rng.integers(0, 1 << 19, 200),
                          [0, (1 << 19) - 1]])
    got = start_state(key, fns)
    for i, fn in enumerate(fns):
        eq(got[i], _np_start(key, int(fn)))


# --- kernel A5: the generator, four lanes a frame number --------------------

def _brev(x, n):
    return int(f"{int(x):0{n}b}"[::-1], 2)


def r4_masks(x, n):
    """(x', k0, k1, k2): R4's window x (bit k = s_{t-16+k}) grown 32 steps
    by four word steps, the clock masks of R1-R3 for those steps, and the
    window moved on by n steps."""
    v = int(x)
    for valid in range(17, 53, 9):
        y = v ^ (v >> 3) ^ (v >> 4) ^ (v >> 8)
        v |= (y << 17) & (0x1FF << valid)
    c = [(v >> s) & 0xFFFFFFFF for s in CTL]
    m = (c[0] & c[1]) | (c[0] & c[2]) | (c[1] & c[2])
    return (v >> n) & 0x1FFFF, [~(ci ^ m) & 0xFFFFFFFF for ci in c]


class LaneModel:
    """One lane: register q as its 8-step stream window (a5.cu Lane)."""

    def __init__(self, q, r):
        self.len = LENS[q]
        self.low = (1 << self.len) - 1
        self.future = 0xFF << self.len
        self.shifts = [1 + p for p in TAP_POS[q]]
        self.fsh = [self.len - 1 - tp for tp in FILTER[q]]
        self.e = _brev(r, self.len)
        self.advance(0)

    def advance(self, c):
        w = (self.e >> c) & self.low
        y = 0
        for s in self.shifts:
            y ^= w << s
        self.e = (w | (y & self.future)) & 0xFFFFFFFF

    def window(self, g, emit):
        """8 steps with gate bits g: filter bits (bit i after clock i)."""
        out = 0
        if emit:
            a, b, c, d = (self.e >> s for s in self.fsh)
            o = ((a & b) | ((a | b) & c)) ^ d
            for i in range(8):
                if g & (1 << i):
                    o >>= 1
                out |= (o & 1) << i
        self.advance(bin(g).count("1"))
        return out


def kernel_rows(key, fn, nbits, with_ul=True):
    """One frame number through the kernel's lane model: (dl, ul) words,
    each lane's 32-bit words XORed as the shuffles do."""
    r = start_state(key, [fn])[0]
    lanes = [LaneModel(q, r[q]) for q in range(3)]
    x = _brev(r[3], 17)

    def run(n, emit):
        nonlocal x
        x_new, ks = r4_masks(x, n)
        x = x_new
        words = []
        for q, lane in enumerate(lanes):
            k = ks[q] & ((1 << n) - 1)
            words.append(sum(lane.window((k >> (8 * w)) & 0xFF, emit)
                             << (8 * w) for w in range(4)))
        return words[0] ^ words[1] ^ words[2]

    for s in range(0, 250 - 32, 32):
        run(32, False)
    run(250 % 32, False)
    out = []
    for _half in range(2 if with_ul else 1):
        out.append([run(min(32, nbits - 32 * w), True)
                    for w in range((nbits + 31) // 32)])
    return out


def words_to_bits(words, nbits):
    w = np.asarray(words, np.uint64)
    bits = (w[:, None] >> np.arange(32, dtype=np.uint64)) & 1
    return bits.reshape(-1)[:nbits].astype(np.uint8)


@pytest.mark.parametrize("nbits", [1, 7, 96, 208, 658])
def test_a5_lane_model_matches_reference(rng, nbits):
    key = rng.integers(0, 256, 8, dtype=np.uint8)
    for fn in (0, 0x70000, 0x7FFFF, int(rng.integers(0, 1 << 19))):
        dl_w, ul_w = kernel_rows(key, fn, nbits)
        rd, ru = t_a5.keystream_np(key, fn, nbits)
        eq(words_to_bits(dl_w, nbits), rd)
        eq(words_to_bits(ul_w, nbits), ru)


def test_a5_window_needs_no_more_future_bits():
    """Every feedback tap is >= 12 and every filter term reads at most 8
    counts ahead: one word step fills the 8 future bits of a window, and
    L + 8 bits fit the 32-bit window of the longest register."""
    for q in range(3):
        assert min(TAP_POS[q]) + 1 >= 8
        assert LENS[q] + 8 <= 32
        assert all(TAPS[q] >> p & 1 for p in TAP_POS[q])
        assert bin(TAPS[q]).count("1") == 4


# --- kernel A5: the output staging ------------------------------------------

ROWS = 32      # frame numbers a CTA


def stage(bits):
    """Replay the kernel's output path for (B, nbits) bits: words packed
    32 bits each, a (row, word) tile of odd stride a CTA, each CTA's
    region expanded to bytes 16 at a time (the in-row fast path by funnel
    shift and nibble multiplies, the rest byte by byte)."""
    b_cnt, nbits = bits.shape
    nwords = (nbits + 31) // 32
    stride = nwords | 1
    padded = np.zeros((b_cnt, nwords * 32), np.uint64)
    padded[:, :nbits] = bits
    words = (padded.reshape(b_cnt, nwords, 32)
             << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint64)
    out = np.full(b_cnt * nbits, 0xEE, np.uint8)
    for row0 in range(0, b_cnt, ROWS):
        rows = min(ROWS, b_cnt - row0)
        tile = np.zeros(ROWS * stride + 1, np.uint64)
        for f in range(rows):
            tile[f * stride:f * stride + nwords] = words[row0 + f]
        total = rows * nbits
        region = np.full(total, 0xEE, np.uint8)
        p = np.arange(0, total, 16)
        row, bit = p // nbits, p % nbits
        fast = bit + 16 <= nbits
        wi = row * stride + (bit >> 5)
        pair = tile[wi] | (tile[wi + 1] << np.uint64(32))
        b16 = (pair >> (bit & 31).astype(np.uint64)) & np.uint64(0xFFFF)
        for j in range(4):
            nib = (b16 >> np.uint64(4 * j)) & np.uint64(0xF)
            q = (nib * np.uint64(0x00204081)) & np.uint64(0x01010101)
            for k in range(4):
                sel = p[fast] + 4 * j + k
                region[sel] = ((q[fast] >> np.uint64(8 * k)) & np.uint64(1))
        for p0 in p[~fast]:
            r, k = divmod(int(p0), nbits)
            for j in range(min(16, total - int(p0))):
                region[p0 + j] = (int(tile[r * stride + (k >> 5)])
                                  >> (k & 31)) & 1
                k += 1
                if k == nbits:
                    k, r = 0, r + 1
        out[row0 * nbits:row0 * nbits + total] = region
    return out.reshape(b_cnt, nbits)


@pytest.mark.parametrize("nbits", [96, 208, 658])
@pytest.mark.parametrize("b_cnt", [1, 33, 8513])
def test_a5_output_staging(rng, nbits, b_cnt):
    bits = rng.integers(0, 2, (b_cnt, nbits), dtype=np.uint8)
    eq(stage(bits), bits)
    assert (32 * nbits) % 16 == 0        # every CTA region starts aligned
