"""GMR-1 channel coders and A5/1, the benchmark's own frozen copies.

Plain PyTorch and NumPy transcriptions of the ETSI TS 101 376-5-3 chains
the traffic generator needs (BCCH, CCCH, TCH3 speech, FACCH3, FACCH9 and
TCH9 9k6 encoders, the scrambler, the intra- and inter-burst
interleavers, the GF(2) CRC and convolutional encoders, puncturing and
the A5/1 downlink keystream).  They follow the reference coders
(osmo-gmr src/l1/*.c) as the program under test does, but import nothing
of it: the benchmark's traffic and truth must not depend on the code
they judge.  Every encoder takes hard bits or bytes of shape (..., n) on
any device and returns hard bits (uint8).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

# --------------------------------------------------------------------------
# bits
# --------------------------------------------------------------------------


def unpack(data: torch.Tensor, nbits: int) -> torch.Tensor:
    """Bytes (..., B) uint8 -> bits (..., nbits), MSB first."""
    sh = torch.arange(7, -1, -1, device=data.device, dtype=torch.uint8)
    b = (data.to(torch.uint8)[..., :, None] >> sh) & 1
    return b.reshape(*data.shape[:-1], data.shape[-1] * 8)[..., :nbits]


def _gf2(x: torch.Tensor, mat: np.ndarray) -> torch.Tensor:
    """(x @ mat) mod 2 in float64 (exact for 0/1 operands)."""
    m = torch.as_tensor(mat, dtype=torch.float64, device=x.device)
    return torch.remainder(x.to(torch.float64) @ m, 2.0).to(torch.uint8)


# --------------------------------------------------------------------------
# CRC-16 (g16 = D16 + D12 + D5 + 1, init 0, no final XOR)
# --------------------------------------------------------------------------

def _crc_serial(bits: np.ndarray, nb: int = 16, poly: int = 0x1021):
    reg, top, mask = 0, 1 << (nb - 1), (1 << nb) - 1
    for b in bits:
        fb = bool(reg & top) ^ bool(b)
        reg = (reg << 1) & mask
        if fb:
            reg ^= poly
    return np.array([(reg >> (nb - 1 - i)) & 1 for i in range(nb)], np.uint8)


@lru_cache(maxsize=None)
def _crc_matrix(msg_len: int) -> np.ndarray:
    eye = np.eye(msg_len, dtype=np.uint8)
    return np.stack([_crc_serial(eye[i]) for i in range(msg_len)])


def crc16(u: torch.Tensor) -> torch.Tensor:
    return _gf2(u, _crc_matrix(u.shape[-1]))


# --------------------------------------------------------------------------
# convolutional codes: bit i of the output symbol = parity(reg & g_i)
# --------------------------------------------------------------------------

def _m(*taps: int) -> int:
    return sum(1 << t for t in taps)


# (K, generator tap masks (bit i = D^i), tail-biting)
K5_12 = (5, (_m(0, 3, 4), _m(0, 1, 2, 4)), False)
K5_14 = (5, (_m(0, 3, 4), _m(0, 1, 2, 4), _m(0, 2, 4), _m(0, 1, 2, 3, 4)),
         False)
TCH3_K7 = (7, (_m(0, 2, 3, 5, 6), _m(0, 1, 2, 3, 6)), True)


@lru_cache(maxsize=None)
def _conv_matrix(code: tuple, in_len: int) -> np.ndarray:
    """G[in_len, out]: input bit i feeds tap j of generator n at output
    step i + j (mod in_len when tail-biting; flush adds K-1 zero steps)."""
    k, polys, tb = code
    steps = in_len if tb else in_len + k - 1
    g = np.zeros((in_len, steps * len(polys)), np.uint8)
    i = np.arange(in_len)
    for j in range(k):
        t = (i + j) % in_len if tb else i + j
        for n, p in enumerate(polys):
            if (p >> j) & 1:
                g[i, t * len(polys) + n] ^= 1
    return g


def conv(code: tuple, u: torch.Tensor) -> torch.Tensor:
    return _gf2(u, _conv_matrix(code, u.shape[-1]))


# --------------------------------------------------------------------------
# puncturing (reference punct.c:49-133)
# --------------------------------------------------------------------------

_PUNCT = {   # name: (period L, mask over L*N coded bits; 0 = deleted)
    "k5_12_P12": (2, "1110"),
    "k5_12_P23": (3, "011011"),
    "k5_12_P25": (5, "1011101111"),
    "k5_12_Ps25": (5, "1111101110"),
}


@lru_cache(maxsize=None)
def keep_indices(out_len: int, n: int, main: str, pre: str | None = None,
                 post: str | None = None, repeat: int = 0) -> np.ndarray:
    """Positions of the coded bits that survive the (pre, main, post)
    puncturing, ascending."""
    lm, mm = _PUNCT[main]
    deleted, ii = [], 0
    if not repeat:
        c = out_len - sum(_PUNCT[x][0] * n for x in (pre, post) if x)
        repeat = -(-c // (lm * n))
    if pre:
        lp, mp = _PUNCT[pre]
        for ip in range(lp * n):
            if ii >= out_len:
                break
            if mp[ip] == "0":
                deleted.append(ii)
            ii += 1
    main_end = out_len - (_PUNCT[post][0] * n if post else 0)
    for _ in range(repeat):
        for ip in range(lm * n):
            if ii >= main_end:
                break
            if mm[ip] == "0":
                deleted.append(ii)
            ii += 1
    if post:
        ii = main_end
        lq, mq = _PUNCT[post]
        for ip in range(lq * n):
            if mq[ip] == "0":
                deleted.append(ii)
            ii += 1
    keep = np.ones(out_len, bool)
    keep[deleted] = False
    return np.nonzero(keep)[0]


# --------------------------------------------------------------------------
# interleaving and scrambling
# --------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _intra(n: int) -> np.ndarray:
    """out[kep] = in[kc], kep = N*((5 kc) mod 8) + kc // 8: out = in[fwd]."""
    kc = np.arange(8 * n)
    kep = n * ((5 * kc) & 7) + (kc >> 3)
    fwd = np.empty(8 * n, np.int64)
    fwd[kep] = kc
    return fwd


def interleave_intra(x: torch.Tensor, n: int) -> torch.Tensor:
    return x[..., torch.as_tensor(_intra(n), device=x.device)]


def interleave_inter(rows: torch.Tensor) -> torch.Tensor:
    """The depth-3 inter-burst interleaver over a whole train at once:
    rows (..., T, 648) of bursts 0..T-1 (a fresh interleaver) -> the T
    transmitted bursts.  Output column jk of burst t is input column jk
    of burst t - (jk mod 3); before the train the ring holds zeros
    (interleave.c:136-158)."""
    t_cnt, k = rows.shape[-2], rows.shape[-1]
    d = torch.arange(k, device=rows.device) % 3
    t = torch.arange(t_cnt, device=rows.device)[:, None] - d[None, :]
    src = rows.gather(-2, t.clamp(min=0).expand(*rows.shape[:-2], t_cnt, k))
    return torch.where(t >= 0, src, torch.zeros_like(src))


@lru_cache(maxsize=None)
def _scramble_seq(n: int) -> np.ndarray:
    """h(D) = 1 + D + D^15, seed 0x4d4b (scramb.c:48-49)."""
    reg, out = 0x4D4B, np.empty(n, np.uint8)
    for i in range(n):
        b = ((reg >> 14) ^ reg) & 1
        reg = ((reg << 1) | b) & 0xFFFF
        out[i] = b
    return out


def scramble(x: torch.Tensor) -> torch.Tensor:
    s = torch.as_tensor(_scramble_seq(x.shape[-1]), device=x.device)
    return x ^ s


# --------------------------------------------------------------------------
# channel encoders
# --------------------------------------------------------------------------

def bcch(l2: torch.Tensor) -> torch.Tensor:
    """24-byte L2 -> 424 bits: CRC16, K5 r1/2 flush, intra N=53, scramble."""
    u = unpack(l2, 192)
    enc = conv(K5_12, torch.cat([u, crc16(u)], -1))
    return scramble(interleave_intra(enc, 53))


def ccch(l2: torch.Tensor) -> torch.Tensor:
    """24-byte L2 -> 432 bits: the BCCH chain inside 4 + 4 zero pad bits."""
    u = unpack(l2, 192)
    core = interleave_intra(conv(K5_12, torch.cat([u, crc16(u)], -1)), 53)
    pad = core.new_zeros((*core.shape[:-1], 4))
    return scramble(torch.cat([pad, core, pad], -1))


@lru_cache(maxsize=None)
def _tch3_tables():
    keep = keep_indices(96, 2, "k5_12_P12")            # 72 of 96
    kc = np.arange(104)
    ii, ij = kc % 24, kc // 24
    kep = np.where(ii < 8, ij + 5 * ii, ij + 4 * ii + 8)
    fwd = np.empty(104, np.int64)
    fwd[kep] = kc
    j = np.arange(104)
    mux = np.stack([(j << 1) + i for i in range(2)])    # mode m = 0
    return keep, fwd, mux


def tch3(f0: torch.Tensor, f1: torch.Tensor) -> torch.Tensor:
    """Two 10-byte AMBE frames -> 212 bits (status bits 0, no cipher)."""
    keep, fwd, mux = (torch.as_tensor(t, device=f0.device)
                      for t in _tch3_tables())
    epp = f0.new_zeros((*f0.shape[:-1], 208), dtype=torch.uint8)
    for i, frame in enumerate((f0, f1)):
        d = unpack(frame, 80)
        c = torch.cat([conv(TCH3_K7, d[..., :48])[..., keep], d[..., 48:]],
                      -1)
        epp[..., mux[i]] = c[..., fwd]
    x = scramble(epp)
    s = x.new_zeros((*x.shape[:-1], 4))
    return torch.cat([x[..., :52], s, x[..., 52:]], -1)


@lru_cache(maxsize=None)
def _facch3_split() -> np.ndarray:
    i = np.arange(384)
    inv = np.empty(384, np.int64)
    inv[(i & 3) * 96 + (i >> 2)] = i
    return inv


def facch3(l2: torch.Tensor) -> torch.Tensor:
    """10-byte L2 -> (..., 4, 104): 76 bits + CRC16, K5 r1/4 flush, split
    over 4 bursts, intra N=12, scramble, 8 zero status bits at 22."""
    u = unpack(l2, 76)
    enc = conv(K5_14, torch.cat([u, crc16(u)], -1))
    cp = enc[..., torch.as_tensor(_facch3_split(), device=l2.device)]
    x = scramble(interleave_intra(cp.reshape(*cp.shape[:-1], 4, 96), 12))
    s = x.new_zeros((*x.shape[:-1], 8))
    return torch.cat([x[..., :22], s, x[..., 22:]], -1)


def _nt9_mux(x648: torch.Tensor, ks: torch.Tensor) -> torch.Tensor:
    """648 scrambled bits -> 662: SACCH (10 zeros) at 52, cipher, status
    (4 zeros) at 52."""
    z10 = x648.new_zeros((*x648.shape[:-1], 10))
    my = torch.cat([x648[..., :52], z10, x648[..., 52:]], -1) ^ ks
    z4 = x648.new_zeros((*x648.shape[:-1], 4))
    return torch.cat([my[..., :52], z4, my[..., 52:]], -1)


def facch9(l2: torch.Tensor, ks: torch.Tensor) -> torch.Tensor:
    """38-byte L2 (300 bits) + its 658-bit keystream -> 662 bits."""
    u = unpack(l2, 300)
    enc = conv(K5_12, torch.cat([u, crc16(u)], -1))
    z = enc.new_zeros((*enc.shape[:-1], 4))
    x = scramble(torch.cat([z, interleave_intra(enc, 80), z], -1))
    return _nt9_mux(x, ks)


@lru_cache(maxsize=None)
def _tch9_keep() -> np.ndarray:
    keep = keep_indices(968, 2, "k5_12_P23", "k5_12_P25", "k5_12_Ps25", 158)
    if len(keep) != 648:
        raise AssertionError(len(keep))
    return keep


def tch9_train(pay: torch.Tensor, ks: torch.Tensor) -> torch.Tensor:
    """A 9k6 CSD train from a fresh interleaver: payloads (..., T, 60)
    and keystreams (..., T, 658) -> bursts (..., T, 662)."""
    u = unpack(pay, 480)
    c = conv(K5_12, u)[..., torch.as_tensor(_tch9_keep(), device=pay.device)]
    ep = interleave_inter(interleave_intra(c, 81))
    return _nt9_mux(scramble(ep), ks)


# --------------------------------------------------------------------------
# A5/1 downlink keystream (a5.c), vectorized over frame numbers
# --------------------------------------------------------------------------

_MASKS = np.array([(1 << n) - 1 for n in (19, 22, 23, 17)], np.int64)
_TAPS = np.array([0x072000, 0x311000, 0x660000, 0x013100], np.int64)
_OUT_MAJ = ((1, 6, 15), (3, 8, 14), (4, 15, 19))
_OUT_XOR = (11, 1, 0)
_KEY_SWAP = [1, 0, 3, 2, 5, 4, 7, 6]


def _parity(x: np.ndarray) -> np.ndarray:
    for s in (16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return x & 1


def a5_dl(key: bytes, fns: np.ndarray, nbits: int) -> np.ndarray:
    """A5/1 downlink keystream (len(fns), nbits) uint8 for one key."""
    fns = np.asarray(fns, np.int64)
    k = np.frombuffer(bytes(key), np.uint8)[_KEY_SWAP].astype(np.int64)
    lk = np.broadcast_to(k, (len(fns), 8)).copy()
    lk[:, 6] ^= (fns & 0x0000F) << 4
    lk[:, 3] ^= (fns & 0x00030) << 2
    lk[:, 1] ^= (fns & 0x007C0) >> 3
    lk[:, 0] ^= ((fns & 0x0F800) >> 11) ^ ((fns & 0x70000) >> 11)
    r = np.zeros((len(fns), 4), np.int64)

    def forced(r):
        return ((r << 1) & _MASKS) | _parity(r & _TAPS)

    def clock(r):
        cb = [(r[:, 3] >> b) & 1 for b in (15, 6, 1)]
        maj = (cb[0] + cb[1] + cb[2] >= 2).astype(np.int64)
        gate = np.stack([cb[0] == maj, cb[1] == maj, cb[2] == maj,
                         np.ones(len(r), bool)], -1)
        return np.where(gate, forced(r), r)

    for i in range(64):
        r = forced(r) ^ ((lk[:, i >> 3] >> (7 - (i & 7))) & 1)[:, None]
    r |= 1
    for _ in range(250):
        r = clock(r)
    out = np.empty((len(fns), nbits), np.uint8)
    for i in range(nbits):
        r = clock(r)
        v = np.zeros(len(fns), np.int64)
        for j in range(3):
            a, b, c = _OUT_MAJ[j]
            s = ((r[:, j] >> a) & 1) + ((r[:, j] >> b) & 1) \
                + ((r[:, j] >> c) & 1)
            v ^= (s >= 2).astype(np.int64) ^ ((r[:, j] >> _OUT_XOR[j]) & 1)
        out[:, i] = v
    return out
