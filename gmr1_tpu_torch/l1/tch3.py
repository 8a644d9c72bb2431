"""TCH3 speech channel coder (reference src/l1/tch3.c; counterpart of
gmr1_tpu/l1/tch3.py).

Two 80-bit AMBE frames per burst.  Per frame: the first 48 bits go
through the K=7 tail-biting rate-1/2 code punctured P(1;2) to 72 coded
bits; the last 32 bits ride uncoded (tch3.c:82,178-179); a custom
104-bit permutation spreads them (tch3.c:84-90).  The two frames are
bit-multiplexed (mode m), scrambled, optionally ciphered, and 4 status
bits are inserted at position 52 to form the 212 burst bits.

As in the JAX package, `encode` codes the documented chain (the
reference's TX-only encoder passes its conv buffers swapped, tch3.c:81);
`decode` matches the reference's RX path bit for bit.  The two frames'
trellises are decoded in one Viterbi batch.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops import bits, consts, conv, puncture, scramble, viterbi

CODE = conv.TCH3_K7
CONV_LEN = 48
EBITS = 212


@lru_cache(maxsize=None)
def _keep_idx() -> np.ndarray:
    # 96 coded bits punctured P(1;2) -> 72 survivors
    return puncture.keep_indices(CODE.out_len(CONV_LEN), 2, "k5_12_P12")


@lru_cache(maxsize=None)
def _perm() -> tuple[np.ndarray, np.ndarray]:
    # kep = ij + 5*ii (ii<8) | ij + 4*ii + 8 (ii>=8), ii=kc%24, ij=kc/24
    kc = np.arange(104)
    ii, ij = kc % 24, kc // 24
    kep = np.where(ii < 8, ij + 5 * ii, ij + 4 * ii + 8).astype(np.int64)
    fwd = np.empty(104, dtype=np.int64)
    fwd[kep] = kc  # out[kep] = in[kc]  =>  out = in[fwd]
    return fwd, kep


@lru_cache(maxsize=None)
def _mux_idx(m: int) -> np.ndarray:
    # position of (frame i, bit j) inside the 208-bit multiplexed block
    j = np.arange(104)
    return np.stack([104 * i + j if m else (j << 1) + i for i in range(2)])


def _perm_half(i: int) -> np.ndarray:
    return _perm()[i]


def _mux_row(m: int, i: int) -> np.ndarray:
    return _mux_idx(m)[i]


def _idx(like, fn, *args):
    """The index table fn(*args) on like's device (consts.table)."""
    return consts.table(fn, *args, device=like.device)


def encode(frame0, frame1, bits_s, ciph=None, m: int = 0):
    """(frames (...,10)B, status (...,4), cipher (...,208)|None) -> (...,212)."""
    parts = []
    for frame in (frame0, frame1):
        d = bits.unpack_bits(frame, 80)
        enc = conv.encode(CODE, d[..., :CONV_LEN])
        punct = enc[..., _idx(enc, _keep_idx)]
        c = torch.cat([punct, d[..., 48:80]], dim=-1)      # 104
        parts.append(c[..., _idx(c, _perm_half, 0)])
    epp = parts[0].new_zeros((*parts[0].shape[:-1], 208))
    epp[..., _idx(epp, _mux_row, m, 0)] = parts[0]
    epp[..., _idx(epp, _mux_row, m, 1)] = parts[1]
    xmy = scramble.scramble_ubit(epp)
    if ciph is not None:
        xmy = xmy ^ bits.like(ciph, xmy)
    s = bits.like(bits_s, xmy).expand(*xmy.shape[:-1], 4)
    return torch.cat([xmy[..., :52], s, xmy[..., 52:208]], dim=-1)


def decode(ebits, ciph=None, m: int = 0):
    """Soft bits (..., 212) -> (frame0, frame1, bits_s, metrics (...,2))."""
    e = torch.as_tensor(ebits).to(torch.float32)
    bits_s = (e[..., 52:56] < 0).to(torch.uint8)
    xmy = torch.cat([e[..., :52], e[..., 56:212]], dim=-1)
    if ciph is not None:
        xmy = xmy * (1.0 - 2.0 * bits.like(ciph, xmy))
    epp = scramble.scramble_sbit(xmy)
    # (..., 2, 104): frame i's bits, permutation undone
    c = epp[..., _idx(epp, _mux_idx, m)][..., _idx(epp, _perm_half, 1)]
    full = viterbi.depuncture(c[..., :72], _idx(c, _keep_idx),
                              CODE.out_len(CONV_LEN))
    d, metric = viterbi.decode(CODE, full, CONV_LEN)    # one batch, 2 frames
    tail = (c[..., 72:104] < 0).to(torch.uint8)
    frames = bits.pack_bits(torch.cat([d, tail], dim=-1), 10)
    return frames[..., 0, :], frames[..., 1, :], bits_s, metric
