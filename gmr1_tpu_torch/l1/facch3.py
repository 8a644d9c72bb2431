"""FACCH3 channel coder (reference src/l1/facch3.c; counterpart of
gmr1_tpu/l1/facch3.py).

10-byte L2 over FOUR bursts: 76 bits + CRC16 -> K=5 r=1/4 conv
(len 92, flush) -> 384 coded bits split column-wise over 4 bursts of 96
(facch3.c:81-82) -> per burst: intra-interleave N=12, scramble, cipher,
8 status bits muxed in at position 22 -> 4 x 104 burst bits.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops import bits, consts, conv, crc, interleave, scramble, viterbi

CODE = conv.K5_14
MSG_BITS = 76
CONV_LEN = 92
EBITS = 4 * 104


@lru_cache(maxsize=None)
def _split_idx() -> np.ndarray:
    # bits_cp[(i&3)*96 + (i>>2)] = bits_c[i]: burst b gets coded bits
    # with index i % 4 == b, in order.
    i = np.arange(384)
    dst = (i & 3) * 96 + (i >> 2)
    inv = np.empty(384, dtype=np.int64)
    inv[dst] = i
    return inv  # bits_cp = bits_c[inv]


def _merge_idx() -> np.ndarray:
    return _split_idx().argsort()


def encode(l2, bits_s, ciph=None):
    """(l2 (...,10)B, status (...,32), ciph (...,384)|None) -> (..., 416)."""
    u = bits.unpack_bits(l2, MSG_BITS)
    c16 = crc.crc_compute(crc.CRC16, u, MSG_BITS)
    enc = conv.encode(CODE, torch.cat([u, c16], dim=-1))     # (..., 384)
    cp = enc[..., consts.table(_split_idx, device=enc.device)]
    cp = cp.reshape(*cp.shape[:-1], 4, 96)
    xmy = scramble.scramble_ubit(interleave.interleave_intra(cp, 12))
    if ciph is not None:
        xmy = xmy ^ bits.like(ciph, xmy).reshape(*xmy.shape[:-2], 4, 96)
    s = bits.like(bits_s, xmy).reshape(*xmy.shape[:-2], 4, 8)
    out = torch.cat([xmy[..., :22], s, xmy[..., 22:96]], dim=-1)
    return out.reshape(*out.shape[:-2], EBITS)


def decode(ebits, ciph=None):
    """Soft bits (..., 416) -> (l2, bits_s (...,32), crc_fail, metric)."""
    e = torch.as_tensor(ebits).to(torch.float32)
    e = e.reshape(*e.shape[:-1], 4, 104)
    bits_s = (e[..., 22:30] < 0).to(torch.uint8)
    bits_s = bits_s.reshape(*bits_s.shape[:-2], 32)
    xmy = torch.cat([e[..., :22], e[..., 30:104]], dim=-1)
    if ciph is not None:
        cb = bits.like(ciph, xmy).reshape(*xmy.shape[:-2], 4, 96)
        xmy = xmy * (1.0 - 2.0 * cb)
    cp = interleave.deinterleave_intra(scramble.scramble_sbit(xmy), 12)
    cp = cp.reshape(*cp.shape[:-2], 384)
    c = cp[..., consts.table(_merge_idx, device=cp.device)]
    u, metric = viterbi.decode(CODE, c, CONV_LEN)
    bad = crc.crc_check(crc.CRC16, u[..., :MSG_BITS], MSG_BITS,
                        u[..., MSG_BITS:CONV_LEN])
    return bits.pack_bits(u[..., :MSG_BITS], 10), bits_s, bad, metric
