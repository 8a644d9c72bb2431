"""FACCH9 channel coder (reference src/l1/facch9.c; counterpart of
gmr1_tpu/l1/facch9.py).

38-byte L2 in one NT9 burst: 300 bits + CRC16 -> K=5 r=1/2 conv
(len 316, flush) -> 640 coded bits interleaved N=80 inside a 648-bit
field with 4+4 zero pad (facch9.c:76-78) -> scramble -> SACCH(10) mux at
52 -> cipher -> status(4) mux at 52 -> 662 burst bits.
"""

from __future__ import annotations

import torch

from ..ops import bits, conv, crc, interleave, scramble, viterbi

CODE = conv.K5_12
MSG_BITS = 300
CONV_LEN = 316
EBITS = 662
IL_N = 80


def encode(l2, bits_sacch, bits_status, ciph=None):
    """(l2 (...,38)B, sacch (...,10), status (...,4)) -> (..., 662)."""
    u = bits.unpack_bits(l2, MSG_BITS)
    c16 = crc.crc_compute(crc.CRC16, u, MSG_BITS)
    enc = conv.encode(CODE, torch.cat([u, c16], dim=-1))     # 640
    zeros = enc.new_zeros((*enc.shape[:-1], 4))
    epp = torch.cat([zeros, interleave.interleave_intra(enc, IL_N), zeros],
                    dim=-1)
    x = scramble.scramble_ubit(epp)
    my = torch.cat([x[..., :52], bits.like(bits_sacch, x), x[..., 52:648]],
                   dim=-1)
    if ciph is not None:
        my = my ^ bits.like(ciph, my)
    return torch.cat([my[..., :52], bits.like(bits_status, my),
                      my[..., 52:658]], dim=-1)


def decode(ebits, ciph=None):
    """Soft (..., 662) -> (l2, sacch (...,10), status (...,4), crc, metric)."""
    e = torch.as_tensor(ebits).to(torch.float32)
    bits_status = (e[..., 52:56] < 0).to(torch.uint8)
    my = torch.cat([e[..., :52], e[..., 56:662]], dim=-1)
    if ciph is not None:
        my = my * (1.0 - 2.0 * bits.like(ciph, my))
    bits_sacch = my[..., 52:62]
    x = torch.cat([my[..., :52], my[..., 62:658]], dim=-1)
    epp = scramble.scramble_sbit(x)
    c = interleave.deinterleave_intra(epp[..., 4:644], IL_N)
    u, metric = viterbi.decode(CODE, c, CONV_LEN)
    bad = crc.crc_check(crc.CRC16, u[..., :MSG_BITS], MSG_BITS,
                        u[..., MSG_BITS:CONV_LEN])
    l2 = bits.pack_bits(u[..., :MSG_BITS], 38)
    return l2, bits_sacch, bits_status, bad, metric
