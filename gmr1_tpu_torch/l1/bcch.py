"""BCCH channel coder (reference src/l1/bcch.c; counterpart of
gmr1_tpu/l1/bcch.py).

24-byte L2 <-> 424 burst bits:
  192 data bits + CRC16 -> K=5 r=1/2 conv (len 208, flush) ->
  intra-interleave N=53 -> scramble.
"""

from __future__ import annotations

import torch

from ..ops import bits, conv, crc, interleave, scramble, viterbi

CODE = conv.K5_12
MSG_BITS = 192
CONV_LEN = 208
EBITS = 424
IL_N = 53


def encode(l2):
    """L2 bytes (..., 24) -> hard burst bits (..., 424)."""
    u = bits.unpack_bits(l2, MSG_BITS)
    c = crc.crc_compute(crc.CRC16, u, MSG_BITS)
    enc = conv.encode(CODE, torch.cat([u, c], dim=-1))
    return scramble.scramble_ubit(interleave.interleave_intra(enc, IL_N))


def decode(ebits):
    """Soft burst bits (..., 424) -> (l2 (..., 24), crc_fail (...,),
    metric); crc_fail is 0 on success (bcch.c:84-103)."""
    ep = scramble.scramble_sbit(torch.as_tensor(ebits).to(torch.float32))
    c = interleave.deinterleave_intra(ep, IL_N)
    u, metric = viterbi.decode(CODE, c, CONV_LEN)
    bad = crc.crc_check(crc.CRC16, u[..., :MSG_BITS], MSG_BITS,
                        u[..., MSG_BITS:CONV_LEN])
    return bits.pack_bits(u[..., :MSG_BITS], 24), bad, metric
