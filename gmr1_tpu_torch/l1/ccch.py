"""CCCH channel coder (reference src/l1/ccch.c; counterpart of
gmr1_tpu/l1/ccch.py).

The BCCH chain, with the 424 interleaved bits inside a 432-bit field
that has 4 zero pad bits at each end (ccch.c:68-69,96), all scrambled.
"""

from __future__ import annotations

import torch

from ..ops import bits, conv, crc, interleave, scramble, viterbi

CODE = conv.K5_12
MSG_BITS = 192
CONV_LEN = 208
EBITS = 432
IL_N = 53


def encode(l2):
    """L2 bytes (..., 24) -> hard burst bits (..., 432)."""
    u = bits.unpack_bits(l2, MSG_BITS)
    c = crc.crc_compute(crc.CRC16, u, MSG_BITS)
    enc = conv.encode(CODE, torch.cat([u, c], dim=-1))
    core = interleave.interleave_intra(enc, IL_N)
    pad = core.new_zeros((*core.shape[:-1], 4))
    return scramble.scramble_ubit(torch.cat([pad, core, pad], dim=-1))


def decode(ebits):
    """Soft burst bits (..., 432) -> (l2 (..., 24), crc_fail, metric)."""
    ep = scramble.scramble_sbit(torch.as_tensor(ebits).to(torch.float32))
    c = interleave.deinterleave_intra(ep[..., 4:428], IL_N)
    u, metric = viterbi.decode(CODE, c, CONV_LEN)
    bad = crc.crc_check(crc.CRC16, u[..., :MSG_BITS], MSG_BITS,
                        u[..., MSG_BITS:CONV_LEN])
    return bits.pack_bits(u[..., :MSG_BITS], 24), bad, metric
