"""xCH over DC12 channel coder (reference src/l1/xch_dc12.c; counterpart
of gmr1_tpu/l1/xch_dc12.py).

24-byte L2 over a DC12 burst: 192 bits + CRC16 -> K=9 r=1/3
TAIL-BITING conv len 208, punctured P(12;13) to 432 bits ->
intra-interleave N=54 -> scramble.  The decode is the 256-state
tail-biting trellis: kernel V at S=256 on a CUDA tensor.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops import bits, conv, crc, interleave, puncture, scramble, viterbi

CODE = conv.ConvCode("k9_13_tb", 9, conv.K9_13.polys,
                     term=conv.TERM_TAIL_BITING)
MSG_BITS = 192
CONV_LEN = 208
EBITS = 432
IL_N = 54


@lru_cache(maxsize=None)
def _keep_idx() -> np.ndarray:
    keep = puncture.keep_indices(CODE.out_len(CONV_LEN), 3, "k9_13_P1213")
    if len(keep) != EBITS:
        raise AssertionError(len(keep))
    return keep


def encode(l2):
    """L2 bytes (..., 24) -> hard burst bits (..., 432)."""
    u = bits.unpack_bits(l2, MSG_BITS)
    c16 = crc.crc_compute(crc.CRC16, u, MSG_BITS)
    enc = conv.encode(CODE, torch.cat([u, c16], dim=-1))
    c = enc[..., torch.as_tensor(_keep_idx(), device=enc.device)]
    return scramble.scramble_ubit(interleave.interleave_intra(c, IL_N))


def decode(ebits):
    """Soft (..., 432) -> (l2 (..., 24), crc_fail (...,), metric)."""
    ep = scramble.scramble_sbit(torch.as_tensor(ebits).to(torch.float32))
    c = interleave.deinterleave_intra(ep, IL_N)
    full = viterbi.depuncture(c, _keep_idx(), CODE.out_len(CONV_LEN))
    u, metric = viterbi.decode(CODE, full, CONV_LEN)
    bad = crc.crc_check(crc.CRC16, u[..., :MSG_BITS], MSG_BITS,
                        u[..., MSG_BITS:CONV_LEN])
    return bits.pack_bits(u[..., :MSG_BITS], 24), bad, metric
