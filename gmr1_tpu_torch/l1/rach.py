"""RACH channel coder (reference src/l1/rach.c; counterpart of
gmr1_tpu/l1/rach.py).

18-byte packet (2 class-1 + 16 class-2 bytes):
  class-1: 16 bits + CRC8 (XORed with the SB mask), placed at u[135:159]
  class-2: 123 bits + CRC12, placed at u[0:135]
  -> K=5 r=1/4 conv len 159 (flush) with a custom puncturer deleting
     output bits 4i+2, 4i+3 for i<135 (rach.c:58-63) -> 382 coded bits
  -> split interleave: c[270:382] intra N=14 -> e1p (112, the class-1
     part), c[0:264] intra N=33 + c[264:270] raw -> e2p (270)
  -> e' = [e1p, e2p, e1p]  (class-1 repeated, rach.c:111-113)
  -> scramble(494) -> 4-segment multiplex -> 494 burst bits.

Decode soft-combines the two class-1 copies ((a + b) / 2, as the JAX
package does for the reference's (a+b)>>1, rach.c:159-160) and retries
the CRC8 with the SB mask applied (rach.c:178-182).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops import bits, conv, crc, interleave, scramble, viterbi

CODE = conv.K5_14
CONV_LEN = 159
EBITS = 494


@lru_cache(maxsize=None)
def _keep_idx() -> np.ndarray:
    deleted = np.concatenate(
        [(np.arange(135) << 2) + 2, (np.arange(135) << 2) + 3])
    return np.setdiff1d(np.arange(CODE.out_len(CONV_LEN)),
                        deleted).astype(np.int32)


def _sb_mask_bits(sb_mask, ref: torch.Tensor):
    m = bits.like(sb_mask, ref.to(torch.int32))
    sh = torch.arange(7, -1, -1, dtype=torch.int32, device=ref.device)
    return ((m[..., None] >> sh) & 1).to(torch.uint8)


def encode(rach, sb_mask):
    """(rach (..., 18) bytes, sb_mask (...,) uint8) -> hard bits
    (..., 494)."""
    rb = bits.unpack_bits(rach)                          # (..., 144)
    u1 = rb[..., :16]
    u2 = rb[..., 16:139]                                 # 123 bits
    c8 = crc.crc_compute(crc.CRC8, u1, 16) ^ _sb_mask_bits(sb_mask, rb)
    c12 = crc.crc_compute(crc.CRC12, u2, 123)
    enc = conv.encode(CODE, torch.cat([u2, c12, u1, c8], dim=-1))
    c = enc[..., torch.as_tensor(_keep_idx(), device=enc.device)]  # 382
    e1p = interleave.interleave_intra(c[..., 270:382], 14)
    e2p = torch.cat([interleave.interleave_intra(c[..., :264], 33),
                     c[..., 264:270]], dim=-1)
    x = scramble.scramble_ubit(torch.cat([e1p, e2p, e1p], dim=-1))
    return torch.cat([x[..., 112:248], x[..., :112], x[..., 382:494],
                      x[..., 248:382]], dim=-1)


def decode(ebits, sb_mask):
    """Soft (..., 494) -> (rach (..., 18) bytes, crc_fail (..., 2),
    metric).

    crc_fail[..., 0] is the class-1 CRC8 (after the mask retry),
    crc_fail[..., 1] the class-2 CRC12; overall success = both zero."""
    e = torch.as_tensor(ebits).to(torch.float32)
    x = torch.cat([e[..., 136:248], e[..., :136], e[..., 360:494],
                   e[..., 248:360]], dim=-1)
    ep = scramble.scramble_sbit(x)
    e2p = ep[..., 112:382]
    e1p = (ep[..., :112] + ep[..., 382:494]) / 2.0       # soft-combine
    c = torch.cat([interleave.deinterleave_intra(e2p[..., :264], 33),
                   e2p[..., 264:270],
                   interleave.deinterleave_intra(e1p, 14)], dim=-1)
    full = viterbi.depuncture(c, _keep_idx(), CODE.out_len(CONV_LEN))
    u, metric = viterbi.decode(CODE, full, CONV_LEN)
    u2, c12 = u[..., :123], u[..., 123:135]
    u1, c8 = u[..., 135:151], u[..., 151:159]
    bad12 = crc.crc_check(crc.CRC12, u2, 123, c12)
    bad8_raw = crc.crc_check(crc.CRC8, u1, 16, c8)
    bad8_masked = crc.crc_check(crc.CRC8, u1, 16,
                                c8 ^ _sb_mask_bits(sb_mask, c8))
    bad8 = torch.where(bad8_raw != 0, bad8_masked, bad8_raw)
    rach = bits.pack_bits(torch.cat([u1, u2], dim=-1), 18)
    return rach, torch.stack([bad8, bad12], dim=-1), metric
