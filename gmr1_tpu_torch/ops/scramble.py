"""GMR-1 scrambling (ETSI TS 101 376-5-3 4.9).

Counterpart of gmr1_tpu/ops/scramble.py: the 15-bit LFSR sequence
(h(D) = 1 + D + D^15, seed 0x4d4b) is a host constant applied as an XOR
(hard bits) or a sign flip (soft bits).
"""

from __future__ import annotations

import numpy as np
import torch

from . import consts

_SEED = 0x4D4B
_MAX_LEN = 1024  # longest scrambled block in GMR-1 L1 is 658 (tch9.c)


def _gen_sequence(n: int) -> np.ndarray:
    """Host LFSR: b = (reg>>14 ^ reg) & 1; reg = (reg<<1)|b (scramb.c:48-49)."""
    reg = _SEED
    out = np.empty(n, dtype=np.uint8)
    for i in range(n):
        b = ((reg >> 14) ^ reg) & 1
        reg = ((reg << 1) | b) & 0xFFFF
        out[i] = b
    return out


_SEQ = _gen_sequence(_MAX_LEN)
_SIGN = np.where(_SEQ != 0, -1, 1).astype(np.int32)


def scramble_seq(n: int) -> np.ndarray:
    """The first n scramble bits (host constant)."""
    if n > _MAX_LEN:
        raise ValueError(n)
    return _SEQ[:n]


def _sign(n: int) -> np.ndarray:
    return _SIGN[:n]


def scramble_ubit(bits):
    """XOR hard bits (..., N) with the scramble sequence."""
    bits = torch.as_tensor(bits)
    n = bits.shape[-1]
    return bits ^ consts.table(scramble_seq, n, device=bits.device).to(
        bits.dtype)


def scramble_sbit(sbits):
    """Sign-flip soft bits (..., N) where the scramble bit is 1
    (self-inverse, gmr1_scramble_sbit)."""
    sbits = torch.as_tensor(sbits)
    n = sbits.shape[-1]
    return sbits * consts.table(_sign, n, device=sbits.device).to(
        sbits.dtype)
