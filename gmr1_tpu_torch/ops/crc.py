"""GMR-1 CRCs (ETSI TS 101 376-5-3 4.3) as GF(2) matrix products.

Counterpart of gmr1_tpu/ops/crc.py: a CRC with init=0 and no final XOR
is linear over GF(2), so a batched CRC is (bits @ A) mod 2 with the
host-built generator matrix A[msg_len, crc_bits].  The product runs in
float32 (0/1 operands, sums <= msg_len: exact), since CUDA has no
integer matmul.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from . import consts

# full float32 matmuls, as everywhere in the port (TF32 rounds the
# operands to 10 mantissa bits)
torch.backends.cuda.matmul.allow_tf32 = False


@dataclass(frozen=True)
class CrcCode:
    bits: int
    poly: int  # without the implicit top bit


CRC8 = CrcCode(bits=8, poly=0x9B)      # g8  = D8+D7+D4+D3+D+1
CRC12 = CrcCode(bits=12, poly=0x80F)   # g12 = D12+D11+D3+D2+D+1
CRC16 = CrcCode(bits=16, poly=0x1021)  # g16 = D16+D12+D5+1


def crc_bits_serial(code: CrcCode, bits: np.ndarray) -> np.ndarray:
    """Host bit-serial CRC over an unpacked bit array, MSB-first LFSR
    (osmo_crcXXgen_compute_bits with init=0, remainder=0)."""
    reg = 0
    top = 1 << (code.bits - 1)
    mask = (1 << code.bits) - 1
    for b in np.asarray(bits, dtype=np.uint8):
        fb = ((reg & top) != 0) ^ (b != 0)
        reg = (reg << 1) & mask
        if fb:
            reg ^= code.poly
    return np.array([(reg >> (code.bits - 1 - i)) & 1
                     for i in range(code.bits)], np.uint8)


@lru_cache(maxsize=None)
def _gen_matrix(bits: int, poly: int, msg_len: int) -> np.ndarray:
    code = CrcCode(bits=bits, poly=poly)
    eye = np.eye(msg_len, dtype=np.uint8)
    return np.stack([crc_bits_serial(code, eye[i])
                     for i in range(msg_len)]).astype(np.float32)


def crc_compute(code: CrcCode, bits, msg_len: int):
    """CRC over bits (..., msg_len) -> (..., code.bits) uint8."""
    bits = torch.as_tensor(bits)
    a = consts.table(_gen_matrix, code.bits, code.poly, msg_len,
                     device=bits.device)
    x = bits[..., :msg_len].to(torch.float32)
    return (torch.remainder(x @ a, 2.0)).to(torch.uint8)


def crc_check(code: CrcCode, bits, msg_len: int, crc_in):
    """0 where the CRC matches, 1 where it fails (per batch element)."""
    calc = crc_compute(code, bits, msg_len)
    bad = torch.any(calc != torch.as_tensor(crc_in).to(torch.uint8), dim=-1)
    return bad.to(torch.int32)
