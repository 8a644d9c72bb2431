"""Packed-byte <-> unpacked-bit conversion, MSB first.

Counterpart of gmr1_tpu/ops/bits.py.  Conventions (osmocom):
  hard bit ("ubit"): uint8 0/1
  soft bit ("sbit"): int8 in [-127, 127]; positive = bit 0, negative = bit 1
"""

from __future__ import annotations

import numpy as np
import torch

from . import consts

_SHIFTS = np.arange(7, -1, -1, dtype=np.uint8)  # MSB first


def _shifts(dtype: str) -> np.ndarray:
    return _SHIFTS.astype(dtype)


def _u8(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.uint8)
    return torch.as_tensor(np.asarray(x, np.uint8))


def unpack_bits(data, nbits: int | None = None):
    """Unpack bytes (..., B) -> bits (..., 8*B or nbits), MSB first."""
    data = _u8(data)
    sh = consts.table(_shifts, "uint8", device=data.device)
    bits = (data[..., :, None] >> sh) & 1
    bits = bits.reshape(*data.shape[:-1], data.shape[-1] * 8)
    return bits if nbits is None else bits[..., :nbits]


def pack_bits(bits, nbytes: int | None = None):
    """Pack bits (..., N) -> bytes (..., ceil(N/8)), MSB first; bits past
    the input length count as zero."""
    bits = _u8(bits)
    n = bits.shape[-1]
    nb = (n + 7) // 8 if nbytes is None else nbytes
    pad = nb * 8 - n
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(*bits.shape[:-1], nb, 8).to(torch.int32)
    sh = consts.table(_shifts, "int32", device=bits.device)
    return torch.sum(bits << sh, dim=-1).to(torch.uint8)


def unpack_bits_np(data: np.ndarray, nbits: int | None = None) -> np.ndarray:
    """NumPy twin of unpack_bits for host-side table building."""
    bits = np.unpackbits(np.asarray(data, dtype=np.uint8), axis=-1)
    return bits if nbits is None else bits[..., :nbits]


def pack_bits_np(bits: np.ndarray, nbytes: int | None = None) -> np.ndarray:
    """NumPy twin of pack_bits."""
    bits = np.asarray(bits, dtype=np.uint8)
    n = bits.shape[-1]
    nb = (n + 7) // 8 if nbytes is None else nbytes
    pad = nb * 8 - n
    if pad:
        bits = np.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
    return np.packbits(bits, axis=-1)


def sbit_to_ubit(sbits):
    """Soft -> hard decision: negative soft value = bit 1 (osmocom sbit)."""
    return (torch.as_tensor(sbits) < 0).to(torch.uint8)


def ubit_to_sbit(ubits):
    """Hard -> ideal soft: bit 0 -> +127, bit 1 -> -127."""
    u = torch.as_tensor(ubits)
    return torch.where(u != 0, -127, 127).to(torch.int8)


def like(x, ref: torch.Tensor) -> torch.Tensor:
    """An array-like as a tensor of ref's dtype on ref's device."""
    return torch.as_tensor(x).to(device=ref.device, dtype=ref.dtype)
