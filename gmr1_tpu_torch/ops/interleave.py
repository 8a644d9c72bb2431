"""GMR-1 intra-burst interleaving (ETSI TS 101 376-5-3 4.8).

Counterpart of gmr1_tpu/ops/interleave.py: bit kc of an 8N-bit block
goes to kep = N*((5*kc) mod 8) + floor(kc/8), a fixed host table per N
applied as one index_select in either direction.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def intra_tables(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(forward, inverse) index tables for the 8N-bit intra interleave.

    forward[kep] = kc   such that out[kep] = in[kc]  (interleave)
    inverse[kc]  = kep  such that out[kc]  = in[kep] (deinterleave)
    """
    kc = np.arange(8 * n)
    kep = n * ((5 * kc) & 7) + (kc >> 3)
    fwd = np.empty(8 * n, dtype=np.int64)
    fwd[kep] = kc
    return fwd, kep.astype(np.int64)


def _take(bits, idx: np.ndarray):
    bits = torch.as_tensor(bits)
    return torch.index_select(bits, -1,
                              torch.as_tensor(idx, device=bits.device))


def interleave_intra(bits, n: int):
    """Interleave (..., 8n) -> (..., 8n)."""
    return _take(bits, intra_tables(n)[0])


def deinterleave_intra(bits, n: int):
    """Deinterleave (..., 8n) -> (..., 8n)."""
    return _take(bits, intra_tables(n)[1])
