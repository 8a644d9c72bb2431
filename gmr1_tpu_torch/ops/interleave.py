"""GMR-1 interleaving (ETSI TS 101 376-5-3 4.8).

Counterpart of gmr1_tpu/ops/interleave.py.

Intra-burst: bit kc of an 8N-bit block goes to kep = N*((5*kc) mod 8)
+ floor(kc/8), a fixed host table per N applied as one index_select in
either direction.

Inter-burst: the reference's N-row ring buffer (interleave.c:136-190)
as a functional state (`InterleaverState`) that each burst step takes
and returns; leading batch dims ride along, so a batch of carriers'
rings steps together.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from . import consts


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


def _intra_idx(n: int, inverse: int) -> np.ndarray:
    return intra_tables(n)[inverse]


def _take(bits, n: int, inverse: int):
    bits = torch.as_tensor(bits)
    return torch.index_select(
        bits, -1, consts.table(_intra_idx, n, inverse, device=bits.device))


def interleave_intra(bits, n: int):
    """Interleave (..., 8n) -> (..., 8n)."""
    return _take(bits, n, 0)


def deinterleave_intra(bits, n: int):
    """Deinterleave (..., 8n) -> (..., 8n)."""
    return _take(bits, n, 1)


class InterleaverState(NamedTuple):
    """Functional inter-burst (depth N, width K) interleaver state
    (struct gmr1_interleaver, interleave.h:44-50): `buf` (..., N, K) is
    the ring of past bursts, `n` (...) the int64 burst counter."""

    buf: torch.Tensor
    n: torch.Tensor


def interleaver_init(n: int, k: int, dtype=torch.int8) -> InterleaverState:
    return InterleaverState(buf=torch.zeros((n, k), dtype=dtype),
                            n=torch.zeros((), dtype=torch.int64))


def _col_rows(st: InterleaverState):
    """(..., 1, K): ring row of column jk, ((n - jk) mod N)
    (interleave.c:152)."""
    n_depth, k = st.buf.shape[-2:]
    jk = torch.arange(k, device=st.buf.device)
    return torch.remainder(st.n[..., None] - jk, n_depth)[..., None, :]


def _row(buf, r):
    """buf (..., N, K) at ring row r (...) -> (..., K)."""
    idx = r[..., None, None].expand(*buf.shape[:-2], 1, buf.shape[-1])
    return torch.gather(buf, -2, idx)[..., 0, :]


def interleave_inter(st: InterleaverState, bits_ep):
    """One burst through the inter-burst interleaver ->
    (new_state, bits_epp) (gmr1_interleave_inter, interleave.c:136-158):
    the burst is written to ring row (n mod N), and output column jk is
    read from ring row ((n - jk) mod N)."""
    n_depth = st.buf.shape[-2]
    bits_ep = torch.as_tensor(bits_ep).to(st.buf.dtype)
    row = torch.remainder(st.n, n_depth)
    wmask = (torch.arange(n_depth, device=st.buf.device)
             == row[..., None])[..., None]
    buf = torch.where(wmask, bits_ep[..., None, :], st.buf)
    out = torch.gather(buf, -2, _col_rows(st).expand(
        *buf.shape[:-2], 1, buf.shape[-1]))[..., 0, :]
    return InterleaverState(buf=buf, n=st.n + 1), out


def deinterleave_inter(st: InterleaverState, bits_epp, valid=None):
    """One burst through the inter-burst de-interleaver ->
    (new_state, bits_ep) (gmr1_deinterleave_inter, interleave.c:168-190):
    input column jk goes to ring row ((n - jk) mod N), and the output is
    ring row ((n + 1) mod N), the burst assembled N-1 bursts ago.

    `valid` (bool, batch-shaped) gates the ring: where False the state
    is unchanged and the output is garbage the caller masks (the
    reference advances its ring only on real TCH9 bursts,
    gmr1_rx.c:321-347)."""
    n_depth = st.buf.shape[-2]
    bits_epp = torch.as_tensor(bits_epp).to(st.buf.dtype)
    rows = torch.arange(n_depth, device=st.buf.device)[:, None]
    buf = torch.where(_col_rows(st) == rows, bits_epp[..., None, :], st.buf)
    out = _row(buf, torch.remainder(st.n + 1, n_depth))
    n2 = st.n + 1
    if valid is not None:
        v = torch.as_tensor(valid, device=st.buf.device)
        buf = torch.where(v[..., None, None], buf, st.buf)
        n2 = torch.where(v, n2, st.n)
    return InterleaverState(buf=buf, n=n2), out
