"""DKAB (Dummy Keep-Alive Burst) detection + demod (reference src/sdr/dkab.c).

Counterpart of gmr1_tpu/sdr/dkab.py.  A DKAB is two 5-symbol keep-alive
tones at symbol offsets (2+p) and (2+p+59) inside a 117-symbol slot
triple.  Detection is a sliding two-window power sum (dkab.c:58-144),
here a cumsum-based moving sum over the energy track; demodulation is
the differential phase of 4 symbol pairs per tone -> 8 soft bits
(dkab.c:155-172).  Batched over leading axes and branch-free: the
found/not-found decision comes back as a boolean beside the bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import cplx, dsp

DKAB_SYMS = 39 * 3              # dkab.h GMR1_DKAB_SYMS
PWR_RATIO_THRESHOLD = 10.0      # dkab.c:47


class DkabResult(NamedTuple):
    ebits: torch.Tensor   # (..., 8) int8 soft bits
    toa: torch.Tensor     # (...,) float32 TOA in input samples
    found: torch.Tensor   # (...,) bool peak/valley power-ratio gate


def _take(x, idx):
    """x (..., n) at idx (..., k) along the last axis, x broadcast to
    idx's batch shape."""
    return torch.gather(x.expand(*idx.shape[:-1], x.shape[-1]), -1, idx)


def demod(x, sps: int, p, freq_shift=0.0) -> DkabResult:
    """Find + demodulate a DKAB (gmr1_dkab_demod, dkab.c:188).

    x: planar (..., N, 2) with N >= DKAB_SYMS*sps (extra length is the
    TOA search window).  p is the DKAB position within the slot, a
    scalar or one value per batch row (the wideband receiver demodulates
    carriers with different assigned positions in one call)."""
    x = cplx.tensor(x)
    dev = x.device
    fs = torch.as_tensor(freq_shift, dtype=torch.float32, device=dev)
    y = dsp.sig_normalize(x, 1, (fs - np.pi / 4) / sps)
    e = cplx.abs2(y)                      # (..., N)
    n = e.shape[-1]
    w = n - DKAB_SYMS * sps + 1
    if w <= 0:
        raise ValueError(f"window of {n} samples is shorter than a DKAB")

    p = torch.as_tensor(p, dtype=torch.int64, device=dev)
    ofs0 = sps * (2 + p)                  # scalar or (...,)
    ofs1 = sps * (2 + p + 59)
    d = sps * 5

    # sliding sum of the two KAB windows (dkab.c:80-107)
    cs = torch.nn.functional.pad(torch.cumsum(e, dim=-1), (1, 0))
    bshape = torch.broadcast_shapes(cs.shape[:-1], p.shape)
    cs = cs.expand(*bshape, cs.shape[-1])
    iw = torch.arange(w, device=dev)

    def winsum(ofs):
        base = (ofs[..., None] + iw).expand(*bshape, w)
        return _take(cs, base + d) - _take(cs, base)
    pwr = winsum(ofs0) + winsum(ofs1)     # (..., w)

    mi = torch.argmax(pwr, dim=-1)
    # parabolic refine (dkab.c:112-116)
    im = torch.clamp(mi - 1, 0, w - 1)
    ip = torch.clamp(mi + 1, 0, w - 1)
    p0 = _take(pwr, im[..., None])[..., 0]
    p1 = _take(pwr, mi[..., None])[..., 0]
    p2 = _take(pwr, ip[..., None])[..., 0]
    denom = -p0 + 2.0 * p1 - p2
    frac = torch.where((mi > 0) & (mi < w - 1) & (torch.abs(denom) > 1e-20),
                       0.5 * (-p0 + p2) / torch.where(
                           denom == 0, torch.ones_like(denom), denom),
                       torch.zeros_like(denom))
    toa = mi.to(torch.float32) + frac + (sps - 1) / 2.0

    # peak/valley ratio gate at the rounded TOA (dkab.c:122-138)
    toa_i = torch.clamp(torch.round(toa).to(torch.int64), 0, w - 1)
    egy_peak = _take(pwr, toa_i[..., None])[..., 0] / (2 * d)
    l_valley = sps * 54                   # ofs1 - ofs0 - d, p-independent
    base_v = (ofs0[..., None] + d + iw).expand(*bshape, w)
    valley = _take(cs, base_v + l_valley) - _take(cs, base_v)
    egy_valley = _take(valley, toa_i[..., None])[..., 0] / l_valley
    found = egy_peak > PWR_RATIO_THRESHOLD * egy_valley

    # differential-phase soft bits (dkab.c:155-172)
    i8 = torch.arange(8, device=dev)
    rel = (torch.where(i8 < 4, ofs0[..., None], ofs1[..., None])
           + sps * (i8 & 3))
    idx = toa_i[..., None] + rel                               # (..., 8)
    yb = y.expand(*bshape, *y.shape[-2:])

    def at(k):
        return torch.gather(yb, -2, k[..., None].expand(*k.shape, 2))
    pd = cplx.angle(cplx.conj_mul(at(idx + sps), at(idx)))    # arg(a conj b)
    ebits = torch.round((0.5 - torch.abs(pd) / np.pi) * 254.0)
    ebits = torch.clamp(ebits, -127, 127).to(torch.int8)
    return DkabResult(ebits=ebits, toa=toa, found=found)
