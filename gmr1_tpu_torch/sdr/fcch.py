"""FCCH chirp synchronization (reference src/sdr/fcch.c, TS 101 376-5-4 8).

Counterpart of gmr1_tpu/sdr/fcch.py for single-beam acquisition:

  scan_pwr        dual-chirp correlation power of a symbol-rate segment
                  (the incremental form of the >320 ms rough scan)
  rough_from_pwr  windowed peak + centroid refinement -> coarse TOA
  fine            fine TOA + frequency error from the up/down-chirp mixed
                  spectra (dense planar DFTs, fcch.c:513-628)
  snr             spectral peak-over-noise estimate (fcch.c:644-708)

All batched over leading axes.  The multi-beam `rough_multi*` family is
not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..ops import cplx, dsp
from .defs import SYM_RATE


@dataclass(frozen=True)
class FcchBurst:
    """FCCH burst format (reference fcch.c:50-70)."""
    freq: float      # chirp frequency excursion (cycles/symbol at edges)
    len_syms: int    # burst length in symbols


FCCH = FcchBurst(freq=0.32, len_syms=3 * 39)            # GMR-1 (fcch.c:50)
FCCH3_LBAND = FcchBurst(freq=0.32, len_syms=12 * 39)    # fcch.c:59
FCCH3_SBAND = FcchBurst(freq=0.16, len_syms=12 * 39)    # fcch.c:67


@lru_cache(maxsize=None)
def _chirp_np(burst: FcchBurst, sps: int, kind: str) -> np.ndarray:
    """Planar chirp reference (fcch.c:92-193).

    kind: 'up'   = (sqrt2/2) exp(+j*phi(t))
          'down' = (sqrt2/2) exp(-j*phi(t))
          'dual' = sqrt2 * cos(phi(t))      (real only)
    with phi(t) = 2*pi*freq*(t - T/2)^2 / T, t in symbols.
    """
    n = burst.len_syms * sps
    pos = np.arange(n, dtype=np.float32) / sps - burst.len_syms / 2.0
    phase = (burst.freq * 2.0 * np.pi / burst.len_syms) * pos * pos
    if kind == "dual":
        z = np.sqrt(2.0) * np.cos(phase) + 0j
    elif kind == "up":
        z = np.sqrt(2.0) / 2.0 * np.exp(1j * phase)
    else:
        z = np.sqrt(2.0) / 2.0 * np.exp(-1j * phase)
    return cplx.planar_np(z.astype(np.complex64))


def scan_pwr(burst: FcchBurst, seg):
    """Dual-chirp correlation power of a symbol-rate segment (..., L, 2)
    -> (..., L - len_syms + 1), unnormalized (every consumer is invariant
    to a per-carrier positive scale)."""
    return cplx.abs2(dsp.correlate_conv(_chirp_np(burst, 1, "dual"), seg))


def rough_from_pwr(burst: FcchBurst, pwr, sps: int):
    """Coarse TOA (int32, input samples) from correlation power (..., n):
    windowed peak + centroid refinement (gmr1_fcch_rough, fcch.c:212)."""
    toa = dsp.peak_find_energy(pwr, 5, dsp.PEAK_WEIGH_WIN)
    return torch.round(toa * sps).to(torch.int32)


def fine(burst: FcchBurst, x, sps: int, freq_shift=0.0):
    """Fine TOA + frequency error (gmr1_fcch_fine, fcch.c:513).

    x: planar (..., len_syms*sps, 2).  Returns (toa int32 in input
    samples, freq_error float32 rad/symbol), both (...,)."""
    y = dsp.sig_normalize(cplx.tensor(x), sps, freq_shift)
    n = burst.len_syms
    if y.shape[-2] != n:
        raise ValueError(f"fine() needs {n * sps} samples")
    mid = n >> 1
    dev = y.device
    up = torch.as_tensor(_chirp_np(burst, 1, "up"), device=dev)
    down = torch.as_tensor(_chirp_np(burst, 1, "down"), device=dev)
    # pre-shift so frequency 0 lands on bin `mid` (fcch.c:574-580)
    shift = cplx.expi(2.0 * np.pi * mid / n
                      * torch.arange(n, dtype=torch.float32, device=dev))
    mix = torch.stack([cplx.mul(y, up), cplx.mul(y, down)], dim=-3)
    spec = cplx.dft(cplx.mul(mix, shift))
    peak, _ = dsp.peak_energy_find(torch.movedim(spec, -3, 0), 5,
                                   dsp.PEAK_WEIGH_WIN)
    bin_hz = SYM_RATE / n
    peak_up = (peak[0] - mid) * bin_hz
    peak_down = (peak[1] - mid) * bin_hz
    freq_error = 2.0 * np.pi * ((peak_up + peak_down) / 2.0) / SYM_RATE
    chirp_rate = 2.0 * burst.freq * SYM_RATE * SYM_RATE / (n * 1000.0)
    toa_ms = (peak_up - peak_down) / 2.0 / chirp_rate
    toa = torch.round(toa_ms * SYM_RATE * sps / 1000.0).to(torch.int32)
    return toa, freq_error


def snr(burst: FcchBurst, x, sps: int, freq_shift=0.0):
    """FFT peak-over-noise SNR estimate (gmr1_fcch_snr, fcch.c:644):
    (top 2 peak energies) / (peaks 5 and 6) of the dual-chirp-mixed
    spectrum.  x: planar (..., len_syms*sps, 2)."""
    y = dsp.sig_normalize(cplx.tensor(x), sps, freq_shift)
    if y.shape[-2] != burst.len_syms:
        raise ValueError(f"snr() needs {burst.len_syms * sps} samples")
    ref = torch.as_tensor(_chirp_np(burst, 1, "dual")[:, 0], device=y.device)
    e = cplx.abs2(cplx.dft(y * ref[:, None]))
    top = torch.topk(e, 6, dim=-1).values
    return (top[..., 0] + top[..., 1]) / (top[..., 4] + top[..., 5])
