"""FCCH chirp synchronization (reference src/sdr/fcch.c, TS 101 376-5-4 8).

Counterpart of gmr1_tpu/sdr/fcch.py:

  rough           coarse TOA: dual-chirp correlation over a >320 ms window
  scan_pwr        dual-chirp correlation power of a symbol-rate segment
                  (the incremental form of the >320 ms rough scan)
  rough_from_pwr  windowed peak + centroid refinement -> coarse TOA
  rough_multi*    multi-beam scan over >= 650 ms: correlation power, the
                  mix of the two 320 ms SI cycles and the avg+3*std
                  threshold on the device; the rising-edge peak scan and
                  the Lp-wrapped dedup on the host (fcch.c:342-496)
  fine            fine TOA + frequency error from the up/down-chirp mixed
                  spectra (dense planar DFTs, fcch.c:513-628)
  snr             spectral peak-over-noise estimate (fcch.c:644-708)

All batched over leading axes.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..ops import consts, cplx, dsp
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


def rough(burst: FcchBurst, x, sps: int, freq_shift=0.0):
    """Coarse FCCH TOA over a search window (gmr1_fcch_rough, fcch.c:212).

    x: planar (..., N, 2) with N > (320 ms + burst) * sps.  Returns int32
    TOA in input samples (...,)."""
    y = dsp.sig_normalize(cplx.tensor(x), sps, freq_shift)
    corr = dsp.correlate_conv(
        consts.table(_chirp_np, burst, 1, "dual", device=y.device), y)
    toa, _ = dsp.peak_energy_find(corr, 5, dsp.PEAK_WEIGH_WIN)
    return torch.round(toa * sps).to(torch.int32)


def scan_pwr(burst: FcchBurst, seg):
    """Dual-chirp correlation power of a symbol-rate segment (..., L, 2)
    -> (..., L - len_syms + 1), unnormalized (every consumer is invariant
    to a per-carrier positive scale)."""
    return cplx.abs2(dsp.correlate_conv(
        consts.table(_chirp_np, burst, 1, "dual", device=seg.device), seg))


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
    up = consts.table(_chirp_np, burst, 1, "up", device=dev)
    down = consts.table(_chirp_np, burst, 1, "down", device=dev)
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
    ref = consts.table(_chirp_np, burst, 1, "dual", device=y.device)[:, 0]
    e = cplx.abs2(cplx.dft(y * ref[:, None]))
    top = torch.topk(e, 6, dim=-1).values
    return (top[..., 0] + top[..., 1]) / (top[..., 4] + top[..., 5])


# --------------------------------------------------------------------------
# rough_multi: multi-beam acquisition
# --------------------------------------------------------------------------

_LW_MS = 320   # scan window / SI periodicity (fcch.c:380-383)


def _rough_multi_device(burst: FcchBurst, x, sps: int, freq_shift):
    """Device half of rough_multi: correlation power, periodicity mix,
    threshold (fcch.c:366-454).  x: planar (..., N, 2)."""
    y = dsp.sig_normalize(cplx.tensor(x), sps, freq_shift)
    corr = dsp.correlate_conv(
        consts.table(_chirp_np, burst, 1, "dual", device=y.device), y)
    return _rough_multi_pwr(burst, cplx.abs2(corr))


def _rough_multi_pwr(burst: FcchBurst, pwr):
    """Periodicity mix + threshold from correlation power (..., n), which
    may be unnormalized (every output is scale-equivariant or -invariant).
    Returns (mixed (..., Lw), threshold (...,), nLp (...,) int64,
    lp_ok (...,) bool)."""
    lw = (_LW_MS * SYM_RATE) // 1000 + burst.len_syms
    lp = (_LW_MS * SYM_RATE) // 1000
    n = pwr.shape[-1]
    dev = pwr.device
    # strongest peak within the first Lw samples
    pos = torch.arange(n, device=dev)
    idx = torch.argmax(torch.where(pos < lw, pwr, -1.0), dim=-1)

    # refine the periodicity: energy centroid +-10 around the peak and
    # around peak+Lp; nLp = centroid distance (fcch.c:399-430)
    offs = torch.arange(-10, 11, device=dev)

    def centroid(base):
        j = base[..., None] + offs
        ok = (j > 0) & (j < n)
        w = torch.where(ok, torch.gather(pwr, -1, torch.clamp(j, 0, n - 1)),
                        0.0)
        return (torch.sum(w * j.to(torch.float32), dim=-1)
                / torch.clamp(torch.sum(w, dim=-1), min=1e-20))
    n_lp = torch.round(centroid(idx + lp) - centroid(idx)).to(torch.int64)
    lp_ok = torch.abs(n_lp - lp) <= 10

    # mix the two SI cycles: geometric mean of pwr[i] and pwr[i+nLp]
    start = torch.clamp(n_lp, 0, n - lw)
    second = torch.gather(pwr, -1, start[..., None]
                          + torch.arange(lw, device=dev))
    mixed = torch.sqrt(pwr[..., :lw] * second)
    avg = torch.mean(mixed, dim=-1)
    std = torch.sqrt(torch.mean((mixed - avg[..., None]) ** 2, dim=-1))
    return mixed, avg + 3.0 * std, n_lp, lp_ok


def _edge_candidates(mixed: np.ndarray, th: float, sps: int):
    """Rising-edge peak scan (fcch.c:457-483), numpy-vectorized.
    Returns [(toa_in_samples, power), ...]."""
    above = mixed > th
    above[0] = above[-1] = False
    rise = np.flatnonzero(above & ~np.roll(above, 1))
    out = []
    for i in rise:
        p_pwr = float(mixed[i - 1] + mixed[i] + mixed[i + 1])
        p_fpos = float(-mixed[i - 1] + mixed[i + 1]) / p_pwr
        out.append((int(round((i + p_fpos) * sps)), p_pwr))
    return out


def _dedup_insert(cands, lp: int, half: int, n: int) -> list[int]:
    """Power-ordered insert with Lp-wrapped dedup (fcch.c:264-326)."""
    toas: list[int] = []
    pwrs: list[float] = []
    for p_pos, p_pwr in cands:
        dupe_stronger = False
        keep = []
        for t, p in zip(toas, pwrs):
            if abs((t % lp) - (p_pos % lp)) <= half:
                if p > p_pwr:
                    dupe_stronger = True
                else:
                    continue          # drop the weaker duplicate
            keep.append((t, p))
        toas, pwrs = [t for t, _ in keep], [p for _, p in keep]
        if dupe_stronger:
            continue
        k = next((j for j, p in enumerate(pwrs) if p_pwr > p), len(pwrs))
        if k < n:
            toas.insert(k, p_pos)
            pwrs.insert(k, p_pwr)
            del toas[n:], pwrs[n:]
    return toas


def _host(*tensors):
    return [t.cpu().numpy() for t in tensors]


def rough_multi(burst: FcchBurst, x, sps: int, freq_shift=0.0,
                n: int = 16) -> list[int]:
    """Multi-FCCH rough acquisition (gmr1_fcch_rough_multi, fcch.c:342).

    x: planar (N, 2) with N >= 650 ms of signal.  Returns up to n TOAs
    (input samples), strongest first."""
    x = cplx.tensor(x)
    if x.shape[0] < (650 * SYM_RATE * sps) // 1000:
        raise ValueError("need >= 650 ms of signal")
    mixed, th, n_lp, lp_ok = _host(
        *_rough_multi_device(burst, x, sps, freq_shift))
    if not lp_ok:
        raise ValueError(f"SI periodicity mismatch (nLp={int(n_lp)})")
    half = (burst.len_syms * sps) >> 1
    return _dedup_insert(_edge_candidates(mixed, float(th), sps),
                         int(n_lp), half, n)


def _beams_from_mixed(burst, sps, k, mixed, th, n_lp, lp_ok):
    """Host half of the batched multi-beam scan: per carrier, rising-edge
    candidates + Lp-wrapped power-ordered dedup."""
    half = (burst.len_syms * sps) >> 1
    m = mixed.shape[0]
    toas = np.full((m, k), -1, np.int64)
    for c in range(m):
        if not lp_ok[c]:
            continue
        got = _dedup_insert(_edge_candidates(mixed[c], float(th[c]), sps),
                            int(n_lp[c]), half, k)
        toas[c, :len(got)] = got
    return toas, toas >= 0


def rough_multi_batch(burst: FcchBurst, x, sps: int, k: int = 4,
                      freq_shift=0.0):
    """Batched multi-beam rough acquisition over carriers.

    x: planar (M, N, 2), N >= 650 ms + burst.  Returns (toas (M, k)
    int64, valid (M, k) bool), strongest beam first per carrier.
    Carriers with no SI periodicity (noise channels) get no beams."""
    x = cplx.tensor(x)
    fs = torch.as_tensor(freq_shift, dtype=torch.float32,
                         device=x.device).expand(x.shape[0])
    return _beams_from_mixed(burst, sps, k, *_host(
        *_rough_multi_device(burst, x, sps, fs)))


def rough_multi_batch_pwr(burst: FcchBurst, pwr, sps: int, k: int = 4):
    """rough_multi_batch from ACCUMULATED correlation power (M, n), the
    incremental-scan form (see scan_pwr for why normalization is
    unnecessary)."""
    return _beams_from_mixed(burst, sps, k, *_host(
        *_rough_multi_pwr(burst, torch.as_tensor(pwr))))
