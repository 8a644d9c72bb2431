"""Complex-vector DSP primitives on planar tensors.

Counterpart of gmr1_tpu/ops/dsp.py: signal normalization, strided
correlation (a dilated conv1d), windowed peak search with sub-sample
refinement, sinc fractional delay.  Batched over leading axes.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as tf

from . import cplx

# the correlations below are convolutions: cuDNN would run them in TF32
torch.backends.cudnn.allow_tf32 = False

PEAK_EARLY_LATE = "early_late"
PEAK_WEIGH_WIN = "weigh_win"


def sig_normalize(x, decim: int, freq_shift):
    """Decimate, frequency-shift, and amplitude-normalize a planar signal.

    out[..., i, :] = x[..., i*decim, :] * exp(1j*freq_shift*i), scaled to
    unit average energy.  freq_shift (radians per output sample) may be
    scalar or per-batch (...,).
    """
    y = x[..., ::decim, :]
    n = y.shape[-2]
    i = torch.arange(n, dtype=torch.float32, device=y.device)
    if isinstance(freq_shift, torch.Tensor) or np.ndim(freq_shift):
        shift = torch.as_tensor(freq_shift, dtype=torch.float32,
                                device=y.device)[..., None]
    else:                       # a scalar: a fill, no host-to-device copy
        shift = torch.full((1,), float(freq_shift), device=y.device)
    y = cplx.mul(y, cplx.expi(shift * i))
    energy = torch.mean(cplx.abs2(y), dim=-1, keepdim=True)
    return y * torch.rsqrt(torch.clamp(energy, min=1e-30))[..., None]


def _corr_kernel(ref, device) -> torch.Tensor:
    """(2 out, 2 in, L) conv1d weights computing conj(ref) * x; ref is
    planar (L, 2), a host array or a tensor (consts.table)."""
    ref = torch.as_tensor(ref, dtype=torch.float32, device=device)
    rr, ri = ref[..., 0], ref[..., 1]
    return torch.stack([torch.stack([rr, ri]), torch.stack([-ri, rr])])


def _conv(ref, win, step: int):
    batch_shape = win.shape[:-2]
    x = win.reshape(-1, win.shape[-2], 2).transpose(1, 2)   # (B, 2, W)
    y = tf.conv1d(x, _corr_kernel(ref, win.device), dilation=step)
    return y, batch_shape


def correlate(ref, win, step: int):
    """Strided sliding correlation (osmo_cxvec_correlate semantics).

    out[..., k, :] = sum_j conj(ref[j]) * win[..., k + j*step, :]
    for k in [0, win_len - ref_len*step + 1).  ref: (L, 2) planar.
    """
    n_out = win.shape[-2] - len(ref) * step + 1
    y, batch_shape = _conv(ref, win, step)
    y = y[..., :n_out].transpose(1, 2)
    return y.reshape(*batch_shape, n_out, 2)


def correlate_conv(ref, win):
    """Unstrided linear correlation for long windows:
    out[..., k, :] = sum_j conj(ref[j]) * win[..., k+j, :]."""
    y, batch_shape = _conv(ref, win, 1)
    y = y.transpose(1, 2)
    return y.reshape(*batch_shape, y.shape[-2], 2)


def peak_energy_find(v, wl: int, mode: str):
    """Windowed peak search with sub-sample refinement on planar v.

    Returns (toa, peak_val): fractional peak position (...,) float32 and
    the planar complex value at the integer peak (..., 2)."""
    return _peak_from_energy(cplx.abs2(v), v, wl, mode)


def peak_find_energy(e, wl: int, mode: str):
    """peak_energy_find on precomputed energies (..., N): the fractional
    peak position only (invariant to a per-batch positive scale)."""
    toa, _ = _peak_from_energy(e, None, wl, mode)
    return toa


def _take(e, idx):
    return torch.gather(e, -1, idx[..., None])[..., 0]


def _peak_from_energy(e, v, wl: int, mode: str):
    n = e.shape[-1]
    half = wl // 2
    idx = torch.argmax(_moving_sum(e, wl), dim=-1)
    peak_val = None if v is None else torch.gather(
        v, -2, idx[..., None, None].expand(*idx.shape, 1, 2))[..., 0, :]

    if mode == PEAK_EARLY_LATE:
        e0 = _take(e, torch.clamp(idx - 1, 0, n - 1))
        e1 = _take(e, idx)
        e2 = _take(e, torch.clamp(idx + 1, 0, n - 1))
        denom = 2.0 * e1 - e0 - e2
        frac = torch.where(torch.abs(denom) > 1e-20,
                           0.5 * (e2 - e0) / torch.clamp(denom, min=1e-20),
                           torch.zeros_like(denom))
        frac = torch.clamp(frac, -1.0, 1.0)
        toa = idx.to(torch.float32) + frac
    else:  # PEAK_WEIGH_WIN: energy centroid over the window
        offs = torch.arange(-half, half + 1, device=e.device)
        pos = torch.clamp(idx[..., None] + offs, 0, n - 1)
        ew = torch.gather(e, -1, pos)
        toa = (torch.sum(ew * pos.to(torch.float32), dim=-1)
               / torch.clamp(torch.sum(ew, dim=-1), min=1e-20))
    return toa, peak_val


def _moving_sum(e, wl: int):
    """Centered moving sum of length wl along the last axis."""
    half = wl // 2
    ep = tf.pad(e, (half, wl - 1 - half))
    cs = torch.cumsum(ep, dim=-1)
    cs = tf.pad(cs, (1, 0))
    return cs[..., wl:] - cs[..., :-wl]


def peaks_scan(v, k: int):
    """Indices of the k highest-energy bins, descending
    (osmo_cxvec_peaks_scan).  A stable descending sort puts the lower
    index first on ties, as jax.lax.top_k does; torch.topk does not
    promise that on CUDA."""
    e = cplx.abs2(cplx.tensor(v))
    return torch.sort(e, dim=-1, descending=True, stable=True)[1][..., :k]


@lru_cache(maxsize=None)
def _sinc_base(n_taps: int) -> np.ndarray:
    return (np.arange(n_taps) - (n_taps // 2)).astype(np.float32)


def fractional_delay(x, frac, n_taps: int = 21):
    """Shift planar x (..., L, 2) by per-batch frac: out[n] ~= x(n + frac).
    21-tap windowed sinc (pi4cxpsk.c:310-326), frac in (-0.5, 0.5)."""
    base = torch.as_tensor(_sinc_base(n_taps), device=x.device)
    taps = torch.sinc(base - frac[..., None])               # (..., n_taps)
    half = n_taps // 2
    xp = tf.pad(x, (0, 0, half, half))
    win = xp.unfold(-2, n_taps, 1)                          # (..., L, 2, n)
    return torch.sum(win * taps[..., None, None, :], dim=-1)
