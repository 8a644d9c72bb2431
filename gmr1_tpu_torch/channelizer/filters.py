"""FIR design helpers (host-side, numpy) for the wideband channelizer.

Equivalents of the GNURadio firdes calls the reference front-end makes
(utils/gmr1_rx_sdr.py:420-437, 524-531): windowed-sinc low-pass (with
the harris ntaps estimate), high-attenuation low-pass for perfect
reconstruction, and root-raised-cosine for the final per-carrier
resampler.
"""

from __future__ import annotations

import numpy as np

# max attenuation of the window, used in the ntaps estimate
_WIN_ATT = {"hamming": 53.0, "hann": 44.0, "blackman": 74.0,
            "blackmanharris": 92.0}


def _window(name: str, n: int) -> np.ndarray:
    m = np.arange(n)
    if name == "hamming":
        return 0.54 - 0.46 * np.cos(2 * np.pi * m / (n - 1))
    if name == "hann":
        return 0.5 - 0.5 * np.cos(2 * np.pi * m / (n - 1))
    if name == "blackman":
        return (0.42 - 0.5 * np.cos(2 * np.pi * m / (n - 1))
                + 0.08 * np.cos(4 * np.pi * m / (n - 1)))
    if name == "blackmanharris":
        return (0.35875 - 0.48829 * np.cos(2 * np.pi * m / (n - 1))
                + 0.14128 * np.cos(4 * np.pi * m / (n - 1))
                - 0.01168 * np.cos(6 * np.pi * m / (n - 1)))
    raise ValueError(name)


def low_pass(gain: float, fs: float, cutoff: float, transition: float,
             window: str = "hamming") -> np.ndarray:
    """GNURadio firdes.low_pass: windowed sinc, harris ntaps rule."""
    att = _WIN_ATT[window]
    ntaps = int(att * fs / (22.0 * transition))
    ntaps |= 1                                    # odd
    return _sinc_lp(gain, fs, cutoff, ntaps, window)


def low_pass_2(gain: float, fs: float, cutoff: float, transition: float,
               att_db: float, window: str = "blackmanharris") -> np.ndarray:
    """GNURadio firdes.low_pass_2: attenuation-specified low-pass."""
    ntaps = int(att_db * fs / (22.0 * transition)) | 1
    return _sinc_lp(gain, fs, cutoff, ntaps, window)


def _sinc_lp(gain, fs, cutoff, ntaps, window) -> np.ndarray:
    m = np.arange(ntaps) - (ntaps - 1) / 2.0
    h = 2.0 * cutoff / fs * np.sinc(2.0 * cutoff / fs * m)
    h *= _window(window, ntaps)
    # normalize DC gain
    h *= gain / np.sum(h)
    return h.astype(np.float32)


def root_raised_cosine(gain: float, fs: float, sym_rate: float,
                       alpha: float, ntaps: int) -> np.ndarray:
    """GNURadio firdes.root_raised_cosine equivalent."""
    ntaps |= 1
    t = (np.arange(ntaps) - (ntaps - 1) / 2.0) / fs
    ts = 1.0 / sym_rate
    x = t / ts
    num = (np.sin(np.pi * x * (1 - alpha))
           + 4 * alpha * x * np.cos(np.pi * x * (1 + alpha)))
    den = np.pi * x * (1 - (4 * alpha * x) ** 2)
    h = np.empty(ntaps)
    reg = np.abs(den) > 1e-12
    h[reg] = num[reg] / den[reg]
    # singular points
    h[~reg & (np.abs(x) < 1e-9)] = 1.0 + alpha * (4 / np.pi - 1)
    edge = ~reg & (np.abs(np.abs(4 * alpha * x) - 1.0) < 1e-6)
    if edge.any():
        h[edge] = alpha / np.sqrt(2) * (
            (1 + 2 / np.pi) * np.sin(np.pi / (4 * alpha))
            + (1 - 2 / np.pi) * np.cos(np.pi / (4 * alpha)))
    h *= gain / np.sum(h)
    return h.astype(np.float32)
